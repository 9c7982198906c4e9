"""Which folds and group ids the expression-fold kernels compute, and their
programs.

A ``Fold`` of ``FSum``, ``FMin`` or ``FMax`` over a constant group key (one
group: Q6's sum) that no fused family takes can be computed in one pass over
its leaf columns: its mask and payload are row expressions.  ``plan`` turns
each such fold's two trees into one postfix program for
``kernels/exprfold.py`` (the mask first, then the payload), once per
compiled query; ``Compiler._eval_fold`` runs it when the fold's values allow
(``Compiler._eval_expr_fold``) and takes the node-by-node path otherwise.

A fused family (``engine/fuse.py``) whose group key is a ``Partition``
against a ``RangeC`` of step 1 (Q1's) gets its group ids the same way:
``plan_keys`` turns its mask and the ``Partition``'s data into one program
(the mask first, then the key), and the pivots become the kernel's bounds;
``Compiler._eval_fused`` runs it when the values allow
(``Compiler._fused_ids``) and evaluates the nodes otherwise.

The trees' interior nodes are ``Binop``s of OPS (a shift only by a
constant).  A constant (a ``RangeV`` or ``RangeC`` of step 0, or a ``Binop``
of two constants) is an immediate whose value the call reads; any other
node is a leaf column, read once however often the trees use it.  An
interior node is recomputed in registers even where other nodes use it too.
Plans that need more than MAX_LEAVES leaves, MAX_STEPS steps or a stack
deeper than MAX_DEPTH keep the node-by-node path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from .. import mplan as M
from .. import vir as V
from .kernels import segred
from .lower import _children, torch_dtype_for
from .kernels.exprfold import (ANDLRI, CMPS, IMM, LEAF, LRI, MAX_DEPTH,
                               MAX_LEAVES, MAX_STEPS, OPS, RI, RL, RR, RR_OPS,
                               Step, check_program)

# the engine's Binop ops the program computes, by the kernel's op name
OPS_OF = {M.ADD: "add", M.SUB: "sub", M.MUL: "mul", M.MIN: "min",
          M.MAX: "max", M.GT: "gt", M.LT: "lt", M.GEQ: "geq", M.LEQ: "leq",
          M.EQ: "eq", M.NEQ: "neq", M.LOGAND: "land", M.LOGOR: "lor",
          M.BITAND: "band", M.BITOR: "bor", M.BITSHIFT: "shift"}
# op(a, b) == MIRROR[op](b, a); sub and shift have none between two columns
MIRROR = {"add": "add", "mul": "mul", "min": "min", "max": "max",
          "gt": "lt", "lt": "gt", "geq": "leq", "leq": "geq", "eq": "eq",
          "neq": "neq", "land": "land", "lor": "lor", "band": "band",
          "bor": "bor", "sub": "rsub"}
FOLDS = {V.FSUM: "sum", V.FMIN: "min", V.FMAX: "max"}


@dataclass(frozen=True)
class Program:
    """A program over leaf columns that leaves a mask and then a value:
    ``leaves`` (the columns, LEAF + k reads ``leaves[k]``), ``program``,
    ``consts`` (per step, the constant node whose value is its immediate,
    or None), ``imms`` (per step, the immediate of a step with no constant
    node: 1 where a missing mask keeps every row, else 0) and ``shifts``
    (per step, whether its immediate is a shift amount)."""

    leaves: Tuple[V.Vexp, ...]
    program: Tuple[Step, ...]
    consts: Tuple[Optional[V.Vexp], ...]
    imms: Tuple[int, ...]
    shifts: Tuple[bool, ...]


@dataclass(frozen=True)
class ExprFold(Program):
    """One fold's program (its value the payload): ``foldop`` (of
    FOLD_OPS) and ``fold32`` (the fold's dtype is int32)."""

    foldop: str
    fold32: bool


@dataclass(frozen=True)
class GroupIds(Program):
    """A fused family's group-id program (its value the ``Partition``'s
    data): the pivots ``rmin``, ``rmin + 1``, ... (``rcount`` of them)."""

    rmin: int
    rcount: int


def is_constant(v: V.Vexp) -> bool:
    """A node the engine evaluates to a constant: a range of step 0, or a
    Binop of two constants (``Compiler._eval_binop`` folds it)."""
    vx = v.vx
    if isinstance(vx, (V.RangeV, V.RangeC)):
        return vx.rstep == 0
    if isinstance(vx, V.Binop):
        return is_constant(vx.left) and is_constant(vx.right)
    return False


def _interior(v: V.Vexp) -> bool:
    """A Binop the program computes: an op of OPS_OF, not a constant, a
    shift only by a constant."""
    vx = v.vx
    if not isinstance(vx, V.Binop) or vx.binop not in OPS_OF \
            or is_constant(v):
        return False
    return vx.binop != M.BITSHIFT or is_constant(vx.right)


class _TooLarge(Exception):
    pass


def _is_leaf(v: V.Vexp) -> bool:
    """A node the program reads as a column."""
    return not is_constant(v) and not _interior(v)


def _split(v: V.Vexp) -> Tuple[str, V.Vexp, Optional[V.Vexp]]:
    """An interior node as (op, column side, constant side or None): the
    op mirrored where the constant is on the left."""
    vx = v.vx
    op = OPS_OF[vx.binop]
    if is_constant(vx.right):
        return op, vx.left, vx.right
    if is_constant(vx.left):
        return MIRROR[op], vx.right, vx.left
    return op, vx.left, None


def _leaf_compare(v: V.Vexp) -> bool:
    """A compare of a leaf column with a constant (one ANDLRI step under
    a LogAnd)."""
    if not _interior(v):
        return False
    op, col, k = _split(v)
    return op in CMPS and k is not None and _is_leaf(col)


class _Emitter:
    """Postfix emission of one or more trees onto one stack.  Where a
    leaf meets a constant (``leaf op k``), a LogAnd meets such a compare,
    or an op meets a leaf, the pair is one step (LRI, ANDLRI, RL)."""

    def __init__(self) -> None:
        self.leaves: Dict[int, int] = {}
        self.leaf_nodes: List[V.Vexp] = []
        self.program: List[Step] = []
        self.consts: List[Optional[V.Vexp]] = []
        self.imms: List[int] = []
        self.shifts: List[bool] = []
        self.depth = 0
        self._need: Dict[int, int] = {}

    def need(self, v: V.Vexp) -> int:
        """Stack slots that evaluating ``v`` takes (Sethi and Ullman)."""
        hit = self._need.get(v.skey)
        if hit is not None:
            return hit
        if not _interior(v):
            out = 1
        else:
            op, a, k = _split(v)
            b = v.vx.right if a is v.vx.left else v.vx.left
            if k is not None:
                out = 1 if _is_leaf(a) else self.need(a)
            elif op == "land" and (_leaf_compare(b) or _leaf_compare(a)):
                out = self.need(a if _leaf_compare(b) else b)
            elif _is_leaf(b) or (_is_leaf(a) and MIRROR.get(op) in RR_OPS):
                out = self.need(a if _is_leaf(b) else b)
            else:
                na, nb = self.need(a), self.need(b)
                out = max(na, nb + 1)
                if MIRROR.get(op) in RR_OPS:
                    out = min(out, max(nb, na + 1))
        self._need[v.skey] = out
        return out

    def step(self, kind: int, push: int, narrow: bool = False,
             const: Optional[V.Vexp] = None, imm: int = 0,
             shift: bool = False) -> None:
        self.program.append(Step(kind, self.depth, narrow))
        self.consts.append(const)
        self.imms.append(imm)
        self.shifts.append(shift)
        self.depth += push
        if len(self.program) > MAX_STEPS or self.depth > MAX_DEPTH:
            raise _TooLarge

    def leaf(self, v: V.Vexp) -> int:
        """``v``'s leaf index, a new one on its first use."""
        k = self.leaves.get(v.skey)
        if k is None:
            if len(self.leaf_nodes) == MAX_LEAVES:
                raise _TooLarge
            k = self.leaves[v.skey] = len(self.leaf_nodes)
            self.leaf_nodes.append(v)
        return k

    def emit(self, v: V.Vexp) -> None:
        if is_constant(v):
            self.step(IMM, 1, const=v)
            return
        if not _interior(v):
            self.step(LEAF + self.leaf(v), 1)
            return
        narrow = torch_dtype_for(v.info) == torch.int32
        op, a, k = _split(v)
        b = v.vx.right if a is v.vx.left else v.vx.left
        if k is not None:  # op(a, constant)
            o = OPS.index(op)
            if _is_leaf(a):
                self.step(LRI + self.leaf(a) * len(OPS) + o, 1, narrow,
                          const=k, shift=op == "shift")
            else:
                self.emit(a)
                self.step(RI + o, 0, narrow, const=k, shift=op == "shift")
            return
        if op == "land" and (_leaf_compare(b) or _leaf_compare(a)):
            rest, cmp = (a, b) if _leaf_compare(b) else (b, a)
            cop, col, ck = _split(cmp)
            self.emit(rest)
            self.step(ANDLRI + self.leaf(col) * len(CMPS) + CMPS.index(cop),
                      0, const=ck)
            return
        if _is_leaf(b) or (_is_leaf(a) and MIRROR.get(op) in RR_OPS):
            rest, col = (a, b) if _is_leaf(b) else (b, a)
            if col is a:
                op = MIRROR[op]
            self.emit(rest)
            self.step(RL + self.leaf(col) * len(RR_OPS) + RR_OPS.index(op),
                      0, narrow)
            return
        mirror = MIRROR.get(op)
        if mirror in RR_OPS and self.need(b) > self.need(a):
            a, b, op = b, a, mirror
        self.emit(a)
        self.emit(b)
        self.step(RR + RR_OPS.index(op), -1, narrow)


def _program(mask: Optional[V.Vexp], value: V.Vexp) -> Optional[dict]:
    """The fields of a ``Program`` that leaves ``mask`` (1 where None) and
    then ``value``, or None where it is too large or reads no column (the
    node-by-node path reads none either)."""
    e = _Emitter()
    try:
        if mask is None:  # every row is kept
            e.step(IMM, 1, imm=1)
        else:
            e.emit(mask)
        e.emit(value)
    except _TooLarge:
        return None
    if not e.leaf_nodes:
        return None
    check_program(e.program, len(e.leaf_nodes))
    return dict(leaves=tuple(e.leaf_nodes), program=tuple(e.program),
                consts=tuple(e.consts), imms=tuple(e.imms),
                shifts=tuple(e.shifts))


def plan_fold(v: V.Vexp) -> Optional[ExprFold]:
    """The program of fold ``v`` where the kernel can compute it (see the
    module note), else None."""
    vx = v.vx
    if not isinstance(vx, V.Fold) or vx.foldop not in FOLDS \
            or not is_constant(vx.fgroups):
        return None
    gmin, gmax = vx.fgroups.info.bounds
    if gmin < 0 or gmax + 1 > segred.SMALL_DOMAIN:
        return None
    p = _program(vx.fmask, vx.fdata)
    if p is None:
        return None
    return ExprFold(**p, foldop=FOLDS[vx.foldop],
                    fold32=torch_dtype_for(v.info) == torch.int32)


def plan_group_ids(fgroups: V.Vexp,
                   fmask: Optional[V.Vexp]) -> Optional[GroupIds]:
    """The group-id program of a fused family with group key ``fgroups``
    and mask ``fmask``, where the key is a ``Partition`` against a
    ``RangeC`` of step 1 whose data is not a constant; else None."""
    vx = fgroups.vx
    if not isinstance(vx, V.Partition) or is_constant(vx.pdata):
        return None
    piv = vx.pivots.vx
    if not isinstance(piv, V.RangeC) or piv.rstep != 1 \
            or not 1 <= piv.rcount <= 2**31:
        return None
    p = _program(fmask, vx.pdata)
    if p is None:
        return None
    return GroupIds(**p, rmin=piv.rmin, rcount=piv.rcount)


def plan_keys(families: list) -> Dict[int, GroupIds]:
    """The group-id program of each fused family (``fuse.Family``) that
    has one, by the family's index."""
    out = {}
    for i, fam in enumerate(families):
        p = plan_group_ids(fam.fgroups, fam.fmask)
        if p is not None:
            out[i] = p
    return out


def plan(vexps: List[V.Vexp], fold_map: dict) -> Dict[int, ExprFold]:
    """Each fold of the DAG that the kernel computes, by structural key;
    the folds ``fold_map`` routes to a fused family keep that path."""
    out: Dict[int, ExprFold] = {}
    seen = set()
    todo = list(vexps)
    while todo:
        v = todo.pop()
        if v.skey in seen:
            continue
        seen.add(v.skey)
        if v.skey not in fold_map:
            p = plan_fold(v)
            if p is not None:
                out[v.skey] = p
        todo.extend(_children(v.vx))
        if v.lineage is not None:
            todo.append(v.lineage.mask)
    return out
