"""Expression fold: a one-group fold's mask and payload, computed from their
leaf columns in one pass; and a fused family's group ids, the same way.

The engine plans such a fold once per compiled query (``engine/exprfold.py``):
its mask tree and its payload tree become one postfix ``program`` of
``Step``s over the fold's leaf columns, which leaves the mask and then the
payload on a stack.  ``expr_fold`` runs it over every row and returns the
fold's value over the rows whose mask is nonzero, with their count.
``group_ids`` runs a program that leaves a fused family's mask and group
key instead, and writes each row's int32 group id: the key less the
``Partition``'s lowest pivot, clamped to its pivots, or -1 where the mask
is zero.

On CUDA tensors both launch the hand-written kernels in ``csrc/exprfold.cu``
(one pass, the trees evaluated in registers; see the note there); on CPU
tensors they run ``expr_fold_plain`` and ``group_ids_plain``, the same
program as torch ops.  They replace no TPU kernel: XLA fused these trees on
the TPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ... import tracing
from . import _lib

# csrc/exprfold.cu's kMaxLeaves, kMaxSteps, kMaxDepth
MAX_LEAVES = 8
MAX_STEPS = 32
MAX_DEPTH = 8

OPS = ("add", "sub", "mul", "min", "max", "gt", "lt", "geq", "leq", "eq",
       "neq", "land", "lor", "band", "bor", "rsub", "shift")
# ops with a second operand from the stack or a leaf; rsub (immediate -
# top) and shift (by the immediate, in [-63, 63], a negative amount
# shifting left) take an immediate only
RR_OPS = OPS[:OPS.index("bor") + 1]
CMPS = ("gt", "lt", "geq", "leq", "eq", "neq")
BOOL_OPS = CMPS + ("land", "lor")
# step kinds (csrc/exprfold.cu's): push leaf k (LEAF + k); push the
# immediate (IMM); pop the top two and push op(second, top) (RR + op);
# replace the top by op(top, immediate) (RI + op); push op(leaf k,
# immediate) (LRI + k * len(OPS) + op); replace the top by
# ``top != 0 and cmp(leaf k, immediate)`` (ANDLRI + k * len(CMPS) + cmp);
# replace the top by op(top, leaf k) (RL + k * len(RR_OPS) + op)
LEAF, IMM, RR, RI, LRI, ANDLRI, RL = 0, 8, 16, 32, 64, 200, 248
FOLD_OPS = ("sum", "min", "max")
DTYPES = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
          torch.int64: 4}

# kernel launches made by expr_fold and by group_ids (callers reset them
# to count a run)
launches = 0
group_launches = 0


@dataclass(frozen=True)
class Step:
    """One program step: its ``kind``, the stack ``depth`` before it, and
    whether its result is narrowed to int32 (its node's dtype)."""

    kind: int
    depth: int
    narrow: bool = False

    @property
    def code(self) -> int:
        """The word the kernel reads: kind | depth << 10 | narrow << 16."""
        return self.kind | self.depth << 10 | int(self.narrow) << 16


def decode(kind: int):
    """(form, op, leaf) of a step kind: form one of "leaf", "imm", "rr",
    "ri", "lri", "andlri", "rl"; op the op's name (None for a push);
    leaf the leaf's index (None where the step reads none)."""
    if kind < IMM:
        return "leaf", None, kind - LEAF
    if kind == IMM:
        return "imm", None, None
    if RR <= kind < RR + len(RR_OPS):
        return "rr", RR_OPS[kind - RR], None
    if RI <= kind < RI + len(OPS):
        return "ri", OPS[kind - RI], None
    if LRI <= kind < LRI + MAX_LEAVES * len(OPS):
        k, op = divmod(kind - LRI, len(OPS))
        return "lri", OPS[op], k
    if ANDLRI <= kind < ANDLRI + MAX_LEAVES * len(CMPS):
        k, op = divmod(kind - ANDLRI, len(CMPS))
        return "andlri", CMPS[op], k
    if RL <= kind < RL + MAX_LEAVES * len(RR_OPS):
        k, op = divmod(kind - RL, len(RR_OPS))
        return "rl", RR_OPS[op], k
    raise ValueError(f"no step kind {kind}")


# each form's (least stack depth it finds, how it moves the depth)
MOVES = {"leaf": (0, 1), "imm": (0, 1), "lri": (0, 1), "rr": (2, -1),
         "ri": (1, 0), "andlri": (1, 0), "rl": (1, 0)}


def check_program(program: Sequence[Step], n_leaves: int) -> int:
    """The program's deepest stack; raises unless every step finds the
    depth it names and the program leaves two values (mask, then payload
    or group key)."""
    depth = most = 0
    for s in program:
        form, _, leaf = decode(s.kind)
        least, move = MOVES[form]
        if s.depth != depth or depth < least:
            raise ValueError(f"step {s} at depth {depth}")
        if leaf is not None and leaf >= n_leaves:
            raise ValueError(f"step {s} reads leaf {leaf} of {n_leaves}")
        depth += move
        most = max(most, depth)
    if depth != 2 or most > MAX_DEPTH or len(program) > MAX_STEPS:
        raise ValueError(f"program of {len(program)} steps leaves {depth} "
                         f"values, {most} deep")
    return most


def _apply(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``op`` over int64 ``a`` and ``b`` as csrc/exprfold.cu's ``apply``
    computes it (wrapping, 0 or 1 for a compare)."""
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "rsub":
        return b - a
    if op == "mul":
        return a * b
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    if op == "band":
        return a & b
    if op == "bor":
        return a | b
    if op == "shift":
        k = int(b)
        return a << -k if k < 0 else a >> k
    if op == "land":
        out = (a != 0) & (b != 0)
    elif op == "lor":
        out = (a != 0) | (b != 0)
    else:
        out = {"gt": torch.gt, "lt": torch.lt, "geq": torch.ge,
               "leq": torch.le, "eq": torch.eq, "neq": torch.ne}[op](a, b)
    return out.to(torch.int64)


def run_plain(leaves: Sequence[torch.Tensor], program: Sequence[Step],
              imms: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The program over whole int64 columns: the two values it leaves
    (mask, then payload or key), int64, as csrc/exprfold.cu computes them."""
    check_program(program, len(leaves))
    n = leaves[0].shape[0]
    cols = [t.to(torch.int64) for t in leaves]
    stack = []
    for s, k in zip(program, imms, strict=True):
        k = torch.tensor(k, dtype=torch.int64, device=leaves[0].device)
        form, op, leaf = decode(s.kind)
        if form == "leaf":
            stack.append(cols[leaf])
            continue
        if form == "imm":
            stack.append(k.expand(n))
            continue
        a, b = {"rr": lambda: (stack.pop(-2), stack.pop()),
                "ri": lambda: (stack.pop(), k),
                "lri": lambda: (cols[leaf], k),
                "andlri": lambda: (cols[leaf], k),
                "rl": lambda: (stack.pop(), cols[leaf])}[form]()
        v = _apply(op, a, b)
        if form == "andlri":
            v = ((stack.pop() != 0) & (v != 0)).to(torch.int64)
        elif s.narrow and op not in BOOL_OPS:
            v = v.to(torch.int32).to(torch.int64)
        stack.append(v)
    mask, top = stack
    return mask, top


def expr_fold_plain(leaves: Sequence[torch.Tensor], program: Sequence[Step],
                    imms: Sequence[int], foldop: str,
                    fold32: bool) -> torch.Tensor:
    """Plain PyTorch version: the program over whole int64 columns, then
    the fold over the rows whose mask is nonzero."""
    mask, pay = run_plain(leaves, program, imms)
    if fold32:
        pay = pay.to(torch.int32).to(torch.int64)
    ok = mask != 0
    info = torch.iinfo(torch.int64)
    ident = {"sum": 0, "min": info.max, "max": info.min}[foldop]
    x = torch.where(ok, pay, ident)
    if foldop == "sum":
        val = x.sum()
    else:
        x = torch.cat([x, x.new_full((1,), ident)])
        val = x.min() if foldop == "min" else x.max()
    return torch.stack([val, ok.sum()])


def group_ids_plain(leaves: Sequence[torch.Tensor], program: Sequence[Step],
                    imms: Sequence[int], rmin: int,
                    rcount: int) -> torch.Tensor:
    """Plain PyTorch version: the program over whole int64 columns, then
    ``clamp(key - rmin, 0, rcount - 1)`` (int64, wrapping) where the mask
    is nonzero and -1 elsewhere, as int32."""
    mask, key = run_plain(leaves, program, imms)
    ids = torch.clamp(key - rmin, 0, rcount - 1)
    return torch.where(mask != 0, ids, -1).to(torch.int32)


def _columns(leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``leaves`` as a list, checked: 1 to MAX_LEAVES 1-D columns of one
    length and device, each of a dtype in DTYPES."""
    leaves = list(leaves)
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"{len(leaves)} leaves, at most {MAX_LEAVES}")
    n = leaves[0].shape[0]
    dev = leaves[0].device
    for t in leaves:
        if t.dim() != 1 or t.shape[0] != n or t.dtype not in DTYPES:
            raise TypeError("leaves must be 1-D integer or bool columns of "
                            "one length")
        if t.device != dev:
            raise ValueError("leaves on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return leaves


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels load it: contiguous, 16-byte aligned (they
    load vectors of rows)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _program_args(leaves: List[torch.Tensor], program: Sequence[Step],
                  imms: Sequence[int]) -> tuple:
    """The C entry points' first arguments: the leaves' pointers and
    dtypes, their count and rows, the program's words, immediates and
    length.  The caller keeps ``leaves`` alive over the launch."""
    return (_lib.ptrs(leaves), _lib.ints([DTYPES[t.dtype] for t in leaves]),
            len(leaves), leaves[0].shape[0],
            _lib.ints([s.code for s in program]),
            (ctypes.c_longlong * len(imms))(*imms), len(program))


@tracing.kernel
def expr_fold(leaves: Sequence[torch.Tensor], program: Sequence[Step],
              imms: Sequence[int], foldop: str, fold32: bool) -> torch.Tensor:
    """int64 [2] on the leaves' device: the fold (``foldop``, one of
    FOLD_OPS) of the payload over the rows whose mask is nonzero (the
    identity where there is none: 0, the int64 maximum for min, its minimum
    for max), and their count.  ``leaves``: 1-D columns of one length in
    DTYPES; ``imms``: one int64 immediate per step (0 where the step takes
    none); ``fold32``: the payload is narrowed to int32."""
    global launches
    leaves = _columns(leaves)
    if len(imms) != len(program) or foldop not in FOLD_OPS:
        raise ValueError("one immediate a step, and a fold op of FOLD_OPS")
    if leaves[0].device.type == "cpu":
        return expr_fold_plain(leaves, program, imms, foldop, fold32)
    leaves = [_ready(t) for t in leaves]
    out = torch.empty(3, dtype=torch.int64, device=leaves[0].device)
    rc = _lib.call("m2v_expr_fold", *_program_args(leaves, program, imms),
                   FOLD_OPS.index(foldop), int(fold32), out.data_ptr(),
                   _lib.stream(leaves[0]))
    _lib.check(rc, "expr_fold")
    launches += 1
    return out[:2]


@tracing.kernel
def group_ids(leaves: Sequence[torch.Tensor], program: Sequence[Step],
              imms: Sequence[int], rmin: int, rcount: int) -> torch.Tensor:
    """int32 [n] on the leaves' device: for each row, where the program's
    mask is nonzero, its key less ``rmin`` clamped into [0, rcount - 1]
    (computed in int64), else -1.  ``leaves``, ``program`` and ``imms`` as
    ``expr_fold`` takes them; the program leaves the mask, then the key."""
    global group_launches
    leaves = _columns(leaves)
    if len(imms) != len(program) or not 1 <= rcount <= 2**31:
        raise ValueError("one immediate a step, and 1 to 2^31 pivots")
    if leaves[0].device.type == "cpu":
        return group_ids_plain(leaves, program, imms, rmin, rcount)
    leaves = [_ready(t) for t in leaves]
    out = torch.empty(leaves[0].shape[0], dtype=torch.int32,
                      device=leaves[0].device)
    rc = _lib.call("m2v_group_ids", *_program_args(leaves, program, imms),
                   rmin, rcount, out.data_ptr(), _lib.stream(leaves[0]))
    _lib.check(rc, "group_ids")
    group_launches += 1
    return out
