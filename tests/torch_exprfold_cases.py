"""Random one-group folds for the expression-fold kernel, and random group
keys for the group-id kernel, shared by tests/test_torch_exprfold.py and
tests/test_torch_groupids.py (on the CPU, the port against its node path
and the JAX engine) and chip_smoke.py (on the card, the kernels against
their plain versions).  Imports neither JAX nor the JAX package: a tree is
drawn once as a spec of nested tuples and built in either package's VIR.

A spec is ``("col", name)`` (a leaf column of LEAVES), ``("k", value)`` (a
constant), ``("div",)`` (``a32 / a8``: a node outside the program's ops,
read as a leaf column) or ``(op, a, b)`` with ``op`` a Binop of OPS.
"""

from __future__ import annotations

import dataclasses

import numpy as np

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
# the leaf columns ``add_leaves`` gives lineitem: name -> numpy dtype
LEAVES = {"a8": np.int8, "a16": np.int16, "a32": np.int32, "a64": np.int64,
          "b": np.bool_}
# the Binops of the program (mplan's names, the same in both packages)
OPS = ["Add", "Sub", "Mul", "Min", "Max", "Gt", "Lt", "Geq", "Leq", "Eq",
       "Neq", "LogAnd", "LogOr", "BitAnd", "BitOr", "BitShift"]
KS = [I32_MIN, I32_MAX, -1, -7, 0, 3, 100, -(2**40)]
SHIFTS = [-70, -40, -3, 0, 3, 31, 40, 70]
FOLDS = ["sum", "min", "max"]
# a group key's Partition pivots (rmin, rcount), in turn
PIVOTS = [(0, 8), (-3, 16), (5, 1), (-(2**40), 2), (2**33, 16),
          (I32_MIN, 4)]
# (key, rmin, rcount) whose ids spread over the pivots, before the random
# keys: Q1's shape, a narrow leaf, a masked leaf, a shifted bool, and a
# 32-bit key three stack slots deep (over a mask: the kernel for deeper
# 32-bit programs, which no random key reaches)
FIXED_KEYS = [
    (("BitOr", ("BitShift", ("Max", ("col", "a8"), ("k", 0)), ("k", -1)),
      ("col", "b")), 0, 8),
    (("col", "a8"), -3, 16),
    (("BitAnd", ("col", "a16"), ("k", 7)), 2, 4),
    (("Add", ("BitShift", ("col", "b"), ("k", -2)), ("col", "a8")), -1, 8),
    (("Sub",
      ("Max", ("Add", ("col", "a8"), ("col", "a16")),
       ("Sub", ("col", "a16"), ("col", "a8"))),
      ("Min", ("Add", ("col", "a16"), ("col", "b")),
       ("Sub", ("col", "a8"), ("col", "b")))), -8, 16)]
# the fixed keys' mask: 32 bits, so that their programs are
FIXED_MASK = ("Neq", ("col", "a8"), ("k", 3))
KEY_CASES = 36


def add_leaves(st, seed: int) -> None:
    """Gives ``st``'s lineitem a column of each leaf dtype: ``a8`` and
    ``a16`` over their whole ranges, ``a32`` with both int32 edges, ``a64``
    within 2^40, ``b`` bool."""
    n = len(st.columns[("lineitem", "l_quantity")])
    rng = np.random.default_rng(seed)
    cols = {"a8": rng.integers(-128, 127, n, endpoint=True),
            "a16": rng.integers(-(2**15), 2**15 - 1, n, endpoint=True),
            "a32": rng.integers(I32_MIN, I32_MAX, n, endpoint=True),
            "a64": rng.integers(-(2**40), 2**40, n, endpoint=True),
            "b": rng.random(n) < 0.5}
    cols["a32"][:4] = [I32_MIN, I32_MAX, 0, -1]
    for c, x in cols.items():
        st.add("lineitem", c, x.astype(LEAVES[c]))


def draw(rng, depth: int):
    """A random spec up to ``depth`` Binops deep."""
    if depth == 0 or rng.random() < 0.25:
        r = rng.random()
        if r < 0.2:
            return ("k", int(rng.choice(KS)))
        if r < 0.27:
            return ("div",)
        return ("col", str(rng.choice(list(LEAVES))))
    op = OPS[rng.integers(len(OPS))]
    a = draw(rng, depth - 1)
    if op == "BitShift":
        return (op, a, ("k", int(rng.choice(SHIFTS))))
    b = draw(rng, depth - 1)
    if rng.random() < 0.3:  # a constant on either side
        b = ("k", int(rng.choice(KS)))
        if rng.random() < 0.5:
            a, b = b, a
    return (op, a, b)


def key_case(i: int):
    """Group-id case ``i``: (mask spec or None, key spec, rmin, rcount),
    FIXED_KEYS under FIXED_MASK first, then random keys (never a
    constant) and masks drawn from ``i`` over PIVOTS in turn; every sixth
    case has no mask."""
    rng = np.random.default_rng(1000 + i)
    if i < len(FIXED_KEYS):
        return (FIXED_MASK,) + FIXED_KEYS[i]
    mask = None if i % 6 == 5 else draw(rng, 2)
    key = draw(rng, 3)
    while is_constant(key):
        key = draw(rng, 3)
    return (mask, key) + PIVOTS[i % len(PIVOTS)]


def is_constant(spec) -> bool:
    return spec[0] == "k" or (spec[0] in OPS and is_constant(spec[1])
                              and is_constant(spec[2]))


class Builder:
    """Builds specs in one package's VIR (``V``, ``M``) over ``cfg``.  With
    ``wrap``, every ``Mul`` is declared int32 whatever its operands, so that
    its products wrap when narrowed, as the engine's ``.to(dt)`` narrows
    them."""

    def __init__(self, V, M, cfg, wrap: bool = False):
        self.V, self.M, self.cfg, self.wrap = V, M, cfg, wrap

    def col(self, name):
        return self.V.load_raw(self.cfg, ("lineitem", name))

    def const(self, k):
        return self.V.const_(int(k), self.col("a32"))

    def binop(self, op, a, b):
        v = self.V.binop(op, a, b)
        if self.wrap and op == self.M.MUL:
            v = v.with_(info=dataclasses.replace(v.info,
                                                 bounds=(I32_MIN, I32_MAX)))
        return v

    def build(self, spec):
        if spec[0] == "col":
            return self.col(spec[1])
        if spec[0] == "k":
            return self.const(spec[1])
        if spec[0] == "div":
            return self.V.binop(self.M.DIV, self.col("a32"), self.col("a8"))
        return self.binop(spec[0], self.build(spec[1]), self.build(spec[2]))

    def partition(self, key, rmin: int, rcount: int):
        """``Partition`` of the built key against the pivots rmin, rmin + 1,
        ... (``rcount`` of them), the engine's dense group ids."""
        V = self.V
        return V.complete(V.Partition(
            pivots=V.complete(V.RangeC(rmin=rmin, rstep=1, rcount=rcount)),
            pdata=self.build(key)))

    def fold(self, op: str, data, mask=None):
        """A fold (``op`` of FOLDS) over a constant key, the specs built."""
        V = self.V
        foldop = {"sum": V.FSUM, "min": V.FMIN, "max": V.FMAX}[op]
        return V.complete(V.Fold(
            foldop=foldop, fgroups=V.const_(0, self.col("a32")),
            fdata=self.build(data),
            fmask=None if mask is None else self.build(mask)))


def card_plans(cfg, V, M, plan_fold, seed: int = 1, count: int = 30):
    """(name, one-pass plan) of ``count`` random folds whose constants are
    ranges (their values read from the plan here), FOLDS in turn, every
    other one with its products wrapping."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        op = FOLDS[i % len(FOLDS)]
        b = Builder(V, M, cfg, wrap=i % 2 == 1)
        while True:
            p = plan_fold(b.fold(op, draw(rng, 3), draw(rng, 3)))
            if p is not None and all(isinstance(c.vx, V.RangeV)
                                     for c in p.consts if c is not None):
                break
        out.append((f"random{i}-{op}", p))
    return out


def key_plans(cfg, V, M, plan_group_ids):
    """(name, group-id plan) of each of the KEY_CASES cases that plans
    with constants that are ranges (``immediates`` reads their values from
    the plan)."""
    out = []
    for i in range(KEY_CASES):
        mask, key, rmin, rcount = key_case(i)
        b = Builder(V, M, cfg, wrap=i % 2 == 1)
        p = plan_group_ids(b.partition(key, rmin, rcount),
                           None if mask is None else b.build(mask))
        if p is not None and all(isinstance(c.vx, V.RangeV)
                                 for c in p.consts if c is not None):
            out.append((f"key{i}", p))
    return out


def immediates(plan):
    """A plan's immediates, as ``Compiler._eval_expr_fold`` passes them
    (a shift by 63 or more moves as far as one by 63)."""
    imms = [c.vx.rmin if c is not None else k
            for c, k in zip(plan.consts, plan.imms)]
    return [max(-63, min(k, 63)) if s else k
            for k, s in zip(imms, plan.shifts)]


def leaf_data(torch, plan, n: int, dev, seed: int):
    """Random columns of the plan's leaf dtypes over their whole ranges
    (a ``Div`` leaf as int32), ``n`` rows on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dts = {np.int8: torch.int8, np.int16: torch.int16, np.int32: torch.int32,
           np.int64: torch.int64, np.bool_: torch.bool}
    out = []
    for v in plan.leaves:
        name = v.vx.name[1] if type(v.vx).__name__ == "Load" else "a32"
        dt = dts[LEAVES.get(name, np.int32)]
        if dt == torch.bool:
            out.append(torch.rand(n, generator=g, device=dev) < 0.5)
            continue
        info = torch.iinfo(dt)
        out.append(torch.randint(info.min, info.max, (n,), generator=g,
                                 device=dev, dtype=dt))
    return out
