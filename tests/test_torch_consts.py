"""Constants as scalar operands in the port's engine
(``mplan2vdl_tpu_torch/engine/lower.py``), on the CPU.

A ``RangeV`` (or ``RangeC``) of step 0 is a constant: it stays lazy, and a
``Binop``, a fold's group key or a non-fused fold's payload takes it as a
Python scalar; any other consumer writes it out (``_force``).  Each plan
here runs as the engine runs it and again under ``Forced``, which writes
every value out before its consumer sees it, so that no constant reaches a
consumer as a scalar; the two results must be equal bit for bit, names and
dtypes included.  The plans cover every ``Binop`` with the constant on the
left, on the right and on both sides, over int32 and int64 columns and
constants at the int32 edges, with and without a tail past ``valid``
(a group-by's output); division and modulo by a zero constant and shifts
by negative constants; and folds over a constant group key and of a
constant payload, dense and sparse.  Q1 and Q6 of ``h100bench/queries``
write no constant out and keep the oracle's rows; a plan whose constants
feed gathers and scatters (Q5) writes them out, one
``m2v_const.materialize`` span each when traced."""

import itertools
import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import torch_plans
from mplan2vdl_tpu_torch import mplan as M
from mplan2vdl_tpu_torch import tracing
from mplan2vdl_tpu_torch import vir as V
from mplan2vdl_tpu_torch.engine import datagen, lower
from mplan2vdl_tpu_torch.oracle import tpch

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
QUERIES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100bench", "queries")

OPS = [M.ADD, M.SUB, M.MUL, M.DIV, M.MOD, M.MIN, M.MAX, M.GT, M.LT, M.GEQ,
       M.LEQ, M.EQ, M.NEQ, M.LOGAND, M.LOGOR, M.BITAND, M.BITOR,
       M.BITSHIFT]
# constants of every op but the shift: the int32 edges, zero (a division
# or modulo by zero divides by one), -1 and a small one
KS = [I32_MIN, I32_MAX, 0, -1, 7]
# a shift's amounts (negative: left) and the values shifted by a column
SHIFTS = [-40, -3, 0, 3, 40]
SHIFTED = [I32_MIN, -1, 5, I32_MAX]


class Forced(lower.Compiler):
    """Every value written out before its consumer sees it: no constant
    reaches a consumer as a scalar."""

    def eval(self, v):
        return self._force(super().eval(v))


@pytest.fixture(scope="module")
def store():
    """A small TPC-H store with lineitem columns of chosen values: ``x32``
    (int32, both int32 edges, zeros), ``x64`` (int64 within 2^32, so a
    product with an int32 constant fits int64), ``s`` (values a shift
    moves), ``sh`` (shift amounts), ``g5`` (group ids 0, 2, 4 of a domain
    of 5: a group-by's output has a tail), ``g1000`` (ids of a sparse
    domain) and ``g3`` (0 to 3)."""
    st = datagen.generate(sf=0.001, seed=5)
    n = len(st.columns[("lineitem", "l_quantity")])
    rng = np.random.default_rng(5)
    x32 = rng.integers(I32_MIN, I32_MAX, n, endpoint=True)
    x32[:6] = [I32_MIN, I32_MAX, 0, -1, 1, 0]
    x64 = rng.integers(-(2**32 - 1), 2**32 - 1, n, endpoint=True)
    x64[:4] = [-(2**32 - 1), 2**32 - 1, 0, -1]
    cols = {"x32": x32, "x64": x64,
            "s": rng.integers(-1000, 1000, n, endpoint=True),
            "sh": rng.integers(-8, 8, n, endpoint=True),
            "g5": 2 * rng.integers(0, 2, n, endpoint=True),
            "g1000": rng.integers(0, 999, n, endpoint=True),
            "g3": rng.integers(0, 3, n, endpoint=True)}
    for c, x in cols.items():
        st.add("lineitem", c, x.astype(np.int64))
    return st, st.make_catalog()


def _col(cfg, name):
    return V.load_raw(cfg, ("lineitem", name))


def _fold(op, g, d, m=None):
    return V.complete(V.Fold(foldop=op, fgroups=g, fdata=d, fmask=m))


def _tailed(cfg, name):
    """``name``'s maximum per ``g5`` group: 5 slots, 3 of them valid (the
    count stays on the device)."""
    return _fold(V.FMAX, _col(cfg, "g5"), _col(cfg, name))


def _run(store, roots):
    """The plan's result as the engine computes it, held bit for bit to
    ``Forced``'s; the engine's query for its counters."""
    st, cfg = store
    cq = lower.CompiledQuery(cfg, roots, st, device="cpu")
    got = cq()
    scalar, written = cq.consts_scalar, cq.consts_materialized
    want = cq._fetch(Forced)
    assert got.names == want.names and got.dtypes == want.dtypes
    for g, w in zip(got.columns, want.columns, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    cq.consts_scalar, cq.consts_materialized = scalar, written
    return cq, got


@pytest.mark.parametrize("tail", [False, True], ids=["full", "tail"])
@pytest.mark.parametrize("side", ["left", "right", "both"])
@pytest.mark.parametrize("op", OPS)
def test_binop_constant_is_exact(store, op, side, tail):
    """``op`` with the constant on ``side``, over int32 and int64 columns
    and every constant above; with ``tail`` the column and the constant
    are a group-by's output, valid for 3 of its 5 slots."""
    st, cfg = store
    if op == M.BITSHIFT:  # a constant amount shifts ``s``; ``sh`` shifts one
        names, ks = (["sh"], SHIFTED) if side == "left" else (["s"], SHIFTS)
        pairs = list(itertools.product(SHIFTED, SHIFTS))
    else:
        names, ks = ["x32", "x64"], KS
        pairs = list(itertools.product(KS, KS))
    for name in names:
        col = _tailed(cfg, name) if tail else _col(cfg, name)
        n = 3 if tail else len(st.columns[("lineitem", name)])
        if side == "both":
            for ka, kb in pairs:
                node = V.binop(op, V.const_(ka, col), V.const_(kb, col))
                cq, got = _run(store, [node])
                # two scalars; the result, a constant, written out once
                assert (cq.consts_scalar, cq.consts_materialized) == (2, 1)
                assert len(got.columns[0]) == n
            continue
        for k in ks:
            c = V.const_(k, col)
            node = V.binop(op, c, col) if side == "left" else V.binop(
                op, col, c)
            cq, got = _run(store, [node])
            assert (cq.consts_scalar, cq.consts_materialized) == (1, 0)
            assert len(got.columns[0]) == n


def test_binop_of_constants_feeds_a_column(store):
    """A constant computed from two constants (``0 - 1``, as Q1's shift
    amount is) is itself a scalar operand: nothing is written out."""
    _, cfg = store
    s = _col(cfg, "s")
    node = V.binop(M.BITSHIFT, s, V.binop(M.SUB, V.const_(0, s),
                                         V.const_(1, s)))
    cq, got = _run(store, [node])
    assert (cq.consts_scalar, cq.consts_materialized) == (3, 0)
    want = store[0].columns[("lineitem", "s")].astype(np.int64) << 1
    np.testing.assert_array_equal(got.columns[0], want)


FOLDS = [V.FSUM, V.FMIN, V.FMAX, V.FCHOOSE]


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("key", [0, 3, 100])
@pytest.mark.parametrize("op", FOLDS)
def test_fold_over_a_constant_key(store, op, key, masked):
    """A constant group key: ids 0 and 3 are dense domains (no key buffer,
    the mask alone), 100 a sparse one (the key is written out).  Over
    int32 and int64 payloads, a full column and a group-by's output."""
    _, cfg = store
    for name, tail in itertools.product(["x32", "x64"], [False, True]):
        d = _tailed(cfg, name) if tail else _col(cfg, name)
        m = V.binop(M.GT, d, V.const_(0, d)) if masked else None
        cq, got = _run(store, [_fold(op, V.const_(key, d), d, m)])
        assert cq.consts_materialized == (key > 63)
        assert cq.consts_scalar == (key <= 63) + masked
        assert len(got.columns[0]) == 1


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("groups", ["g3", "g1000", "const"])
@pytest.mark.parametrize("op", FOLDS)
def test_fold_of_a_constant_payload(store, op, groups, masked):
    """A constant payload: ``c`` times each group's count, or ``c``, over
    a dense key (``g3``), a sparse one (``g1000``) and a constant one, on a
    full column and on a group-by's output (its ``g5`` key, or the
    constant key over it)."""
    _, cfg = store
    for k, tail in itertools.product(KS, [False, True]):
        if tail:  # the groups' maxima of the key, 3 of 5 slots valid
            ref = _tailed(cfg, "x32")
            g = V.const_(1, ref) if groups == "const" else _tailed(
                cfg, groups)
        else:
            ref = _col(cfg, "x32")
            g = V.const_(1, ref) if groups == "const" else _col(cfg, groups)
        m = V.binop(M.GT, ref, V.const_(0, ref)) if masked else None
        cq, got = _run(store, [_fold(op, g, V.const_(k, ref), m)])
        assert cq.consts_materialized == 0
        assert cq.consts_scalar == 1 + masked + (groups == "const")
        assert len(got.columns[0]) > 0


def _query(store, q, fused, monkeypatch):
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", fused)
    st, cfg = store
    with open(os.path.join(QUERIES, f"{q}.mplan")) as f:
        return lower.compile_plan_text(f.read(), cfg, st, device="cpu")


@pytest.fixture(scope="module")
def tpch_store():
    st = datagen.generate(sf=0.01, seed=7)
    return st, st.make_catalog()


def _rows(cols):
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("q", ["q1", "q6"])
def test_scan_queries_write_no_constant(tpch_store, q, fused, monkeypatch):
    """Every constant of Q1 and Q6 is a scalar operand, on every call, and
    the rows are the oracle's."""
    cq = _query(tpch_store, q, fused, monkeypatch)
    if q == "q1":
        want = tpch.q1(tpch_store[0])
        want = [want[k] for k in torch_plans.Q1_COLUMNS]
    else:
        want = [tpch.q6(tpch_store[0])["revenue"]]
    for _ in range(2):
        got = cq()
        assert cq.consts_materialized == 0 and cq.consts_scalar > 0
        assert _rows(got.columns) == _rows(want)


def test_constants_that_feed_gathers_are_written_out(tpch_store,
                                                     monkeypatch):
    """Q5's constant ones feed gathers and a scatter, which need their
    buffers: each is written out, a ``m2v_const.materialize`` span apiece
    when traced, and the rows are those of every constant forced and of
    the oracle."""
    cq = _query(tpch_store, "q5", "0", monkeypatch)
    plain = cq()
    written = cq.consts_materialized
    assert written >= 1
    assert _rows(plain.columns) == _rows(torch_plans.oracle_q5(tpch_store[0]))
    want = cq._fetch(Forced)
    for g, w in zip(plain.columns, want.columns, strict=True):
        np.testing.assert_array_equal(g, w)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = cq()
    spans = [r for r in tracing.records()
             if r.name == "m2v_const.materialize"]
    assert len(spans) == cq.consts_materialized == written
    for g, w in zip(traced.columns, plain.columns, strict=True):
        np.testing.assert_array_equal(g, w)
