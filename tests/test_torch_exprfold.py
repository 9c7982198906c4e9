"""The one-pass expression fold (``engine/exprfold.py``,
``engine/kernels/exprfold.py``), on the CPU.

Random mask and payload trees (``tests/torch_exprfold_cases.py``) over the
program's ops, on leaf columns of every dtype it reads (int8 to int64 and
bool), with negative constants, constants on either side, shifts by
positive and negative amounts past the width, and products that wrap where
their node is int32, under ``FSum``, ``FMin`` and ``FMax`` and an all-false
mask.  Each fold runs three ways on the same columns: through the port with
its one-pass plans (on the CPU the plain expression fold), through the port
with none (each node evaluated by ``_eval_fold``'s usual path), and through
the JAX engine; the three results must be equal row for row, dtypes
included.  Q6 and Q1 of ``h100bench/queries`` keep the oracles' rows, Q6's
sum taking the one-pass path on every call and Q1 none, and each plan of
the benchmark's mixes takes it as often as ``ENGAGED`` says.  The CUDA
kernel runs only on the card, where chip_smoke.py holds it against the
plain version.
"""

import os

import numpy as np
import pytest

import torch_exprfold_cases as cases
import torch_plans
from mplan2vdl_tpu import mplan as JM
from mplan2vdl_tpu import vir as JV
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu_torch import mplan as M
from mplan2vdl_tpu_torch import vir as V
from mplan2vdl_tpu_torch.engine import datagen, exprfold, lower
from mplan2vdl_tpu_torch.engine.kernels import exprfold as kexpr
from mplan2vdl_tpu_torch.oracle import tpch

QUERIES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100bench", "queries")
SHIFTS = cases.SHIFTS


@pytest.fixture(scope="module")
def store():
    """A small TPC-H store of each package whose lineitem has a column of
    each leaf dtype (``cases.add_leaves``, the same values in both)."""
    out = []
    for gen in (datagen, jdatagen):
        st = gen.generate(sf=0.001, seed=5)
        cases.add_leaves(st, 5)
        out += [st, st.make_catalog()]
    for c in cases.LEAVES:
        np.testing.assert_array_equal(out[0].columns[("lineitem", c)],
                                      out[2].columns[("lineitem", c)])
    return tuple(out)


def _builder(store, wrap=False):
    return cases.Builder(V, M, store[1], wrap)


def _same(got, want):
    """Equal names, types (by repr: each package has its own type
    classes), numpy dtypes and values, row for row."""
    assert got.names == want.names
    assert [repr(t) for t in got.dtypes] == [repr(t) for t in want.dtypes]
    assert len(got.columns) == len(want.columns)
    for g, w in zip(got.columns, want.columns, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _three(store, op, data, mask=None, wrap=False):
    """The fold of specs ``data`` and ``mask`` through the port with its
    one-pass plans, with none, and through the JAX engine: all equal.
    The port's query (for its plans and counters, those of the first
    call) and its result."""
    st, cfg, jst, jcfg = store
    root = cases.Builder(V, M, cfg, wrap).fold(op, data, mask)
    cq = lower.CompiledQuery(cfg, [root], st, device="cpu")
    got = cq()
    folds = cq.expr_folds
    plans, cq.expr_plans = cq.expr_plans, {}
    want = cq()
    assert cq.expr_folds == 0
    _same(got, want)
    jroot = cases.Builder(JV, JM, jcfg, wrap).fold(op, data, mask)
    _same(got, jlower.CompiledQuery(jcfg, [jroot], jst)())
    cq.expr_plans, cq.expr_folds = plans, folds
    return cq, root, got


def _fold(op, ref, data, mask=None):
    return V.complete(V.Fold(foldop=op, fgroups=V.const_(0, ref),
                             fdata=data, fmask=mask))


FOLDS = [V.FSUM, V.FMIN, V.FMAX]
# each fold op under its name in ``cases``
OP = {V.FSUM: "sum", V.FMIN: "min", V.FMAX: "max"}


@pytest.mark.parametrize("wrap", [False, True], ids=["exact", "wrap"])
@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("op", FOLDS)
def test_random_trees_match_the_node_path(store, op, seed, wrap):
    """Four random (mask, payload) pairs of trees up to 3 deep a case,
    against the node path and the JAX engine."""
    rng = np.random.default_rng(seed * 2 + wrap)
    for _ in range(4):
        mask, pay = cases.draw(rng, 3), cases.draw(rng, 3)
        if cases.is_constant(pay) and cases.is_constant(mask):
            continue  # no column to read: not planned
        cq, root, _ = _three(store, OP[op], pay, mask, wrap)
        assert list(cq.expr_plans) == [root.skey]
        assert cq.expr_folds == 1


@pytest.mark.parametrize("op", FOLDS)
@pytest.mark.parametrize("leaf", list(cases.LEAVES))
def test_each_leaf_dtype_without_a_mask(store, op, leaf):
    """A fold of one column of each dtype, every row kept."""
    cq, _, got = _three(store, OP[op], ("col", leaf))
    assert cq.expr_folds == 1 and len(got.columns[0]) == 1


@pytest.mark.parametrize("op", FOLDS)
def test_all_false_mask_gives_no_row(store, op):
    """No row passes ``a8 > 200``: no group is occupied, as on the node
    path and in the JAX engine."""
    mask = ("Gt", ("col", "a8"), ("k", 200))
    cq, _, got = _three(store, OP[op], ("col", "a64"), mask)
    assert cq.expr_folds == 1 and len(got.columns[0]) == 0


def test_shift_amounts_and_wrapping_products(store):
    """Shifts by every amount of SHIFTS (negative: left), and a product of
    two int32 columns declared int32, under a mask on both."""
    for k in SHIFTS:
        pay = ("Mul", ("BitShift", ("col", "a32"), ("k", k)), ("col", "a32"))
        mask = ("Neq", ("BitShift", ("col", "a16"), ("k", -k)), ("k", 0))
        cq, _, _ = _three(store, "sum", pay, mask, wrap=True)
        assert cq.expr_folds == 1


def test_program_shape(store):
    """A leaf used twice is read once; a leaf meeting a constant, a LogAnd
    meeting such a compare and an op meeting a leaf are one step each; a
    constant on the left of a compare mirrors it; a subtraction of two
    expressions takes both off the stack."""
    t = _builder(store)
    a, b = t.col("a32"), t.col("a16")
    mask = V.binop(M.LOGAND, V.binop(M.LT, t.const(5), a),
                   V.binop(M.ADD, b, V.binop(M.MUL, a, b)))
    pay = V.binop(M.SUB, V.binop(M.ADD, a, b), V.binop(M.MUL, b, t.const(3)))
    p = exprfold.plan_fold(_fold(V.FSUM, a, pay, mask))
    assert [x.skey for x in p.leaves] == [a.skey, b.skey]
    assert [kexpr.decode(s.kind) + (s.depth,) for s in p.program] == [
        ("leaf", None, 0, 0), ("rl", "mul", 1, 1), ("rl", "add", 1, 1),
        ("andlri", "gt", 0, 1), ("leaf", None, 0, 1), ("rl", "add", 1, 2),
        ("lri", "mul", 1, 2), ("rr", "sub", None, 3)]
    assert p.consts[3].vx.rmin == 5 and p.consts[6].vx.rmin == 3
    assert kexpr.check_program(p.program, len(p.leaves)) == 3


def test_what_is_not_planned(store):
    """A key that is not constant, a fused family's fold, a count(DISTINCT)
    and a program past MAX_LEAVES keep the node path."""
    t = _builder(store)
    a = t.col("a32")
    assert exprfold.plan_fold(V.complete(V.Fold(
        foldop=V.FSUM, fgroups=t.col("a8"), fdata=a))) is None
    assert exprfold.plan_fold(_fold(V.FDISTINCT, a, a)) is None
    wide = a
    for i in range(kexpr.MAX_LEAVES):
        wide = V.binop(M.ADD, wide, V.binop(M.DIV, a, t.const(i + 2)))
    assert exprfold.plan_fold(_fold(V.FSUM, a, wide)) is None
    root = _fold(V.FSUM, a, a)
    assert exprfold.plan([root], {root.skey: (0, 0)}) == {}


def _query(store, q, fused, monkeypatch):
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", fused)
    st, cfg = store
    with open(os.path.join(QUERIES, f"{q}.mplan")) as f:
        return lower.compile_plan_text(f.read(), cfg, st, device="cpu")


@pytest.fixture(scope="module")
def tpch_store():
    st = datagen.generate(sf=0.02, seed=11)
    return st, st.make_catalog()


def _rows(cols):
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("q", ["q1", "q6"])
def test_scan_queries(tpch_store, q, fused, monkeypatch):
    """Q6's sum takes the one-pass path on every call (one fold), Q1 none,
    fused or not; the rows are the oracles'."""
    cq = _query(tpch_store, q, fused, monkeypatch)
    if q == "q1":
        want = tpch.q1(tpch_store[0])
        want = [want[k] for k in torch_plans.Q1_COLUMNS]
    else:
        want = [tpch.q6(tpch_store[0])["revenue"]]
    for _ in range(2):
        got = cq()
        assert cq.expr_folds == (q == "q6")
        assert cq.consts_materialized == 0
        assert _rows(got.columns) == _rows(want)


# the benchmark's plans (``h100bench/queries``, both mixes): (folds
# planned for one pass, folds that took it on a call).  Q17's final sum is
# planned, but one of its leaf columns comes out of the join with its count
# on the device, not the host, so it keeps the node path.
ENGAGED = {"q1": (0, 0), "q6": (1, 1), "q3": (0, 0), "q5": (0, 0),
           "q9": (0, 0), "q13": (0, 0), "q17": (1, 0)}


@pytest.mark.parametrize("q", sorted(ENGAGED))
def test_benchmark_plans_engage(tpch_store, q, monkeypatch):
    """Which folds of the benchmark's plans are planned for one pass, and
    which take it (unfused, as the default gate leaves this store)."""
    cq = _query(tpch_store, q, "0", monkeypatch)
    cq()
    assert (len(cq.expr_plans), cq.expr_folds) == ENGAGED[q]


def test_traced_call_charges_the_leaves(tpch_store, monkeypatch):
    """Traced, Q6's fold is charged the four columns it reads, and its
    kernel call is a span ``m2v_kernel.expr_fold``."""
    from torch.profiler import ProfilerActivity, profile

    from mplan2vdl_tpu_torch import tracing

    cq = _query(tpch_store, "q6", "0", monkeypatch)
    n = len(tpch_store[0].columns[("lineitem", "l_quantity")])
    rep = cq.cost_report(per_op=True)
    assert rep["per_op"]["by_kind"]["Fold FSum"] >= 4 * 4 * n
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        cq()
    names = [r.name for r in tracing.records()]
    assert names.count("m2v_kernel.expr_fold") == 1
    assert not [x for x in names if x.startswith("m2v_node.Binop")]
