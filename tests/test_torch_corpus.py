"""The JAX package's CPU test plans through the port and the JAX engine.

Each plan is built once with each package's own ``mplan`` module, so that
each engine lowers its own tree, and runs through both engines on the CPU;
the rows must be equal as multisets.  The plans:

* the 40 random plans of tests/test_fuzz.py, re-stated here with the
  ``mplan`` module as a parameter (``rand_plan``; the JAX-built tree is
  checked equal to test_fuzz's own), also held against the JAX package's
  relational oracle;
* the seven single-device plans of tests/test_null_semantics.py (outer
  joins with null-aware aggregates, comparisons, ``isnull``, extra ON
  conditions);
* a semi and an anti join with an extra condition, which mark the left rows
  through a scatter of repeated positions; a spy shows the port took its
  repeated-position scatter, and the relational oracle checks the rows.

The three plans of tests/test_join_corners.py, the rest of the census, are
held against the JAX engine and the oracle in tests/test_torch_joins.py.
"""

import random

import numpy as np
import pytest

import test_fuzz
from mplan2vdl_tpu import mplan as jM
from mplan2vdl_tpu import passes as jpasses
from mplan2vdl_tpu import vir as jV
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu.mtypes import DDecimal as jDDecimal
from mplan2vdl_tpu.oracle import relinterp
from mplan2vdl_tpu_torch import mplan as tM
from mplan2vdl_tpu_torch import passes as tpasses
from mplan2vdl_tpu_torch import vir as tV
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine import lower as tlower
from mplan2vdl_tpu_torch.mtypes import DDecimal as tDDecimal

ENGINES = {"port": (tM, tDDecimal), "jax": (jM, jDDecimal)}


# ------------------------------------------------- the fuzz plan generator
def rand_plan(M, DDecimal, rng):
    """tests/test_fuzz.py's ``_rand_plan`` over the ``mplan`` module ``M``:
    the same draws from ``rng`` give the same tree."""
    LI = test_fuzz.LI

    def ref(col):
        return M.MRef(name=(LI, col))

    def lit(v):
        return M.MLiteral(DDecimal(0), int(v))

    def pred():
        if rng.random() < 0.15:
            kcol = rng.choice(test_fuzz.KEY_COLS)
            vals = sorted({rng.randint(0, 7)
                           for _ in range(rng.randint(1, 3))})
            return M.MIn(ref(kcol), tuple(lit(v) for v in vals))
        col, lo, hi = rng.choice(test_fuzz.VALUE_COLS)
        op = rng.choice([M.LT, M.GT, M.LEQ, M.GEQ, M.EQ, M.NEQ])
        v = rng.choice([lo, hi, rng.randint(lo, hi),
                        rng.randint(lo, hi), lo - 1, hi + 1])
        p = M.MBinop(op, ref(col), lit(v))
        if rng.random() < 0.4:
            col2, lo2, hi2 = rng.choice(test_fuzz.VALUE_COLS)
            q = M.MBinop(rng.choice([M.LT, M.GEQ]), ref(col2),
                         lit(rng.randint(lo2, hi2)))
            p = M.MBinop(rng.choice([M.LOGAND, M.LOGOR]), p, q)
        return p

    def expr(depth=0):
        r = rng.random()
        if depth < 2 and r < 0.12:
            return M.MIfThenElse(pred(), expr(depth + 1), expr(depth + 1))
        if depth < 2 and r < 0.2:
            return M.MBinop(M.DIV, expr(depth + 1), lit(rng.randint(1, 50)))
        if depth < 2 and r < 0.26:
            return M.MUnary(M.NEG, M.MBinop(
                rng.choice([M.LT, M.GEQ]),
                ref(rng.choice(test_fuzz.VALUE_COLS)[0]),
                lit(rng.randint(0, 6000))))
        if depth >= 2 or r < 0.55:
            if rng.random() < 0.75:
                return ref(rng.choice(test_fuzz.VALUE_COLS)[0])
            return lit(rng.randint(1, 100))
        op = rng.choice([M.ADD, M.SUB, M.MUL, M.MIN, M.MAX])
        return M.MBinop(op, expr(depth + 1), expr(depth + 1))

    cols = tuple(((LI, c), None) for c, _, _ in test_fuzz.VALUE_COLS) + tuple(
        ((LI, c), None) for c in test_fuzz.KEY_COLS)
    rel = M.RTable(tablename=(LI,), tablecolumns=cols)
    for _ in range(rng.randint(0, 2)):
        rel = M.RSelect(child=rel, predicate=pred())
    nkeys = rng.randint(0, 2)
    keys = tuple(((LI, k), None)
                 for k in rng.sample(test_fuzz.KEY_COLS, nkeys))
    aggs = []
    for i in range(rng.randint(1, 3)):
        kind = rng.random()
        if kind < 0.2:
            agg = M.GCount()
        elif kind < 0.35:
            agg = M.GAvg(expr())
        else:
            agg = M.GFold(rng.choice([M.FSUM, M.FMAX, M.FMIN]), expr())
        aggs.append((agg, ("out%d" % i,)))
    for k, _ in keys:
        aggs.append((M.GFold(M.FCHOOSE, M.MRef(name=k)), (k[-1],)))
    return M.RGroupBy(child=rel, inputkeys=keys, outputaggs=tuple(aggs))


# ----------------------------------------------------------------- helpers
def run_both(stores, plans):
    """Each engine's tree (``plans``: engine -> RelExpr) through its own
    engine on the CPU: (port columns, JAX columns), as int64 arrays."""
    ts, tcfg, js, jcfg = stores
    tq = tlower.CompiledQuery(
        tcfg, tpasses.engine_passes(tV.vexps_from_mplan(plans["port"], tcfg)),
        ts, device="cpu")
    jq = jlower.CompiledQuery(
        jcfg, jpasses.engine_passes(jV.vexps_from_mplan(plans["jax"], jcfg)),
        js)
    got, want = tq(), jq()
    assert got.names == want.names
    return ([np.asarray(c, np.int64) for c in got.columns],
            [np.asarray(c, np.int64) for c in want.columns])


def rows(cols):
    return sorted(zip(*[c.tolist() for c in cols])) if cols else []


def oracle_rows(store, plan):
    fr = relinterp.run_oracle(store, plan)
    return rows([np.asarray(a, np.int64) for _, a in fr.cols])


def _stores(sf, seed):
    ts = tdatagen.generate(sf=sf, seed=seed)
    js = jdatagen.generate(sf=sf, seed=seed)
    return ts, ts.make_catalog(), js, js.make_catalog()


@pytest.fixture(scope="module")
def fuzz_stores():
    """test_fuzz's store: SF 0.002, seed 1."""
    return _stores(0.002, 1)


@pytest.fixture(scope="module")
def stores():
    """test_null_semantics' store: SF 0.01, seed 7."""
    return _stores(0.01, 7)


# -------------------------------------------------------------- fuzz plans
@pytest.mark.parametrize("seed", range(40))
def test_fuzz_plan(fuzz_stores, seed):
    plans = {k: rand_plan(M, DD, random.Random(seed))
             for k, (M, DD) in ENGINES.items()}
    assert plans["jax"] == test_fuzz._rand_plan(random.Random(seed))
    got, want = run_both(fuzz_stores, plans)
    assert rows(got) == rows(want)
    assert rows(got) == oracle_rows(fuzz_stores[2], plans["jax"])


# ------------------------------------------------------ null-semantics plans
NULL_PLANS = ("min_max_sum_avg_count", "mixed_groups", "arithmetic_agg",
              "comparison", "isnull", "outer_extra_condition",
              "outer_extra_condition_aggs")


def null_plan(M, DDecimal, which, tp):
    """The single-device plan of tests/test_null_semantics.py that
    ``which`` names, over ``M``; ``tp`` is o_totalprice (the comparison
    and extra-condition plans take a percentile of it)."""
    def scan(tab, cols):
        return M.RTable(tablename=(tab,),
                        tablecolumns=tuple(((tab, c), None) for c in cols))

    def lit(v):
        return M.MLiteral(DDecimal(0), int(v))

    def ref(n):
        return M.MRef((n,))

    def outer(conds):
        return M.RJoin(leftch=scan("customer", ["c_custkey"]),
                       rightch=scan("orders", ["o_orderkey", "o_custkey",
                                               "o_totalprice"]),
                       conds=conds, joinvariant=M.LEFTOUTER)

    eq = M.MBinop(M.EQ, ref("c_custkey"), ref("o_custkey"))
    by_cust = ((("c_custkey",), None),)
    k = (M.GFold(M.FCHOOSE, ref("c_custkey")), ("k",))
    if which == "min_max_sum_avg_count":
        return M.RGroupBy(child=outer((eq,)), inputkeys=by_cust, outputaggs=(
            k, (M.GFold(M.FMIN, ref("o_totalprice")), ("mn",)),
            (M.GFold(M.FMAX, ref("o_totalprice")), ("mx",)),
            (M.GFold(M.FSUM, ref("o_totalprice")), ("sm",)),
            (M.GAvg(ref("o_totalprice")), ("av",)),
            (M.GCount(col=("o_totalprice",)), ("cn",)),
            (M.GCount(), ("call",))))
    if which == "mixed_groups":
        proj = M.RProject(child=outer((eq,)), projectout=(
            (M.MBinop(M.MOD, ref("c_custkey"), lit(7)), ("g",)),
            (ref("o_totalprice"), ("tp",)), (ref("o_orderkey"), ("ok",))))
        return M.RGroupBy(child=proj, inputkeys=((("g",), None),),
                          outputaggs=(
                              (M.GFold(M.FCHOOSE, ref("g")), ("k",)),
                              (M.GFold(M.FMIN, ref("tp")), ("mn",)),
                              (M.GFold(M.FMAX, ref("tp")), ("mx",)),
                              (M.GAvg(ref("tp")), ("av",)),
                              (M.GCount(col=("ok",)), ("cn",))))
    if which == "arithmetic_agg":
        e = M.MBinop(M.ADD, M.MBinop(M.MUL, ref("o_totalprice"), lit(2)),
                     lit(5))
        return M.RGroupBy(child=outer((eq,)), inputkeys=by_cust, outputaggs=(
            k, (M.GFold(M.FSUM, e), ("sm",)), (M.GAvg(e), ("av",))))
    if which == "comparison":
        sel = M.RSelect(child=outer((eq,)), predicate=M.MBinop(
            M.LT, ref("o_totalprice"), lit(int(np.percentile(tp, 60)))))
        return M.RProject(child=sel, projectout=(
            (ref("c_custkey"), ("ck",)), (ref("o_orderkey"), ("ok",))))
    if which == "isnull":
        return M.RProject(child=outer((eq,)), projectout=(
            (ref("c_custkey"), ("ck",)),
            (M.MUnary(M.ISNULL, ref("o_orderkey")), ("isn",))))
    join = outer((eq, M.MBinop(M.GT, ref("o_totalprice"),
                               lit(int(np.percentile(tp, 75))))))
    if which == "outer_extra_condition":
        return M.RProject(child=join, projectout=(
            (ref("c_custkey"), ("ck",)), (ref("o_orderkey"), ("ok",)),
            (ref("o_totalprice"), ("tp",))))
    assert which == "outer_extra_condition_aggs"
    return M.RGroupBy(child=join, inputkeys=by_cust, outputaggs=(
        k, (M.GFold(M.FMIN, ref("o_totalprice")), ("mn",)),
        (M.GCount(col=("o_orderkey",)), ("cn",))))


@pytest.mark.parametrize("which", NULL_PLANS)
def test_null_semantics_plan(stores, which):
    tp = np.asarray(stores[2].columns[("orders", "o_totalprice")])
    plans = {k: null_plan(M, DD, which, tp) for k, (M, DD) in ENGINES.items()}
    got, want = run_both(stores, plans)
    assert got and len(got[0]) > 0
    assert rows(got) == rows(want)


# ------------------------------------ semi and anti joins, extra condition
def extra_condition_join(M, DDecimal, variant):
    """orders semi (anti) joined with lineitem on the order key, under the
    extra condition l_quantity > 45 (two decimal digits)."""
    def scan(tab, cols):
        return M.RTable(tablename=(tab,),
                        tablecolumns=tuple(((tab, c), None) for c in cols))

    conds = (M.MBinop(M.EQ, M.MRef(("orders", "o_orderkey")),
                      M.MRef(("lineitem", "l_orderkey"))),
             M.MBinop(M.GT, M.MRef(("lineitem", "l_quantity")),
                      M.MLiteral(DDecimal(0), 4500)))
    return M.RJoin(leftch=scan("orders", ["o_orderkey", "o_custkey"]),
                   rightch=scan("lineitem", ["l_orderkey", "l_quantity"]),
                   conds=conds, joinvariant=variant)


@pytest.mark.parametrize("variant", ["LEFTSEMI", "LEFTANTI"])
def test_extra_condition_semi_anti(stores, monkeypatch, variant):
    calls = []

    def spy(p, src, L):
        calls.append((p.shape[0], L, int(p[p < L].unique().numel())))
        return repeat_scatter(p, src, L)

    repeat_scatter = tlower.repeat_scatter
    monkeypatch.setattr(tlower, "repeat_scatter", spy)
    plans = {k: extra_condition_join(M, DD, getattr(M, variant))
             for k, (M, DD) in ENGINES.items()}
    got, want = run_both(stores, plans)
    assert got and len(got[0]) > 0
    assert rows(got) == rows(want)
    assert rows(got) == oracle_rows(stores[2], plans["jax"])
    # the left-row marks: positions repeat (several lineitems of an order)
    assert calls and any(n > distinct for n, _, distinct in calls), calls
