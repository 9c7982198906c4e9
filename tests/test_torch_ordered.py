"""ORDER BY, top N, scatters through repeated positions and count(DISTINCT):
the port against the JAX engine on the CPU.

Every comparison is exact.  Node by node, each built by hand with each
package's own ``vir`` over the same store columns:

* ``SortPerm`` with one to four keys in mixed directions, int32 and int64
  keys, descending negative values, and keys with rows past ``valid``: the
  permutations are equal in order;
* ``Semisort`` over a buffer with padding past ``valid`` (the padding
  sorts too, as in the JAX engine);
* ``Shuffle SCATTER`` through ascending repeated positions, positions in no
  order, positions at ``L`` and beyond, positions with ``valid < length``,
  and unique positions in no order: the vectors are equal, and a spy shows
  the port took its repeated-position scatter;
* ``Fold FDistinct`` over a dense and a sparse group domain, with its
  packed sort key in int32, in int64 and too wide for one key, and under an
  ``fmask``, each also against a numpy count; the three plans of
  tests/test_distinct.py against the JAX engine and their numpy count.

Plans: torch_plans' TPC-H Q4 and Q16 row for row in order, Q3 with its
ORDER BY ... LIMIT 10 tie-tolerantly (sorted per its order, and the same
multiset of order-key tuples).  The ordered fuzz plans are in
tests/test_torch_ordered_fuzz.py.
"""

import numpy as np
import pytest

import test_distinct
import torch_plans
from mplan2vdl_tpu import mplan as jM
from mplan2vdl_tpu import passes as jpasses
from mplan2vdl_tpu import vir as jV
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu.fe import lexer as jlexer
from mplan2vdl_tpu.fe import plan_parser as jparser
from mplan2vdl_tpu_torch import mplan as tM
from mplan2vdl_tpu_torch import passes as tpasses
from mplan2vdl_tpu_torch import vir as tV
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine import lower as tlower
from mplan2vdl_tpu_torch.fe import lexer as tlexer
from mplan2vdl_tpu_torch.fe import plan_parser as tparser

SF = 0.01
SEEDS = (7, 11)
LI = "lineitem"


@pytest.fixture(scope="module")
def stores():
    """seed -> (port store, its catalog, JAX store, its catalog)."""
    out = {}
    for seed in SEEDS:
        ts = tdatagen.generate(sf=SF, seed=seed)
        js = jdatagen.generate(sf=SF, seed=seed)
        out[seed] = (ts, ts.make_catalog(), js, js.make_catalog())
    return out


def _cols(res):
    return [np.asarray(c, np.int64) for c in res.columns]


def _run_vexps(stores, seed, build):
    """``build(V, cfg)`` -> output Vexps, once with each package's ``vir``,
    through its engine: (port columns, JAX columns, the port's Vals)."""
    ts, tcfg, js, jcfg = stores[seed]
    tq = tlower.CompiledQuery(tcfg, build(tV, tcfg), ts, device="cpu")
    got = tq()
    want = jlower.CompiledQuery(jcfg, build(jV, jcfg), js)()
    assert [g.dtype for g in got.columns] == [w.dtype for w in want.columns]
    return _cols(got), _cols(want), tq.run()


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _load(V, cfg, col, tab=LI):
    return V.load_raw(cfg, (tab, col))


def _neg(V, v):
    return V.sub_(V.zeros_(v), v)


def _sum_by_order(V, cfg, col):
    """sum(col) per l_orderkey: a sparse fold whose buffer has rows past
    its ``valid``."""
    return V.complete(V.Fold(foldop=V.FSUM,
                             fgroups=_load(V, cfg, "l_orderkey"),
                             fdata=_load(V, cfg, col)))


# ------------------------------------------------------------------ SortPerm
def _sort_keys(V, cfg, case):
    """(keys, descending flags) of a SortPerm case."""
    L = lambda c: _load(V, cfg, c)  # noqa: E731
    if case == "one_key":
        return [L("l_quantity")], [False]
    if case == "two_keys":
        return [L("l_returnflag"), L("l_shipdate")], [True, False]
    if case == "three_keys":
        return ([L("l_linestatus"), L("l_quantity"), L("l_orderkey")],
                [False, True, True])
    if case == "four_keys":
        return ([L("l_shipmode"), L("l_returnflag"), L("l_discount"),
                 L("l_extendedprice")], [True, False, True, False])
    if case == "int64_key":
        ext = L("l_extendedprice")
        return [V.mul_(ext, ext), L("l_orderkey")], [True, False]
    if case == "negative_desc":
        return ([_neg(V, L("l_tax")), _neg(V, L("l_extendedprice"))],
                [True, True])
    assert case == "past_valid"
    return ([_sum_by_order(V, cfg, "l_linenumber"),
             _sum_by_order(V, cfg, "l_quantity")], [True, False])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["one_key", "two_keys", "three_keys",
                                  "four_keys", "int64_key", "negative_desc",
                                  "past_valid"])
def test_sortperm_matches_jax(stores, seed, case):
    def build(V, cfg):
        keys, descs = _sort_keys(V, cfg, case)
        return [V.complete(V.SortPerm(keys=tuple(keys), descs=tuple(descs)))]

    got, want, vals = _run_vexps(stores, seed, build)
    _equal(got, want)
    (perm,) = got
    assert len(perm) > 1000 and len(np.unique(perm)) == len(perm)
    if case == "int64_key":
        assert _sort_keys(tV, stores[seed][1], case)[0][0].info.bounds[1] \
            > 2**31
    if case == "past_valid":
        assert int(vals[0].valid) < vals[0].length


# ------------------------------------------------------------------ Semisort
@pytest.mark.parametrize("seed", SEEDS)
def test_semisort_matches_jax(stores, seed):
    def build(V, cfg):
        return [V.complete(V.Semisort(
            sdata=_sum_by_order(V, cfg, "l_quantity")))]

    got, want, vals = _run_vexps(stores, seed, build)
    _equal(got, want)
    # the padding's zeros sort first: the kept prefix begins with the
    # padding rows
    valid, pad = int(vals[0].valid), vals[0].length - int(vals[0].valid)
    assert pad > 0 and (got[0][:pad] >= valid).all()


# ------------------------------------------------------------------- scatter
def _scatter(V, cfg, case):
    L = lambda c: _load(V, cfg, c)  # noqa: E731
    if case == "monotone_repeated":
        pos = L("l_orderkey")
        return V.scatter(V.ones_(pos), pos)
    if case == "unordered_repeated":
        pos = L("l_partkey")
        return V.scatter(V.ones_(pos), pos)
    if case == "past_L":
        pos = L("l_linenumber")
        return V.scatter(V.ones_(pos), pos, shape=V.complete(
            V.RangeC(rmin=0, rstep=1, rcount=4)))
    if case == "valid_lt_length":
        pos = _sum_by_order(V, cfg, "l_linenumber")
        return V.scatter(V.ones_(pos), pos)
    assert case == "unique_unordered"
    perm = V.complete(V.SortPerm(keys=(L("l_extendedprice"),),
                                 descs=(True,)))
    return V.scatter(L("l_quantity"), perm)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["monotone_repeated", "unordered_repeated",
                                  "past_L", "valid_lt_length",
                                  "unique_unordered"])
def test_repeat_scatter_matches_jax(stores, monkeypatch, seed, case):
    calls = []

    def spy(p, src, L):
        calls.append((p.shape[0], L, int((p >= L).sum())))
        return repeat_scatter(p, src, L)

    repeat_scatter = tlower.repeat_scatter
    monkeypatch.setattr(tlower, "repeat_scatter", spy)
    got, want, _ = _run_vexps(stores, seed,
                              lambda V, cfg: [_scatter(V, cfg, case)])
    _equal(got, want)
    # one scatter per evaluation (the check's and the Vals' run)
    assert len(calls) == 2 and got[0].any()
    n, L, dropped = calls[0]
    if case == "past_L":
        assert L == 4 and dropped > 0
    if case == "valid_lt_length":
        assert dropped > 0


# ---------------------------------------------------------------- FDistinct
def _distinct(V, cfg, case):
    """(group ids, values, mask or None) of an FDistinct case."""
    L = lambda c: _load(V, cfg, c)  # noqa: E731
    under = V.lt_(L("l_quantity"), V.const_(2500, L("l_quantity")))
    if case == "dense":
        return L("l_linestatus"), L("l_suppkey"), None
    if case == "dense_fmask":
        return L("l_linestatus"), L("l_suppkey"), under
    if case == "sparse_int32_key":
        return L("l_orderkey"), L("l_partkey"), None
    if case == "sparse_int64_key":
        return L("l_orderkey"), L("l_extendedprice"), None
    if case == "sparse_fmask":
        return L("l_orderkey"), L("l_suppkey"), under
    assert case == "two_sorts"
    ext = L("l_extendedprice")
    g = V.add_(V.mul_(L("l_orderkey"), V.const_(1000, ext)),
               L("l_linenumber"))
    return g, V.mul_(ext, ext), None


def _np_distinct(g, v, m):
    pairs = np.unique(np.stack([g[m], v[m]], axis=1), axis=0)
    keys, counts = np.unique(pairs[:, 0], return_counts=True)
    return keys, counts


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["dense", "dense_fmask", "sparse_int32_key",
                                  "sparse_int64_key", "sparse_fmask",
                                  "two_sorts"])
def test_fdistinct_matches_jax(stores, seed, case):
    def build(V, cfg):
        g, v, m = _distinct(V, cfg, case)
        return [V.complete(V.Fold(foldop=V.FCHOOSE, fgroups=g, fdata=g,
                                  fmask=m)),
                V.complete(V.Fold(foldop=V.FDISTINCT, fgroups=g, fdata=v,
                                  fmask=m))]

    got, want, _ = _run_vexps(stores, seed, build)
    _equal(got, want)
    ts = stores[seed][0]
    c = lambda n: np.asarray(ts.columns[(LI, n)], np.int64)  # noqa: E731
    m = (c("l_quantity") < 2500 if case.endswith("fmask")
         else np.ones(len(c("l_orderkey")), bool))
    if case == "two_sorts":
        g, v = c("l_orderkey") * 1000 + c("l_linenumber"), \
            c("l_extendedprice") ** 2
    else:
        g, v = {"dense": (c("l_linestatus"), c("l_suppkey")),
                "dense_fmask": (c("l_linestatus"), c("l_suppkey")),
                "sparse_int32_key": (c("l_orderkey"), c("l_partkey")),
                "sparse_int64_key": (c("l_orderkey"), c("l_extendedprice")),
                "sparse_fmask": (c("l_orderkey"), c("l_suppkey"))}[case]
    keys, counts = _np_distinct(g, v, m)
    _equal(got, [keys, counts])
    # the key's width picks the sort: one packed key, or two sorts
    _, tcfg = stores[seed][:2]
    gv, vv, _ = _distinct(tV, tcfg, case)
    lo, hi = vv.info.bounds
    W = max(hi, 0) - min(lo, 0) + 1
    packed = (gv.info.bounds[1] + 2) * W <= 2**62
    assert packed == (case != "two_sorts")


FMASK_PLAN = """project (
| group by (
| | select (
| | | table(sys.lineitem) [ lineitem.l_linestatus NOT NULL,
| | |   lineitem.l_suppkey NOT NULL, lineitem.l_quantity NOT NULL ] COUNT
| | ) [ lineitem.l_quantity NOT NULL < tinyint "25" ]
| ) [ lineitem.l_linestatus ] [ lineitem.l_linestatus,
|   sys.count unique no nil (lineitem.l_suppkey) NOT NULL as L1.L1 ]
) [ lineitem.l_linestatus, L1 NOT NULL ]
"""


@pytest.fixture(scope="module")
def distinct_stores():
    """tests/test_distinct.py's store: SF 0.02, seed 11."""
    ts = tdatagen.generate(sf=0.02, seed=11)
    js = jdatagen.generate(sf=0.02, seed=11)
    return ts, ts.make_catalog(), js, js.make_catalog()


def _distinct_vexps(lexer, parser, M, V, passes, cfg, text):
    """tests/test_distinct.py's lowering: FK joins pushed, selects fused."""
    m = M.mplan_from_parse_tree(parser.parse(lexer.strip_plan_comments(text)),
                                cfg)
    return passes.engine_passes(V.vexps_from_mplan(
        M.fuse_selects(M.push_fk_joins(m)), cfg))


@pytest.mark.parametrize("plan", ["dense", "sparse", "fmask"])
def test_distinct_plans_match_jax(distinct_stores, plan):
    text = {"dense": test_distinct.PLAN_DENSE,
            "sparse": test_distinct.PLAN_SPARSE, "fmask": FMASK_PLAN}[plan]
    ts, tcfg, js, jcfg = distinct_stores
    got = _cols(tlower.CompiledQuery(tcfg, _distinct_vexps(
        tlexer, tparser, tM, tV, tpasses, tcfg, text), ts, device="cpu")())
    want = _cols(jlower.CompiledQuery(jcfg, _distinct_vexps(
        jlexer, jparser, jM, jV, jpasses, jcfg, text), js)())
    _equal(got, want)
    c = lambda n: np.asarray(ts.columns[(LI, n)], np.int64)  # noqa: E731
    g = c("l_orderkey") if plan == "sparse" else c("l_linestatus")
    m = (c("l_quantity") < 25 if plan == "fmask"
         else np.ones(len(g), bool))
    keys, counts = _np_distinct(g, c("l_suppkey"), m)
    _equal(got[:2], [keys, counts])


# --------------------------------------------------------------------- plans
def _both(stores, seed, text):
    ts, tcfg, js, jcfg = stores[seed]
    got = tlower.compile_plan_text(text, tcfg, ts, device="cpu")()
    want = jlower.CompiledQuery(jcfg, jlower.plan_to_vexps(text, jcfg), js)()
    assert got.names == want.names
    return _cols(got), _cols(want)


def _sorted_by(cols, spec):
    """Whether the rows are sorted by ``spec``: (column, descending)."""
    keys = np.stack([-cols[i] if d else cols[i] for i, d in spec], axis=1)
    return all(tuple(a) <= tuple(b) for a, b in zip(keys[:-1], keys[1:]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("plan", ["q4", "q16"])
def test_ordered_plan_in_order(stores, seed, plan):
    text = {"q4": torch_plans.PLAN_Q4, "q16": torch_plans.PLAN_Q16}[plan]
    got, want = _both(stores, seed, text)
    assert len(got[0]) > 1
    _equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_q3_top10_tie_tolerant(stores, seed):
    got, want = _both(stores, seed, torch_plans.PLAN_Q3_TOP10)
    # revenue descending, then o_orderdate
    spec = [(1, True), (2, False)]
    assert len(got[0]) == 10 and _sorted_by(got, spec)
    assert sorted(zip(got[1].tolist(), got[2].tolist())) == sorted(
        zip(want[1].tolist(), want[2].tolist()))
