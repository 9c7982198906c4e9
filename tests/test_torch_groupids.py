"""A fused family's group ids in one pass (``exprfold.plan_keys``,
``kernels/exprfold.py``'s ``group_ids``), on the CPU.

Q1 at SF 0.01 with the fused aggregate forced on, with and without its sums
on the tensor-core contraction, takes the one pass on every call
(``key_programs``) and keeps the JAX engine's and the oracle's rows; traced,
the pass is one span ``m2v_kernel.group_ids`` and no node of the key or the
mask is evaluated.  ``group_ids_plain`` (what the kernel computes, and what
a CPU tensor takes) equals the node chain it replaces (``Compiler._node_ids``:
``Partition``, its data and the mask evaluated node by node) on the random
keys of ``tests/torch_exprfold_cases.py`` over int8 to int64 and bool leaves.
A ``Partition`` with searchsorted pivots and a leaf with fewer valid rows
than its length keep the node path with the same rows, and of the
benchmark's plans only Q1, fused, takes the pass.  The CUDA kernel runs only
on the card, where chip_smoke.py holds it against the plain version.
"""

import os
import types

import numpy as np
import pytest
import torch

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


def _rows(cols):
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))


@pytest.fixture(scope="module")
def tpch_stores():
    """SF 0.01, seed 7: (port store, its catalog, JAX store, its
    catalog)."""
    ts, js = datagen.generate(sf=0.01, seed=7), jdatagen.generate(sf=0.01,
                                                                  seed=7)
    return ts, ts.make_catalog(), js, js.make_catalog()


@pytest.mark.parametrize("mxu", ["0", "1"], ids=["multiagg", "mxu"])
def test_q1_fused_takes_one_pass(tpch_stores, mxu, monkeypatch):
    """Q1 fused: one group-id pass a call, the JAX engine's rows in order
    and the oracle's."""
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "1")
    monkeypatch.setenv("MPLAN2VDL_MXU_AGG", mxu)
    ts, tcfg, js, jcfg = tpch_stores
    text = torch_plans.PLAN_Q1
    cq = lower.compile_plan_text(text, tcfg, ts, device="cpu")
    assert list(cq.key_plans) == [0]
    want = jlower.CompiledQuery(jcfg, jlower.plan_to_vexps(text, jcfg), js)()
    oracle = tpch.q1(ts)
    for _ in range(2):
        got = cq()
        assert cq.key_programs == 1
        assert cq.expr_folds == 0 and cq.consts_materialized == 0
        for g, w in zip(got.columns, want.columns, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert _rows(got.columns) == _rows(
            [oracle[k] for k in torch_plans.Q1_COLUMNS])


def test_traced_q1_evaluates_no_key_node(tpch_stores, monkeypatch):
    """Traced, Q1's ids are one span ``m2v_kernel.group_ids``; no
    ``Partition``, ``BitOr``, ``BitShift`` or ``Leq`` node is evaluated,
    and its fold is charged the three columns the pass reads."""
    from torch.profiler import ProfilerActivity, profile

    from mplan2vdl_tpu_torch import tracing

    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "1")
    ts, tcfg = tpch_stores[:2]
    cq = lower.compile_plan_text(torch_plans.PLAN_Q1, tcfg, ts, device="cpu")
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        cq()
    names = [r.name for r in tracing.records()]
    assert names.count("m2v_kernel.group_ids") == 1
    assert cq.key_programs == 1
    for kind in ("Partition", "Binop BitOr", "Binop BitShift", "Binop Leq"):
        assert f"m2v_node.{kind}" not in names
    n = len(ts.columns[("lineitem", "l_shipdate")])
    rep = cq.cost_report(per_op=True)
    assert "Partition" not in rep["per_op"]["by_kind"]
    assert max(b for k, b in rep["per_op"]["by_kind"].items()
               if k.startswith("Fold")) >= 3 * 4 * n


@pytest.fixture(scope="module")
def leaf_stores():
    """A small TPC-H store of each package whose lineitem has a column of
    each leaf dtype (``cases.add_leaves``): (port store, its catalog, JAX
    store, its catalog)."""
    out = []
    for gen in (datagen, jdatagen):
        st = gen.generate(sf=0.001, seed=5)
        cases.add_leaves(st, 5)
        out += [st, st.make_catalog()]
    return tuple(out)


def _family(b, case):
    """A group-id case built by ``b``, as ``Compiler._node_ids`` reads a
    ``fuse.Family``: its key (``fgroups``) and mask (``fmask``)."""
    mask, key, rmin, rcount = case
    return types.SimpleNamespace(
        fgroups=b.partition(key, rmin, rcount),
        fmask=None if mask is None else b.build(mask))


def _compiler(st, roots, key_plans=None):
    loads = [vx.name for vx in lower._all_loads(roots)]
    c = lower.Compiler(st, torch.device("cpu"), key_plans=key_plans)
    c.reset({n: torch.as_tensor(st.columns[n]) for n in loads})
    return c


@pytest.mark.parametrize("i", range(cases.KEY_CASES))
def test_group_ids_plain_equals_the_node_chain(leaf_stores, i):
    """Random group keys (int8 to int64 and bool leaves, products that
    wrap in every other case, pivots below, inside and above the keys'
    ranges, with and without a mask): the one pass gives the node chain's
    int32 ids."""
    st, cfg = leaf_stores[:2]
    fam = _family(cases.Builder(V, M, cfg, wrap=i % 2 == 1),
                  cases.key_case(i))
    plan = exprfold.plan_group_ids(fam.fgroups, fam.fmask)
    assert plan is not None
    roots = [fam.fgroups] + ([] if fam.fmask is None else [fam.fmask])
    c = _compiler(st, roots, {0: plan})
    got = c._fused_ids(None, 0)
    assert c.key_programs == 1
    want = _compiler(st, roots)._node_ids(fam)
    assert got.dtype == want.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fixed_keys_spread_over_the_pivots(leaf_stores):
    """The fixed keys give ids inside the pivots as well as at their
    edges, so that the cases above test the clamp and not only its
    bounds; the last one is a 32-bit program deeper than Q1's."""
    st, cfg = leaf_stores[:2]
    for i in range(len(cases.FIXED_KEYS)):
        _, key, rmin, rcount = cases.key_case(i)
        fam = _family(cases.Builder(V, M, cfg), (None, key, rmin, rcount))
        ids = _compiler(st, [fam.fgroups])._node_ids(fam)
        assert bool(((ids > 0) & (ids < rcount - 1)).any()), i
    # the last fixed key's program, over its mask, is 4 deep and every
    # leaf and step of it fits 32 bits
    mask = cases.Builder(V, M, cfg).build(cases.FIXED_MASK)
    p = exprfold.plan_group_ids(fam.fgroups, mask)
    assert kexpr.check_program(p.program, len(p.leaves)) == 4
    assert "a64" not in [x.vx.name[1] for x in p.leaves]
    assert all(s.narrow for s in p.program
               if kexpr.decode(s.kind)[0] not in ("leaf", "imm"))


def test_searchsorted_pivots_decline(leaf_stores, monkeypatch):
    """Three fused sums over a ``Partition`` against pivots of step 16
    (the searchsorted path), masked by ``l_quantity > 1000``: no group-id
    program is planned, and the rows are the node path's and the JAX
    engine's."""
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "1")
    st, cfg, jst, jcfg = leaf_stores

    def roots(V, M, cfg):
        a8 = V.load_raw(cfg, ("lineitem", "a8"))
        g = V.complete(V.Partition(pivots=V.complete(
            V.RangeC(rmin=-64, rstep=16, rcount=8)), pdata=a8))
        qty = V.load_raw(cfg, ("lineitem", "l_quantity"))
        mask = V.binop(M.GT, qty, V.const_(1000, qty))
        return [V.complete(V.Fold(foldop=V.FSUM, fgroups=g, fdata=V.load_raw(
            cfg, ("lineitem", c)), fmask=mask))
            for c in ("l_quantity", "l_extendedprice", "l_tax")]

    cq = lower.CompiledQuery(cfg, roots(V, M, cfg), st, device="cpu")
    assert len(cq.families) == 1 and cq.key_plans == {}
    got = cq()
    assert cq.key_programs == 0
    want = jlower.CompiledQuery(jcfg, roots(JV, JM, jcfg), jst)()
    for g, w in zip(got.columns, want.columns, strict=True):
        np.testing.assert_array_equal(g, w)
    assert len(got.columns[0]) > 1


def test_leaf_with_fewer_valid_rows_declines(tpch_stores, monkeypatch):
    """Q1 fused with its ``l_returnflag`` leaf valid on all but its last
    1000 rows (set in the memo, as a selection or a join leaves a column):
    the call declines the planned pass and gives the node path's rows,
    which drop those rows."""
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "1")
    ts, tcfg = tpch_stores[:2]
    cq = lower.compile_plan_text(torch_plans.PLAN_Q1, tcfg, ts, device="cpu")
    leaf = cq.key_plans[0].leaves[1]
    assert leaf.vx.name == ("lineitem", "l_returnflag")

    def run(key_plans):
        c = lower.Compiler(ts, torch.device("cpu"), cq.fold_map,
                           cq.families, cq.gather_mates, cq.dense_sibs,
                           cq.lookups, cq.expr_plans, key_plans)
        c.reset(dict(zip(cq.loads, cq.device_args())))
        arr = c.eval(leaf).data
        cut = arr.shape[0] - 1000
        c.memo[leaf.skey] = lower.Val(
            data=torch.cat([arr[:cut], arr.new_zeros(1000)]), valid=cut,
            length=arr.shape[0])
        cols = c.fetch([c._force(c.eval(v)) for v in cq.vexps])
        return c.key_programs, cols

    k, got = run(cq.key_plans)
    k0, want = run({})
    assert k == k0 == 0
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    count = torch_plans.Q1_COLUMNS.index("count_order")
    full = tpch.q1(ts)["count_order"]
    assert int(np.sum(got[count])) < int(np.sum(full))


@pytest.fixture(scope="module")
def bench_store():
    st = datagen.generate(sf=0.02, seed=11)
    return st, st.make_catalog()


# the benchmark's plans (``h100bench/queries``, both mixes) with the fused
# aggregate forced on: (families whose ids are planned for one pass,
# families whose ids took it on a call)
KEYS_ENGAGED = {"q1": (1, 1), "q6": (0, 0), "q3": (0, 0), "q5": (0, 0),
                "q9": (0, 0), "q13": (0, 0), "q17": (0, 0)}


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("q", sorted(KEYS_ENGAGED))
def test_benchmark_plans_engage(bench_store, q, fused, monkeypatch):
    """Which of the benchmark's plans take the one pass: Q1 fused, and no
    other, and none unfused."""
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", fused)
    st, cfg = bench_store
    with open(os.path.join(QUERIES, f"{q}.mplan")) as f:
        cq = lower.compile_plan_text(f.read(), cfg, st, device="cpu")
    cq()
    want = KEYS_ENGAGED[q] if fused == "1" else (0, 0)
    assert (len(cq.key_plans), cq.key_programs) == want
