"""The port's engine against the JAX engine and the oracles, on the CPU.

The port's plans (TPC-H Q6, Q1, a lineitem scan-filter-project, the
FK-join path: Q3 in its no-order form, Q5 and a sparse group-by over
l_orderkey, and the general-join path: Q9 in its no-order form, Q13, Q17
and a group-by over substring(c_phone, 1, 2), all defined once in
tests/torch_plans.py) run through the port (``device="cpu"``), through the JAX
``CompiledQuery`` on the CPU and through the oracles (the port's
``oracle/tpch``, numpy mask-and-take, and torch_plans' numpy join oracles),
at two seeds; Q1 runs with the fused multi-aggregate path forced on and off
on both engines, and forced on with its sums on the tensor-core contraction
(MPLAN2VDL_MXU_AGG=1).  Every comparison is exact: the engine is integer
throughout.  The general-join plans compare as row multisets (the engines
may order the pairs within a run of equal join keys differently); the
others row for row, in order.
"""

import numpy as np
import pytest

import torch_plans
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine import lower as tlower
from mplan2vdl_tpu_torch.oracle import tpch

SF = 0.01
SEEDS = (7, 11)
PLANS = {"q6": torch_plans.PLAN_Q6, "q1": torch_plans.PLAN_Q1,
         "filter_project": torch_plans.PLAN_FILTER_PROJECT,
         "q3": torch_plans.PLAN_Q3, "q5": torch_plans.PLAN_Q5,
         "sparse_groupby": torch_plans.PLAN_SPARSE_GROUPBY,
         "q9": torch_plans.PLAN_Q9, "q13": torch_plans.PLAN_Q13,
         "q17": torch_plans.PLAN_Q17,
         "substr_groupby": torch_plans.PLAN_SUBSTR_GROUPBY}
JOIN_ORACLES = {"q3": torch_plans.oracle_q3, "q5": torch_plans.oracle_q5,
                "sparse_groupby": torch_plans.oracle_sparse_groupby,
                "q9": torch_plans.oracle_q9, "q13": torch_plans.oracle_q13,
                "q17": torch_plans.oracle_q17,
                "substr_groupby": torch_plans.oracle_substr_groupby}
# compared as row multisets
GENERAL_JOIN = ("q9", "q13", "q17", "substr_groupby")
RUNS = [("q6", None), ("q1", "1"), ("q1", "0"), ("q1", "mxu"),
        ("filter_project", None), ("q3", None), ("q5", None),
        ("sparse_groupby", None)] + [(p, None) for p in GENERAL_JOIN]


@pytest.fixture(scope="module")
def stores():
    """seed -> (port store, its catalog, JAX store, its catalog)."""
    out = {}
    for seed in SEEDS:
        ts = tdatagen.generate(sf=SF, seed=seed)
        js = jdatagen.generate(sf=SF, seed=seed)
        out[seed] = (ts, ts.make_catalog(), js, js.make_catalog())
    return out


def _oracle(store, plan):
    if plan in JOIN_ORACLES:
        return JOIN_ORACLES[plan](store)
    if plan == "q6":
        return [tpch.q6(store)["revenue"]]
    if plan == "q1":
        want = tpch.q1(store)
        return [want[k] for k in torch_plans.Q1_COLUMNS]
    ship = store.columns[("lineitem", "l_shipdate")]
    m = (ship >= tpch.day(1994, 1, 1)) & (ship < tpch.day(1995, 1, 1))
    return [store.columns[("lineitem", c)][m]
            for c in torch_plans.FP_COLUMNS]


def _rows(cols):
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))


def _run_id(plan, fused):
    if fused == "mxu":
        return f"{plan}-mxu"
    return f"{plan}-fused{fused}" if fused else plan


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("plan,fused", RUNS,
                         ids=[_run_id(p, f) for p, f in RUNS])
def test_slice_matches_jax_and_oracle(stores, monkeypatch, seed, plan,
                                      fused):
    if fused == "mxu":  # both engines: fused, sums on the tensor cores
        monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "1")
        monkeypatch.setenv("MPLAN2VDL_MXU_AGG", "1")
    elif fused is not None:
        monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", fused)
    ts, tcfg, js, jcfg = stores[seed]
    text = PLANS[plan]
    tq = tlower.CompiledQuery(tcfg, tlower.plan_to_vexps(text, tcfg), ts,
                              device="cpu")
    jq = jlower.CompiledQuery(jcfg, jlower.plan_to_vexps(text, jcfg), js)
    if fused in ("1", "mxu"):
        assert len(tq.families) == 1 and len(jq.families) == 1
        assert tq.families[0].specs == [
            tlower.AggSpec(**vars(s)) for s in jq.families[0].specs]
    got, want = tq(), jq()
    assert got.names == want.names
    assert len(got.columns) == len(want.columns)
    for g, w in zip(got.columns, want.columns):
        assert g.dtype == w.dtype
        if plan not in GENERAL_JOIN:
            np.testing.assert_array_equal(g, w)  # row for row, in order
    assert _rows(got.columns) == _rows(want.columns)
    assert _rows(got.columns) == _rows(_oracle(ts, plan))
    assert len(got.columns[0]) > 0


@pytest.mark.parametrize("small_table", [65536, 100])
def test_join_routing(stores, monkeypatch, small_table):
    """Q5's kernels and routing: its scatters take the monotone scatter;
    non-monotone gathers from tables of at most SMALL_TABLE rows take the
    small-table gather and larger ones the monotone gather's kernel.  With
    the threshold moved down to 100 rows the customer and orders gathers
    change kernel and the rows stay the oracle's."""
    ts, tcfg, _, _ = stores[SEEDS[0]]
    calls = {"scatter": 0, "small": [], "large": []}
    gather_many, scatter = tlower.gather_many, tlower.monotone_scatter

    def spy_gather(srcs, pos, valid, small=False):
        calls["small" if small else "large"].append(len(srcs[0]))
        return gather_many(srcs, pos, valid, small=small)

    def spy_scatter(pos, src, L):
        calls["scatter"] += 1
        return scatter(pos, src, L)

    monkeypatch.setattr(tlower, "gather_many", spy_gather)
    monkeypatch.setattr(tlower, "monotone_scatter", spy_scatter)
    monkeypatch.setattr(tlower, "SMALL_TABLE", small_table)
    got = tlower.compile_plan_text(torch_plans.PLAN_Q5, tcfg, ts,
                                   device="cpu")()
    assert _rows(got.columns) == _rows(torch_plans.oracle_q5(ts))
    assert calls["scatter"] == 3
    assert calls["small"] and max(calls["small"]) <= small_table
    # nation (25 rows) and region (5 rows) gathers stay small either way
    assert 25 in calls["small"]
    n_cust = len(ts.columns[("customer", "c_custkey")])
    assert (n_cust in calls["small"]) == (n_cust <= small_table)
    assert (n_cust in calls["large"]) == (n_cust > small_table)


@pytest.mark.parametrize("mxu", [True, False])
def test_mxu_routing(stores, monkeypatch, mxu):
    """With MPLAN2VDL_MXU_AGG on, Q1's family sends exactly its sum specs
    (the appended count included) to the tensor-core aggregate and its max
    specs to fused_group_aggregate; off, the tensor-core aggregate is never
    called and fused_group_aggregate gets every spec."""
    ts, tcfg, _, _ = stores[SEEDS[0]]
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "1")
    monkeypatch.setenv("MPLAN2VDL_MXU_AGG", "1" if mxu else "0")
    calls = {"mxu": [], "fused": []}
    mxu_fn, fused_fn = (tlower.fused_group_aggregate_mxu,
                        tlower.fused_group_aggregate)

    def spy_mxu(cols, gid, specs, n_groups):
        calls["mxu"].append(list(specs))
        return mxu_fn(cols, gid, specs, n_groups)

    def spy_fused(cols, gid, specs, n_groups):
        calls["fused"].append(list(specs))
        return fused_fn(cols, gid, specs, n_groups)

    monkeypatch.setattr(tlower, "fused_group_aggregate_mxu", spy_mxu)
    monkeypatch.setattr(tlower, "fused_group_aggregate", spy_fused)
    cq = tlower.compile_plan_text(torch_plans.PLAN_Q1, tcfg, ts, device="cpu")
    got = cq()
    specs = list(cq.families[0].specs) + [tlower.AggSpec(base=None, bits=1)]
    sums = [s for s in specs if s.op == "sum"]
    maxes = [s for s in specs if s.op == "max"]
    assert len(sums) == 7 and len(maxes) == 2
    if mxu:
        assert calls == {"mxu": [sums], "fused": [maxes]}
    else:
        assert calls == {"mxu": [], "fused": [specs]}
    want = tpch.q1(ts)
    assert _rows(got.columns) == _rows(
        [want[k] for k in torch_plans.Q1_COLUMNS])


def test_fused_gate_default_threshold(stores, monkeypatch):
    """Unset, the gate fuses only at FUSED_AUTO_ROWS (the JAX engine's
    24M-row default); the environment forces it either way."""
    monkeypatch.delenv("MPLAN2VDL_FUSED_AGG", raising=False)
    ts, tcfg, _, _ = stores[SEEDS[0]]
    vexps = tlower.plan_to_vexps(torch_plans.PLAN_Q1, tcfg)
    assert tlower.FUSED_AUTO_ROWS == 24_000_000
    assert not tlower.CompiledQuery(tcfg, vexps, ts, device="cpu").families
    monkeypatch.setattr(tlower, "FUSED_AUTO_ROWS", 1000)
    assert tlower.CompiledQuery(tcfg, vexps, ts, device="cpu").families
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "0")
    assert not tlower.CompiledQuery(tcfg, vexps, ts, device="cpu").families


def test_decoded_matches_jax(stores):
    ts, tcfg, js, jcfg = stores[SEEDS[0]]
    got = tlower.compile_plan_text(torch_plans.PLAN_Q1, tcfg, ts,
                                   device="cpu")().decoded(ts)
    want = jlower.CompiledQuery(jcfg, jlower.plan_to_vexps(
        torch_plans.PLAN_Q1, jcfg), js)().decoded(js)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_outside_slice_raises(stores):
    """A node of a kind the evaluator does not know fails loudly, naming
    the kind."""
    import dataclasses

    import torch

    from mplan2vdl_tpu_torch import vir as tV

    @dataclasses.dataclass(frozen=True)
    class UnknownNode:
        arg: tV.Vexp

    ts, tcfg, _, _ = stores[SEEDS[0]]
    q = tV.load_raw(tcfg, ("lineitem", "l_quantity"))
    v = dataclasses.replace(q, vx=UnknownNode(arg=q), skey=-1)
    c = tlower.Compiler(ts, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="UnknownNode"):
        c.trace([v], {})


@pytest.mark.parametrize("plan,decode", [("q1", True),
                                         ("filter_project", False)])
def test_cli_run_matches_jax(tmp_path, capsys, plan, decode):
    from mplan2vdl_tpu import cli as jcli
    from mplan2vdl_tpu_torch import cli as tcli

    path = tmp_path / "plan.mplan"
    path.write_text(PLANS[plan])
    args = ["run", str(path), "--sf", "0.005", "--seed", "3", "--cpu"]
    args += ["--decode"] if decode else []
    tcli.main(args)
    got = capsys.readouterr().out
    jcli.main(args)
    want = capsys.readouterr().out
    assert got == want and got.count("\n") > 1
