"""chip_smoke.py's phase 9 (the plan census on the card) and the four
phase-4 plans of the paths no other plan reaches at SF10, dry-run on the
CPU.

* The census module (tests/torch_census_cases.py) holds copies of the JAX
  tests' constants and plan texts: they are held equal to the originals,
  and the null plans' SQL is held against the port's rows.
* Phase 9 at SF 0.002, on a ``Smoke`` built by ``__new__`` on the CPU,
  with two oracle worker processes; the engine kernels' wrappers count
  their calls (their plain versions count nothing on the CPU), so the
  phase's launch check runs too.
* Phase 4 at SF 0.01 the same way: every run passes its oracle, and each
  of the four new plans takes its path as its spy sees it.  The two-sort
  fallback of count(DISTINCT) depends on scale (its packed key passes
  2**62 only from about SF1), so ``lower.PACK_LIMIT`` is lowered to 2**40
  for the run: PLAN_DISTINCT_WIDE's key needs 49 bits at SF 0.01, every
  other distinct plan of the phase fewer than 40.
* The four new plans through the port and the JAX engine, with the port's
  path spies, and against their numpy oracles.
* Phase 4's Semisort run (a hand-built VIR DAG) at SF 0.01: it passes,
  and a wrong permutation fails it.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import chip_smoke
import mplan2vdl_tpu_torch
import test_distinct
import test_fuzz
import torch_census_cases as census
import torch_plans
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu_torch.engine import datagen, lower
from mplan2vdl_tpu_torch.engine.kernels import (compact, exprfold,
                                                multiagg, multiagg_mxu,
                                                scatter, segred,
                                                sorted_gather)

NEW_PLANS = {"PLAN_DENSE_JOIN": torch_plans.oracle_dense_join,
             "PLAN_DISTINCT_DENSE": torch_plans.oracle_distinct_dense,
             "PLAN_DISTINCT_WIDE": torch_plans.oracle_distinct_wide,
             "PLAN_Q4_ALL": torch_plans.oracle_q4_all}


def test_census_copies_equal_the_jax_tests():
    assert census.LI == test_fuzz.LI
    assert census.VALUE_COLS == test_fuzz.VALUE_COLS
    assert census.KEY_COLS == test_fuzz.KEY_COLS
    assert census.PLAN_DENSE == test_distinct.PLAN_DENSE
    assert census.PLAN_SPARSE == test_distinct.PLAN_SPARSE


@pytest.fixture(scope="module")
def null_store():
    """tests/test_null_semantics.py's store: SF 0.01, seed 7."""
    st = datagen.generate(sf=0.01, seed=7)
    return st, st.make_catalog(), census.null_db(st)


@pytest.mark.parametrize("which", census.NULL_PLANS)
def test_null_sql_matches_the_port(null_store, which):
    st, cfg, db = null_store
    plan = census.build(mplan2vdl_tpu_torch, "null", which, st, cfg)
    res = lower.CompiledQuery(cfg, _vexps(plan, cfg), st, device="cpu")()
    tp = np.asarray(st.columns[("orders", "o_totalprice")])
    want = census.sql_rows(db, census.null_sql(which, tp))
    assert want and census.rows(res.columns) == want


def _vexps(plan, cfg):
    from mplan2vdl_tpu_torch import passes, vir

    return passes.engine_passes(vir.vexps_from_mplan(plan, cfg))


def _count_launches(monkeypatch):
    """The engine kernels' wrappers, as lower.py calls them, counting each
    call on their modules' launch counters (a small-table gather on
    ``small_launches``)."""
    def counted(fn, mod, attr, small_attr=None):
        def call(*a, **k):
            at = small_attr if small_attr and k.get("small") else attr
            setattr(mod, at, getattr(mod, at) + 1)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(lower, "compact_positions", counted(
        lower.compact_positions, compact, "launches"))
    monkeypatch.setattr(lower, "gather_many", counted(
        lower.gather_many, sorted_gather, "launches", "small_launches"))
    monkeypatch.setattr(lower, "fused_group_aggregate", counted(
        lower.fused_group_aggregate, multiagg, "launches"))
    monkeypatch.setattr(lower, "fused_group_aggregate_mxu", counted(
        lower.fused_group_aggregate_mxu, multiagg_mxu, "launches"))
    monkeypatch.setattr(lower, "expr_fold", counted(
        lower.expr_fold, exprfold, "launches"))
    monkeypatch.setattr(lower, "group_ids", counted(
        lower.group_ids, exprfold, "group_launches"))
    monkeypatch.setattr(lower, "monotone_scatter", counted(
        lower.monotone_scatter, scatter, "launches"))
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def _smoke(sf):
    s = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    s.torch, s.dev, s.smi = torch, torch.device("cpu"), "cpu"
    s.args = types.SimpleNamespace(sf=sf, seed=1, profile=None)
    s.records = {"queries": [], "kernel_checks": []}
    return s


def test_chip_smoke_census_phase_on_cpu(monkeypatch, capsys):
    _count_launches(monkeypatch)
    s = _smoke(0.002)
    s.census_phase(sf=0.002, workers=2)
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(ln) for ln in out if ln.startswith('{"census": ')]
    assert [ln["census"] for ln in lines] == [
        "fuzz", "fuzz_fused", "fuzz_mxu", "ordered", "null", "corners",
        "semi_anti", "distinct", "tpch"]
    want = {"fuzz": 40, "ordered": 40, "null": 7, "corners": 5,
            "semi_anti": 2, "distinct": 2,
            "tpch": len(torch_plans.AUTO_PLANS) - len(torch_plans.CENSUS_SKIP)}
    for ln in lines:
        family = "fuzz" if ln["census"].startswith("fuzz") else ln["census"]
        assert ln["plans"] == ln["checked"] == want[family], ln
        assert ln["sf"] == 0.002 and ln["cut"] == chip_smoke.CENSUS_CUT
    by = {ln["census"]: ln for ln in lines}
    assert by["fuzz"]["launches"]["multiagg"] == 0
    assert by["fuzz_fused"]["launches"]["multiagg"] > 0
    assert by["fuzz_mxu"]["launches"]["multiagg_mxu"] > 0
    assert by["fuzz"]["oracle_s"] > 0 and by["fuzz_fused"]["oracle_s"] == 0
    end = json.loads(next(ln for ln in out if '"census_phase_s"' in ln))
    assert end["plans"] == sum(want.values())
    assert end["runs"] == end["plans"] + 2 * 40
    assert all(v > 0 for v in end["census_launches"].values()), end


def test_chip_smoke_census_phase_fails_on_a_wrong_row(monkeypatch):
    """A row the oracle does not give ends the phase: here the card's
    last column is off by one in every plan, so the first plan fails."""
    _count_launches(monkeypatch)
    call = lower.CompiledQuery.__call__

    def off_by_one(cq):
        res = call(cq)
        res.columns[-1] = res.columns[-1] + 1
        return res

    monkeypatch.setattr(lower.CompiledQuery, "__call__", off_by_one)
    with pytest.raises(AssertionError, match="census fuzz fuzz0: the card"):
        _smoke(0.002).census_phase(sf=0.002, workers=1)


def test_chip_smoke_query_phase_on_cpu(monkeypatch, capsys):
    _count_launches(monkeypatch)
    monkeypatch.setattr(lower, "PACK_LIMIT", 2**40)
    s = _smoke(0.01)
    s.st = datagen.generate(sf=0.01, seed=1)
    s.cfg = s.st.make_catalog()
    s.n = s.st.table_count(("lineitem",))
    s.n_orders = s.st.table_count(("orders",))
    s.query_phase()
    out = capsys.readouterr().out.splitlines()
    runs = [json.loads(ln) for ln in out if ln.startswith('{"query": ')]
    # the fifteen runs and the four new ones; below the fused gate's rows
    # Q1 runs forced-fused besides
    assert len(runs) == 20 and runs[-1]["query"] == torch_plans.Q4_ALL_RUN
    paths = {p["path"]: p for p in (json.loads(ln) for ln in out
                                    if ln.startswith('{"path": '))}
    assert list(paths) == [torch_plans.DENSE_JOIN_RUN,
                           torch_plans.DISTINCT_DENSE_RUN,
                           torch_plans.DISTINCT_WIDE_RUN,
                           torch_plans.Q4_ALL_RUN, chip_smoke.SEMISORT_RUN]
    # the join counts are the join log's: one entry per side of the join
    dj = paths[torch_plans.DENSE_JOIN_RUN]
    assert dj["dense_joins"] == len(dj["joins"]) == 2
    assert dj["merge_joins"] == 0
    assert {j["path"] for j in dj["joins"]} == {"dense"}
    assert paths[torch_plans.DISTINCT_DENSE_RUN]["distinct_domains"] == [8]
    wide = paths[torch_plans.DISTINCT_WIDE_RUN]["pair_sorts"]
    assert [p["packed"] for p in wide] == [False] and wide[0][
        "key_bits"] > 40
    rs = paths[torch_plans.Q4_ALL_RUN]["repeat_scatters"]
    assert rs[0]["n"] > s.n // 2 > rs[0]["distinct"]
    # the gather census sees every gather.cu launch of the runs, in
    # classes of each order
    census = json.loads(next(ln for ln in out
                             if ln.startswith('{"gather_census": ')))
    total = json.loads(next(ln for ln in out
                            if ln.startswith('{"main_path_launches": ')))
    assert census["launches"] == total["main_path_launches"]["gather"] > 0
    assert sum(c["launches"] for c in census["gather_census"]) == census[
        "launches"]
    assert {c["order"] for c in census["gather_census"]} == {
        "consecutive", "ascending", "unordered"}


def _semisort_smoke():
    s = _smoke(0.01)
    s.st = datagen.generate(sf=0.01, seed=1)
    s.cfg = s.st.make_catalog()
    return s


def test_chip_smoke_semisort_run_on_cpu(monkeypatch, capsys):
    """Phase 4's Semisort run at SF 0.01: the fold's buffer has padding
    past its valid rows, the permutation is the stable argsort of the
    whole buffer, and the run prints one timed ``{"path": "Semisort"}``
    line."""
    _count_launches(monkeypatch)
    s = _semisort_smoke()
    s.semisort_run()
    out = capsys.readouterr().out.splitlines()
    (rec,) = [json.loads(ln) for ln in out if ln.startswith('{"path": ')]
    orders = len(np.unique(s.st.columns[("lineitem", "l_orderkey")]))
    assert rec["path"] == chip_smoke.SEMISORT_RUN
    assert rec["valid"] == orders and rec["padding"] == rec["n"] - orders > 0
    assert len(rec["ms"]) == 5 and rec["median_ms"] > 0
    assert s.records["semisort"] == rec


def test_chip_smoke_semisort_run_fails_on_a_wrong_permutation(monkeypatch):
    """A permutation that is not the stable argsort ends the run: here the
    Semisort node's permutation comes back reversed."""
    from mplan2vdl_tpu_torch import vir

    _count_launches(monkeypatch)
    evaluate = lower.Compiler._eval

    def reversed_semisort(c, v):
        out = evaluate(c, v)
        if isinstance(v.vx, vir.Semisort):
            out = lower.Val(data=out.data.flip(0), valid=out.valid,
                            length=out.length)
        return out

    monkeypatch.setattr(lower.Compiler, "_eval", reversed_semisort)
    with pytest.raises(AssertionError, match="Semisort: the permutation"):
        _semisort_smoke().semisort_run()


def test_profile_names_each_gather_by_the_first_runs_class(
        monkeypatch, tmp_path):
    """Under ``--profile`` each gather of the warm call is charged to the
    census class of the first run's gather in its place: a call of
    another shape there, or a different number of calls, fails."""
    _count_launches(monkeypatch)
    s = _smoke(0.01)
    s.args.profile = str(tmp_path)
    s.st = datagen.generate(sf=0.01, seed=1)
    cfg = s.st.make_catalog()
    cq = lower.CompiledQuery(cfg, lower.plan_to_vexps(torch_plans.PLAN_Q3,
                                                      cfg), s.st,
                             device="cpu")
    first, gather_many = [], lower.gather_many

    def spy(srcs, pos, valid, small=False):
        if not small:
            first.append(chip_smoke.gather_class(srcs, pos, valid))
        return gather_many(srcs, pos, valid, small=small)

    monkeypatch.setattr(lower, "gather_many", spy)
    cq.run()
    monkeypatch.setattr(lower, "gather_many", gather_many)
    assert first
    calls = list(enumerate(first))
    rec = s.profile("Q3", cq, calls)
    assert lower.gather_many is gather_many and rec["gather_classes"] == {}
    swapped = list(calls)
    swapped[0] = (0, (9,) + first[0][1:])
    with pytest.raises(AssertionError, match="gather 0 .* is not the first"):
        s.profile("Q3", cq, swapped)
    with pytest.raises(AssertionError, match="made .* gathers, the first"):
        s.profile("Q3", cq, calls + [calls[-1]])
    assert lower.gather_many is gather_many


def test_engine_seam_restores_what_it_wraps(monkeypatch):
    """``engine_seam`` puts each wrapper in its name's place, a Compiler
    method's too, and sets the switches while it is open; it restores both
    on exit, also when the block raises."""
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "0")
    monkeypatch.delenv("MPLAN2VDL_MXU_AGG", raising=False)
    gather, distinct = lower.gather_many, lower.Compiler._eval_fold_distinct
    seen = []

    def spy(fn, *a, **k):
        seen.append(fn.__name__)
        return fn(*a, **k)

    st = datagen.generate(sf=0.002, seed=1)
    cfg = st.make_catalog()
    cq = lower.CompiledQuery(cfg, lower.plan_to_vexps(
        torch_plans.PLAN_DISTINCT_DENSE, cfg), st, device="cpu")
    env = {"MPLAN2VDL_FUSED_AGG": None, "MPLAN2VDL_MXU_AGG": "1"}
    with pytest.raises(RuntimeError, match="in the block"):
        with chip_smoke.engine_seam(
                wrap={"gather_many": spy, "Compiler._eval_fold_distinct": spy},
                env=env):
            assert "MPLAN2VDL_FUSED_AGG" not in os.environ
            assert os.environ["MPLAN2VDL_MXU_AGG"] == "1"
            lower.gather_many([torch.arange(5)], torch.tensor([1, 3]), 2)
            cq()
            raise RuntimeError("in the block")
    assert seen[0] == "gather_many" and "_eval_fold_distinct" in seen
    assert lower.gather_many is gather
    assert lower.Compiler._eval_fold_distinct is distinct
    assert os.environ["MPLAN2VDL_FUSED_AGG"] == "0"
    assert "MPLAN2VDL_MXU_AGG" not in os.environ


def test_query_phase_refuses_a_path_not_taken():
    """A merge join in the dense-join run, or a packed pair sort in the
    two-sort run, fails the run's path check."""
    s = _smoke(0.01)
    s.n = 60338
    rec = {"dense_joins": 0, "merge_joins": 1, "distinct_domains": [],
           "pair_sorts": []}
    with pytest.raises(AssertionError, match="did not take its path"):
        s.check_path(torch_plans.DENSE_JOIN_RUN, rec,
                     [{"side": "left", "path": "merge"}], [])
    with pytest.raises(AssertionError, match="did not take its path"):
        s.check_path(torch_plans.DISTINCT_WIDE_RUN, dict(
            rec, pair_sorts=[{"packed": True}]), [], [])


@pytest.fixture(scope="module")
def stores():
    ts = datagen.generate(sf=0.01, seed=1)
    js = jdatagen.generate(sf=0.01, seed=1)
    return ts, ts.make_catalog(), js, js.make_catalog()


@pytest.mark.parametrize("plan", list(NEW_PLANS))
def test_new_plan_matches_jax_and_its_oracle(stores, monkeypatch, plan):
    ts, tcfg, js, jcfg = stores
    seen = {"dense": 0, "domains": [], "packed": [], "repeats": []}
    dense_join = lower.Compiler._dense_join
    fold_distinct = lower.Compiler._eval_fold_distinct
    sort_pairs = lower._sort_pairs
    repeat_scatter = lower.repeat_scatter

    def dense(c, *a, **k):
        out = dense_join(c, *a, **k)
        seen["dense"] += out is not None
        return out

    def distinct(c, vx, dt, domain, L_out):
        seen["domains"].append(domain)
        return fold_distinct(c, vx, dt, domain, L_out)

    def pairs(ids, vals, domain, vlo, vhi):
        seen["packed"].append((domain + 1) * (vhi - vlo + 1)
                              <= lower.PACK_LIMIT)
        return sort_pairs(ids, vals, domain, vlo, vhi)

    def repeat(p, src, L):
        seen["repeats"].append((p.shape[0], L))
        return repeat_scatter(p, src, L)

    monkeypatch.setattr(lower.Compiler, "_dense_join", dense)
    monkeypatch.setattr(lower.Compiler, "_eval_fold_distinct", distinct)
    monkeypatch.setattr(lower, "_sort_pairs", pairs)
    monkeypatch.setattr(lower, "repeat_scatter", repeat)
    # the two-sort fallback from SF 0.01 on (see the module docstring)
    monkeypatch.setattr(lower, "PACK_LIMIT", 2**40)
    text = getattr(torch_plans, plan)
    tq = lower.CompiledQuery(tcfg, lower.plan_to_vexps(text, tcfg), ts,
                             device="cpu")
    got = tq()
    want = jlower.CompiledQuery(jcfg, jlower.plan_to_vexps(text, jcfg),
                                js)()
    assert census.rows(got.columns) == census.rows(want.columns)
    assert len(got.columns[0]) > 0
    assert torch_plans.same_rows(got.columns, NEW_PLANS[plan](ts))
    if plan == "PLAN_DENSE_JOIN":
        assert seen["dense"] == 1
        assert {j["path"] for j in tq.join_log} == {"dense"}
    elif plan == "PLAN_DISTINCT_DENSE":
        assert seen["domains"] and max(seen["domains"]) <= \
            segred.SMALL_DOMAIN
        assert seen["packed"] == [True]
    elif plan == "PLAN_DISTINCT_WIDE":
        assert seen["domains"][0] > segred.SMALL_DOMAIN
        assert seen["packed"] == [False]
    else:
        (n, L), = seen["repeats"]
        assert n > ts.table_count(("lineitem",)) // 2 and L == \
            ts.table_count(("orders",))
