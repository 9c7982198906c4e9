"""The port's plan distributor (``parallel/auto.py``) against the JAX
package's, over the in-code plans of ``torch_plans.AUTO_PLANS``.

Worlds of 4 and 1 gloo ranks (``torch_dist_cases.Ranks``, started once for
the module) run ``auto.distribute`` on every plan over a generated store
(``torch_auto_cases.CLI_SF``, ``CLI_SEED``); each test runs the same plan
through the JAX ``auto.distribute`` on a mesh of as many CPU devices.
Every rank must return JAX's rows (as multisets: the engines may order
join pairs within equal keys differently; ordered plans in order), JAX's
``describe()`` text or ``NotDistributable`` text, and the single-device
port's rows.  TPC-H Q17 distributes in the port; the JAX group stage
raises on it (a fault of the reference, named in its test), and so does
it on PLAN_DENSE_JOIN, a join of the same shape.  The plans
chip_smoke phase 8 runs for their partitioned joins take them as JAX
does (the hot join's heavy keys included).  Q13 and the
self-join run again with MPLAN2VDL_NO_PART_JOIN=1, and a world of 8 ranks runs
plans over a store whose tables leave its last ranks with empty windows
(``torch_auto_cases.SMALL_CASES``) against a JAX mesh of 8 devices.
"""

import os

import numpy as np
import pytest

import chip_smoke
import torch_auto_cases as A
import torch_dist_cases as C
import torch_plans

WORLDS = (4, 1)
PLANS = sorted(torch_plans.AUTO_PLANS)
# plans whose distribution the JAX group stage raises on (see
# test_q17_distributes_where_jax_raises)
JAX_RAISES = ("q17", "dense_join")
# plans whose row order the plan fixes (a rowset in fact-row order, ORDER BY
# without ties)
IN_ORDER = ("filter_project", "q4", "q16")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    worlds = {w: C.Ranks("auto_cli", w,
                         str(tmp_path_factory.mktemp(f"auto_cli{w}")))
              for w in WORLDS}
    yield worlds
    for r in worlds.values():
        r.close()


@pytest.fixture(scope="module")
def jax_side():
    """plan -> world -> ("rows", cols, describe, heavy plan) | ("nd",
    text) | ("error", exception), computed on first use."""
    from mplan2vdl_tpu.engine import datagen
    from mplan2vdl_tpu.engine.lower import plan_to_vexps

    st = datagen.generate(sf=A.CLI_SF, seed=A.CLI_SEED)
    cfg = st.make_catalog()
    cache = {}

    def get(plan, world, no_part_join=False):
        import jax
        from mplan2vdl_tpu.engine.lower import _children
        from mplan2vdl_tpu.parallel import auto, dist

        key = (plan, world, no_part_join)
        if key not in cache:
            mesh = dist.make_mesh(jax.devices()[:world])
            vexps = plan_to_vexps(torch_plans.AUTO_PLANS[plan], cfg)
            if no_part_join:
                os.environ["MPLAN2VDL_NO_PART_JOIN"] = "1"
            try:
                dq = auto.distribute(cfg, st, vexps, mesh)
                cols = [c for _, _, c in dq()]
                cache[key] = ("rows", cols, A.canon_describe(dq, _children),
                              A.heavy_plan(dq.part_joins))
            except auto.NotDistributable as e:
                cache[key] = ("nd", str(e))
            except RuntimeError as e:
                cache[key] = ("error", e)
            finally:
                os.environ.pop("MPLAN2VDL_NO_PART_JOIN", None)
        return cache[key]

    return get


def _rows(cols):
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))


def _cols(res, prefix):
    return [res[f"{prefix}{i}"] for i in range(int(res["ncols"]))]


def _same(got, want, in_order):
    assert _rows(got) == _rows(want)
    if in_order:
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(np.asarray(g, np.int64),
                                          np.asarray(w, np.int64))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", [p for p in PLANS if p not in JAX_RAISES])
def test_rows_match_jax(ranks, jax_side, plan, world):
    """Every rank's rows are JAX's, and the single-device port's."""
    want = jax_side(plan, world)
    assert want[0] == "rows", want
    for res in ranks[world].case(f"cli_{plan}"):
        assert str(res["nd"]) == ""
        got = _cols(res, "c")
        assert len(got) == len(want[1])
        _same(got, want[1], plan in IN_ORDER)
        _same(got, _cols(res, "s"), plan in IN_ORDER)
        assert len(got[0]) > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", [p for p in PLANS if p not in JAX_RAISES])
def test_describe_matches_jax(ranks, jax_side, plan, world):
    """The distribution plan prints as JAX's, partitioned joins' exact
    capacities and pair counts included (their skeys as places in the
    DAG: interning numbers depend on what the process built before)."""
    want = jax_side(plan, world)
    for res in ranks[world].case(f"cli_{plan}"):
        assert str(res["describe"]) == want[2]
    if plan == "q13":  # the dim-frame shuffle join over orders
        assert "partitioned shuffle join" in want[2]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", sorted(torch_plans.AUTO_PATHS))
def test_partitioned_paths_match_jax(ranks, jax_side, plan, world):
    """The plans of phase 8 that must take a partitioned shuffle join take
    it as JAX does, with the right frame torch_plans.AUTO_PATHS names:
    the hot join's heavy-key round finds JAX's heavy keys, build counts
    and capacities, leaving keys with pairs in the exchange; the nation
    count shards orders as an outer right frame; the self-join has no
    heavy key."""
    from mplan2vdl_tpu_torch.engine import datagen

    want = jax_side(plan, world)
    assert want[0] == "rows", want
    assert torch_plans.AUTO_PATHS[plan] in want[2]
    for res in ranks[world].case(f"cli_{plan}"):
        assert str(res["heavy_plan"]) == want[3]
        assert int(res["part_joins"]) == 1
        assert str(res["part_tables"]) == (
            "orders" if plan == "q13_nation" else "fact")
        assert str(res["part_outer"]) == str(plan == "q13_nation")
        assert int(res["heavy"]) == (plan == "hot_join")
    if plan != "hot_join":
        return
    sides = torch_plans.hot_join_sides(datagen.generate(sf=A.CLI_SF,
                                                       seed=A.CLI_SEED))
    paired = set(sides["keys"][sides["lc"].sum(0) * sides["rc"] > 0].tolist())
    hk = {int(k) for k in want[3].split()[0][3:].split(",")} & paired
    assert hk and paired - hk


@pytest.mark.parametrize("world", WORLDS)
def test_q17_distributes_where_jax_raises(ranks, jax_side, world):
    """TPC-H Q17 (a join against the per-part average, above the
    innermost folds): the JAX group stage builds a Compiler without the
    join sizes and raises ``JoinIndex size not resolved``
    (mplan2vdl_tpu/parallel/auto.py:1583, :1638).  The port's eager
    compiler sizes the join itself: every rank returns the single-device
    port's rows, and at Q17_SF (where parts pass its filter)
    torch_plans.oracle_q17's."""
    from mplan2vdl_tpu_torch.engine import datagen

    want = jax_side("q17", world)
    assert want[0] == "error", want
    assert "JoinIndex size not resolved" in str(want[1])
    for res in ranks[world].case("cli_q17"):
        assert str(res["nd"]) == ""
        _same(_cols(res, "c"), _cols(res, "s"), True)
        assert "group domain:" in str(res["describe"])
    oracle = torch_plans.oracle_q17(datagen.generate(sf=A.Q17_SF,
                                                    seed=A.CLI_SEED))
    assert int(oracle[0][0]) > 0
    for res in ranks[world].case("q17_rows"):
        assert str(res["nd"]) == ""
        got = _cols(res, "c")
        _same(got, _cols(res, "s"), True)
        _same(got, oracle, True)


@pytest.mark.parametrize("world", WORLDS)
def test_dense_join_distributes_where_jax_raises(ranks, jax_side, world):
    """PLAN_DENSE_JOIN (lineitem against its per-l_shipdate average, Q17's
    decorrelated shape) meets the same fault of the JAX group stage as
    Q17; every rank of the port returns the single-device port's rows and
    torch_plans.oracle_dense_join's."""
    from mplan2vdl_tpu_torch.engine import datagen

    want = jax_side("dense_join", world)
    assert want[0] == "error", want
    assert "JoinIndex size not resolved" in str(want[1])
    oracle = torch_plans.oracle_dense_join(datagen.generate(
        sf=A.CLI_SF, seed=A.CLI_SEED))
    assert len(oracle[0]) > 1
    for res in ranks[world].case("cli_dense_join"):
        assert str(res["nd"]) == ""
        got = _cols(res, "c")
        _same(got, _cols(res, "s"), False)
        _same(got, oracle, False)
        assert "group domain:" in str(res["describe"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", ["q13", "self_join"])
def test_no_part_join_replicates_the_right_side(ranks, jax_side, plan,
                                                world):
    """With MPLAN2VDL_NO_PART_JOIN=1 (tests/test_auto_dist.py's switch) the
    partitioned joins give way to replicated right sides: Q13's orders
    ships whole instead of sharded, and the self-join's right side becomes
    its one full-width region.  The rows stay the single-device port's,
    and rows and plan text are JAX's under the same switch."""
    for part, rep in zip(ranks[world].case(f"cli_{plan}"),
                         ranks[world].case(f"nopart_{plan}"), strict=True):
        assert str(part["nd"]) == str(rep["nd"]) == ""
        assert int(part["part_joins"]) > 0 and int(rep["part_joins"]) == 0
        assert "partitioned shuffle join" not in str(rep["describe"])
        _same(_cols(rep, "c"), _cols(rep, "s"), False)
        if plan == "q13":  # orders ships sharded, else replicated
            assert str(part["part_tables"]) == "orders"
            assert str(part["part_outer"]) == "True"
            assert str(part["dim_loads"]) == ""
            assert str(part["part_loads"]).startswith("orders.")
            assert "orders." in str(rep["dim_loads"])
            assert str(rep["part_loads"]) == ""
        else:  # the join is the plan's only full-width region
            assert str(part["part_tables"]) == "fact"
            assert str(part["extra_full"]) == ""
            assert str(rep["extra_full"]) != ""
    want = jax_side(plan, world, no_part_join=True)
    assert want[0] == "rows", want
    for rep in ranks[world].case(f"nopart_{plan}"):
        _same(_cols(rep, "c"), want[1], False)
        assert str(rep["describe"]) == want[2]


# ---------------------------------------- more ranks than a table has rows
@pytest.fixture(scope="module")
def small_ranks(tmp_path_factory):
    r = C.Ranks("auto_small", A.SMALL_WORLD,
                str(tmp_path_factory.mktemp("auto_small")))
    yield r
    r.close()


@pytest.fixture(scope="module")
def small_jax():
    """case -> (("rows", rows, describe) | ("nd", text), oracle rows or
    None) from the JAX distributor on a mesh of SMALL_WORLD devices."""
    import jax

    import mplan2vdl_tpu
    from mplan2vdl_tpu.engine import datagen
    from mplan2vdl_tpu.engine.lower import _children
    from mplan2vdl_tpu.oracle import relinterp
    from mplan2vdl_tpu.parallel import auto, dist

    st = A.make_store(datagen, "small")
    cfg = st.make_catalog()
    mesh = dist.make_mesh(jax.devices()[:A.SMALL_WORLD])
    cache = {}

    def get(case):
        if case not in cache:
            vexps, m = A.case_vexps(mplan2vdl_tpu, case, st, cfg)
            oracle = None if m is None else [
                a for _, a in relinterp.run_oracle(st, m).cols]
            try:
                dq = auto.distribute(cfg, st, vexps, mesh)
                got = ("rows", [c for _, _, c in dq()],
                       A.canon_describe(dq, _children))
            except auto.NotDistributable as e:
                got = ("nd", str(e))
            cache[case] = (got, oracle)
        return cache[case]

    return get


def test_small_store_leaves_ranks_empty():
    """The small store's tables leave the last ranks of the world with
    empty windows: the nation fact's last rank, the supplier fact's and
    the partitioned supplier's last three."""
    from mplan2vdl_tpu_torch.engine import datagen

    st = A.make_store(datagen, "small")
    w = A.SMALL_WORLD
    for table, empty in (("nation", 1), ("supplier", 3), ("customer", 0)):
        n = st.table_count((table,))
        rows = -(-n // w)
        assert sum(min(max(n - r * rows, 0), rows) == 0
                   for r in range(w)) == empty, table


@pytest.mark.parametrize("case", A.SMALL_CASES)
def test_more_ranks_than_rows_match_jax(small_ranks, small_jax, case):
    """Over more ranks than the tables have rows, every rank reaches every
    collective and returns JAX's rows and plan text, the single-device
    port's rows and the relational oracle's; each of these plans
    distributes, the joins of all but small_plain partitioned."""
    want, oracle = small_jax(case)
    assert want[0] == "rows", want
    for res in small_ranks.case(case):
        assert str(res["nd"]) == ""
        got = _cols(res, "c")
        _same(got, want[1], False)
        _same(got, _cols(res, "s"), False)
        if oracle is not None:
            _same(got, oracle, False)
        assert str(res["describe"]) == want[2]
        assert (int(res["part_joins"]) == 0) == (case == "small_plain")
    if case in ("small_outer", "small_rowset"):
        assert "right=supplier OUTER" in want[2]


# ------------------------------------------------------ chip_smoke phase 8
def _auto_smoke(monkeypatch):
    """A ``Smoke`` on the CPU over an SF 0.01 store, with no-op CUDA
    timing calls and the compaction and gather counted through wrappers
    (the plain versions count nothing), so the phase's launch check
    runs too."""
    import types

    import torch

    from mplan2vdl_tpu_torch.engine import datagen
    from mplan2vdl_tpu_torch.engine import lower
    from mplan2vdl_tpu_torch.engine.kernels import compact, sorted_gather

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)

    def counted(fn, mod, attr):
        def call(*a, **k):
            setattr(mod, attr, getattr(mod, attr) + 1)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(lower, "compact_positions", counted(
        lower.compact_positions, compact, "launches"))
    monkeypatch.setattr(lower, "gather_many", counted(
        lower.gather_many, sorted_gather, "launches"))
    s = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    s.torch, s.dev, s.smi = torch, torch.device("cpu"), "cpu"
    s.args = types.SimpleNamespace(sf=0.01, seed=1, profile=None)
    s.records = {"queries": []}
    s.st = datagen.generate(sf=0.01, seed=1)
    s.cfg = s.st.make_catalog()
    return s


def test_chip_smoke_auto_phase_on_cpu(tmp_path, monkeypatch, capsys):
    """Phase 8 of chip_smoke.py dry-run on the CPU (one gloo rank, SF
    0.01): every plan distributes (at this scale PLAN_DISTINCT_WIDE's key
    fits), passes its oracle and prints a timed ``{"auto": ...}`` line;
    the hot join's heavy-key round leaves light keys, and the nation count
    partitions orders."""
    import json

    import torch

    s = _auto_smoke(monkeypatch)
    s.dist_phase(coordinator="file://" + str(tmp_path / "store"),
                 phases=("auto",))
    assert not torch.distributed.is_initialized()
    out = capsys.readouterr().out.splitlines()
    cells = [json.loads(ln) for ln in out if ln.startswith('{"auto": ')]
    assert [c["auto"] for c in cells] == list(torch_plans.AUTO_PLANS)
    for c in cells:
        assert "not_distributable" not in c, c
        assert c["world_size"] == 1 and len(c["warm_ms"]) == 3
        assert c["rows_out"] > 0 and c["describe"][0].startswith(
            "fact table: ")
    by = {c["auto"]: c for c in cells}
    (hot,) = by["hot_join"]["part_joins"]
    assert hot["right"] == "fact frame" and hot["n_heavy"] > 0
    assert hot["light_keys"] and hot["pairs"] == hot["oracle_pairs"]
    (nation,) = by["q13_nation"]["part_joins"]
    assert nation["right"] == "orders" and nation["outer"]
    end = json.loads(next(ln for ln in out if '"auto_phase_s"' in ln))
    assert end["auto_launches"]["compact"] > 0
    assert end["auto_launches"]["gather"] > 0


@pytest.mark.parametrize("expected", [{}, {"q6": "other text"},
                                      {"q6": "refused"}])
def test_chip_smoke_auto_phase_fails_on_a_refusal(tmp_path, monkeypatch,
                                                  capsys, expected):
    """A plan that auto.distribute refuses fails phase 8 unless
    EXPECTED_NOT_DISTRIBUTABLE names it with the refusal's text; then
    its ``{"auto": ...}`` line holds the text and the phase goes on."""
    import json

    from mplan2vdl_tpu_torch.parallel import auto

    distribute, calls = auto.distribute, []

    def refuse_first(*args):  # the first plan, q6
        calls.append(1)
        if len(calls) == 1:
            raise auto.NotDistributable("refused")
        return distribute(*args)

    monkeypatch.setattr(auto, "distribute", refuse_first)
    monkeypatch.setattr(torch_plans, "AUTO_PLANS", {
        k: torch_plans.AUTO_PLANS[k] for k in ("q6", "q3")})
    monkeypatch.setattr(torch_plans, "EXPECTED_NOT_DISTRIBUTABLE", expected)
    s = _auto_smoke(monkeypatch)
    store = "file://" + str(tmp_path / "store")
    if expected.get("q6") != "refused":
        with pytest.raises(AssertionError,
                           match="q6 is not distributable: refused"):
            s.dist_phase(coordinator=store, phases=("auto",))
        return
    s.dist_phase(coordinator=store, phases=("auto",))
    cells = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"auto": ')]
    assert [c.get("not_distributable") for c in cells] == ["refused", None]
