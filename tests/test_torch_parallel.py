"""The port's distribution primitives (``parallel/multihost.py``,
``dist.py``, ``shuffle_agg.py``) against the JAX package's.

Worlds of 4 and 1 gloo ranks (``torch_dist_cases.Ranks``, started once for
the module) run every case of ``tests/test_parallel.py`` and
``tests/test_shuffle_agg.py``; each test runs the same inputs through the
JAX function on a mesh of as many CPU devices and holds the port's result
exactly equal: DistQuery's dicts on every rank, shuffle_by_key's owner rows
rank by rank, ShuffleGroupBy's keys and values (and its overflow error).
"""

import numpy as np
import pytest
import torch

import torch_dist_cases as C

WORLDS = (4, 1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    worlds = {w: C.Ranks("parallel", w,
                         str(tmp_path_factory.mktemp(f"parallel{w}")))
              for w in WORLDS}
    yield worlds
    for r in worlds.values():
        r.close()


@pytest.fixture(scope="module")
def jax_store():
    from mplan2vdl_tpu.engine import datagen

    return datagen.generate(sf=C.STORE_SF, seed=C.STORE_SEED)


def _mesh(world):
    import jax
    from mplan2vdl_tpu.parallel import dist

    return dist.make_mesh(jax.devices()[:world])


def _put(mesh, arr):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(arr, NamedSharding(mesh, P("d")))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------------------- multihost
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_over_gloo_group(ranks, world):
    """Each rank's mesh names its rank, the world size, the CPU and the
    gloo backend; the default device is CUDA, which a CPU rank lacks."""
    for r, got in enumerate(ranks[world].case("mesh")):
        assert int(got["rank"]) == r
        assert int(got["size"]) == world
        assert str(got["device"]) == "cpu"
        assert str(got["backend"]) == "gloo"
        assert "no CUDA device" in str(got["default_device_error"])


def test_initialize_single_process_is_noop(monkeypatch):
    from mplan2vdl_tpu_torch.parallel import multihost

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is None
    assert multihost.initialize(num_processes=1) is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.data_mesh(device="cpu")


def test_initialize_refuses_without_coordinator_or_cuda(monkeypatch):
    """More than one process needs a coordinator; the default device is
    CUDA, so without a card it raises before any group starts."""
    from mplan2vdl_tpu_torch.parallel import multihost

    for var in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_backend_follows_device():
    from mplan2vdl_tpu_torch.parallel import dist

    assert dist.backend_for(torch.device("cuda")) == "nccl"
    assert dist.backend_for(torch.device("cpu")) == "gloo"


# ------------------------------------------------------------------ dist
def _jax_dist_query(world, store, which):
    from mplan2vdl_tpu.parallel import dist

    names, spec = C.DIST_QUERIES[which]
    cols = {c: store.columns[("lineitem", c)] for c in names}
    table = dist.ShardedTable.put(_mesh(world), cols)
    return dist.DistQuery(table=table, **spec(cols))()


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_q6(ranks, jax_store, world):
    from mplan2vdl_tpu.oracle import tpch

    want = _jax_dist_query(world, jax_store, "q6")
    assert want["revenue"].tolist() == tpch.q6(jax_store)["revenue"].tolist()
    for got in ranks[world].case("q6"):
        _assert_same(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_q1_groupby(ranks, jax_store, world):
    from mplan2vdl_tpu.oracle import tpch

    want = _jax_dist_query(world, jax_store, "q1")
    exp = tpch.q1(jax_store)
    assert sorted(want["__count"].tolist()) == sorted(
        exp["count_order"].tolist())
    assert sorted(want["sum_qty"].tolist()) == sorted(exp["sum_qty"].tolist())
    for got in ranks[world].case("q1"):
        _assert_same(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_wide_groupby(ranks, jax_store, world):
    """A domain above segred.SMALL_DOMAIN (the port's sorted path) against
    JAX's segment_sum and a numpy group-by."""
    from mplan2vdl_tpu_torch.engine.kernels import segred

    want = _jax_dist_query(world, jax_store, "wide")
    cols = {c: jax_store.columns[("lineitem", c)] for c in C.Q6_COLUMNS}
    spec = C.wide_query(cols)
    assert spec["domain"] > segred.SMALL_DOMAIN
    m = cols["l_discount"] >= 5
    ids = cols["l_shipdate"][m] - int(cols["l_shipdate"].min())
    np.testing.assert_array_equal(want["__group_id"], np.unique(ids))
    np.testing.assert_array_equal(
        want["qty"], np.bincount(ids, cols["l_quantity"][m].astype(
            np.int64))[want["__group_id"]].astype(np.int64))
    for got in ranks[world].case("wide"):
        _assert_same(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_shuffle_by_key(ranks, world):
    """Rank d's received rows are JAX's shard d, slot for slot."""
    import jax
    from mplan2vdl_tpu.parallel import dist

    keys, vals, key_hi = C.shuffle_by_key_inputs()
    mesh = _mesh(world)
    ko, vo = jax.jit(lambda k, v: dist.shuffle_by_key(mesh, k, v, key_hi))(
        _put(mesh, keys), _put(mesh, vals))
    ko, vo = np.asarray(ko), np.asarray(vo)
    per = -(-key_hi // world)
    kept = []
    for d, got in enumerate(ranks[world].case("shuffle_by_key")):
        np.testing.assert_array_equal(got["keys"], ko[d])
        np.testing.assert_array_equal(got["vals"], vo[d])
        live = got["keys"] < key_hi
        assert (got["keys"][live] // per == d).all()
        kept += zip(got["keys"][live].tolist(), got["vals"][live].tolist())
    assert sorted(kept) == sorted(zip(keys.tolist(), vals.tolist()))


# ----------------------------------------------------------- shuffle_agg
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", C.GROUPBY_CASES)
def test_shuffle_groupby(ranks, case, world):
    """The cases of tests/test_shuffle_agg.py (sum and min over a sparse
    domain, every row one key, every key in one owner's range) and a
    max/sum whose buckets overflow over four ranks: keys, values and the
    bucket capacity equal JAX's, or both raise the same error."""
    from mplan2vdl_tpu.parallel.shuffle_agg import ShuffleGroupBy

    keys, vals, ops, key_hi = C.groupby_inputs(case)
    mesh = _mesh(world)
    gb = ShuffleGroupBy(mesh=mesh, shard_rows=len(keys) // world,
                        key_hi=key_hi, ops=ops)
    try:
        gk, gv = gb(_put(mesh, keys), [_put(mesh, v) for v in vals])
        want = {"keys": gk, "cap": np.asarray(gb.cap)}
        want.update({f"v{i}": v for i, v in enumerate(gv)})
    except RuntimeError as e:
        want = {"error": np.asarray(str(e)), "cap": np.asarray(gb.cap)}
    assert ("error" in want) == (case == "max_overflow" and world > 1)
    if "error" not in want:  # and the numpy group-by
        uniq = np.unique(keys)
        np.testing.assert_array_equal(np.sort(want["keys"]), uniq)
    for got in ranks[world].case(f"groupby_{case}"):
        _assert_same(got, want)


# ------------------------------------------------------ chip_smoke phase 7
def test_chip_smoke_dist_phase_on_cpu(tmp_path, monkeypatch, capsys):
    """Phase 7 of chip_smoke.py dry-run on the CPU (one gloo rank, SF
    0.01): the four cells pass their oracles and print a timed line each;
    oracle_shuffle_groupby's first five columns are oracle_sparse_groupby's
    and its price columns a numpy group-by's."""
    import json
    import types

    import chip_smoke
    import torch_plans
    from mplan2vdl_tpu_torch.engine import datagen

    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    s = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    s.torch, s.dev, s.smi = torch, torch.device("cpu"), "cpu"
    s.args = types.SimpleNamespace(sf=0.01, seed=1, profile=None)
    s.records = {"dist": []}
    s.st = datagen.generate(sf=0.01, seed=1)
    s.dist_phase(coordinator="file://" + str(tmp_path / "store"))
    assert not torch.distributed.is_initialized()
    cells = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"dist": ')]
    assert [c["dist"] for c in cells] == [
        "DistQuery Q6", "DistQuery Q1 group-by", "ShuffleGroupBy",
        "ShuffleJoin"]
    for c in cells:
        assert c["backend"] == "gloo" and c["world_size"] == 1
        assert len(c["ms"]) == 5 and c["median_ms"] > 0

    want = torch_plans.oracle_shuffle_groupby(s.st)
    for g, w in zip(want[:5], torch_plans.oracle_sparse_groupby(s.st),
                    strict=True):
        np.testing.assert_array_equal(g, w)
    li = {c: s.st.columns[("lineitem", c)]
          for c in ("l_orderkey", "l_shipdate", "l_extendedprice")}
    m = li["l_shipdate"] >= torch_plans._day(1995, 1, 1)
    by_key = {}
    for k, p in zip(li["l_orderkey"][m].tolist(),
                    li["l_extendedprice"][m].tolist()):
        by_key.setdefault(k, []).append(p)
    assert want[0].tolist() == sorted(by_key)
    assert [want[5].tolist(), want[6].tolist(), want[7].tolist()] == [
        [f(by_key[k]) for k in sorted(by_key)] for f in (sum, min, max)]

