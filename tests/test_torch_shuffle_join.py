"""The port's distributed shuffle equijoin (``parallel/shuffle_join.py``)
against the JAX package's.

Worlds of 4 and 1 gloo ranks (``torch_dist_cases.Ranks``, started once for
the module) run the cases of ``tests/test_shuffle_join.py`` (retries, hot
probe and build keys, Zipf keys, invalid rows, clustered keys, negative key
bounds, the pipelined exchange) and three more (the fused exchange, int32
keys, the pipelined exchange over int32 keys); each test runs the same
inputs through the JAX ``ShuffleJoin`` on a mesh of as many CPU devices.
Held exact: the per-row counts, the capacities and how many retries
(``cap_scale``), the heavy plan, the detection round and the count round.
Held as multisets per rank: the join pairs, since JAX's one-key sort is not
stable.  The owner and sub-range hashes are held bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_dist_cases as C

WORLDS = (4, 1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    worlds = {w: C.Ranks("join", w, str(tmp_path_factory.mktemp(f"join{w}")))
              for w in WORLDS}
    yield worlds
    for r in worlds.values():
        r.close()


def _mesh(world):
    import jax
    from mplan2vdl_tpu.parallel import dist

    return dist.make_mesh(jax.devices()[:world])


def _put(mesh, arr):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(arr, NamedSharding(mesh, P("d")))


def _oracle(lk, rk):
    """Every (probe row, build row) pair of equal keys, sorted, and the
    matches per probe row (numpy sort-merge)."""
    order = np.argsort(rk, kind="stable")
    lo = np.searchsorted(rk[order], lk)
    cnt = np.searchsorted(rk[order], lk, side="right") - lo
    li = np.repeat(np.arange(len(lk)), cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    rj = order[np.repeat(lo, cnt) + np.arange(len(li)) - first]
    return _sorted_pairs(li, rj), cnt.astype(np.int64)


def _sorted_pairs(a, b):
    """(n, 2) pairs in lexicographic order: a multiset, compared exactly."""
    pairs = np.stack([np.asarray(a, np.int64), np.asarray(b, np.int64)], 1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def _jax_join(world, case):
    from mplan2vdl_tpu.parallel.shuffle_join import ShuffleJoin

    lk, rk, bounds, heavy, env = C.join_inputs(case)
    lbuf, rbuf, pbuf, srl, srr = C.join_sides(lk, rk, world)
    mesh = _mesh(world)
    sj = ShuffleJoin(mesh=mesh, shard_rows_l=srl, shard_rows_r=srr,
                     key_bounds=bounds, heavy=heavy)
    with C.env_vars(env):
        lidx, ok, cnt, (pay,) = sj(_put(mesh, lbuf), _put(mesh, rbuf),
                                   [_put(mesh, pbuf)])
    plan = sj._heavy_plan or (np.zeros(0, lk.dtype), 0, 0)
    return {"lidx": lidx, "ok": ok, "cnt": cnt, "pay": pay,
            "cap_scale": sj.cap_scale, "caps": np.array(sj._caps),
            "heavy_keys": plan[0], "cap_hb": plan[1], "cap_hp": plan[2]}


def _pairs_by_rank(r):
    """Each rank's (probe row, payload) pairs as a sorted multiset."""
    return [_sorted_pairs(r["lidx"][s][r["ok"][s]], r["pay"][s][r["ok"][s]])
            for s in range(r["ok"].shape[0])]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", C.JOIN_CASES)
def test_shuffle_join(ranks, case, world):
    want = _jax_join(world, case)
    lk, rk = C.join_inputs(case)[:2]
    srl = -(-len(lk) // world)
    want_pairs, want_cnt = _oracle(lk, rk)
    if case == "invalid_rows":
        want_cnt[lk >= len(lk)] = 0
    if case == "skew_retry":
        assert want["cap_scale"] > 1
    if case in ("hot_probe", "hot_build", "zipf"):
        assert len(want["heavy_keys"]) and want["cap_scale"] == 1
    want_by_rank = _pairs_by_rank(want)
    for got in ranks[world].case(f"join_{case}"):
        for k in ("cnt", "cap_scale", "caps", "heavy_keys", "cap_hb",
                  "cap_hp"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["heavy_keys"].dtype == want["heavy_keys"].dtype
        assert got["ok"].shape == want["ok"].shape
        by_rank = _pairs_by_rank(got)
        for g, w in zip(by_rank, want_by_rank, strict=True):
            np.testing.assert_array_equal(g, w)
        pairs = np.concatenate([p + [s * srl, 0]
                                for s, p in enumerate(by_rank)])
        np.testing.assert_array_equal(_sorted_pairs(*pairs.T), want_pairs)
        np.testing.assert_array_equal(got["cnt"].reshape(-1)[:len(lk)],
                                      want_cnt)


def _shard_map(world, fn, n_in, n_out):
    import jax
    from functools import partial
    from jax.sharding import PartitionSpec as P

    return jax.jit(partial(jax.shard_map, mesh=_mesh(world),
                           in_specs=(P("d"),) * n_in,
                           out_specs=(P(),) * n_out, check_vma=False)(fn))


def _jax_detect(world, lbuf, rbuf):
    from mplan2vdl_tpu.parallel.shuffle_join import shard_heavy_detect

    mesh = _mesh(world)
    det = _shard_map(world, lambda l, r: shard_heavy_detect(
        l.reshape(-1), r.reshape(-1), world), 2, 5)
    return [np.asarray(x) for x in det(_put(mesh, lbuf), _put(mesh, rbuf))]


@pytest.mark.parametrize("world", WORLDS)
def test_heavy_detect_exact_caps(ranks, world):
    """The detection round equals JAX's, and its caps are exact against a
    numpy recount (as tests/test_shuffle_join.py checks them)."""
    lk, rk = C.heavy_detect_inputs()
    lbuf, rbuf, _, srl, srr = C.join_sides(lk, rk, world)
    hk, rcnt, n_heavy, cap_hb, cap_hp = _jax_detect(world, lbuf, rbuf)
    heavy = set(hk[hk < 2**62 - 1].tolist())
    assert 5 in heavy and int(n_heavy) == len(heavy)
    rglob = {k: int((rk == k).sum()) for k in heavy}
    assert int(cap_hb) == max(int(np.isin(s, list(heavy)).sum())
                              for s in rbuf.reshape(world, srr))
    assert int(cap_hp) == max(sum(int((s == k).sum()) * rglob[k]
                                  for k in heavy)
                              for s in lbuf.reshape(world, srl))
    for got in ranks[world].case("heavy_detect"):
        np.testing.assert_array_equal(got["hk"], hk)
        np.testing.assert_array_equal(got["rcnt"], rcnt)
        for k, w in (("n_heavy", n_heavy), ("cap_hb", cap_hb),
                     ("cap_hp", cap_hp)):
            assert int(got[k]) == int(w), k


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("with_heavy", [False, True])
def test_join_count_stats(ranks, world, with_heavy):
    """The count round (the capacities auto-distribution sizes its join
    from), with and without the heavy keys excluded, equals JAX's."""
    import jax.numpy as jnp
    from mplan2vdl_tpu.parallel.shuffle_join import shard_join_count_stats

    lk, rk, bounds, _, _ = C.join_inputs("hot_probe")
    lbuf, rbuf, _, srl, srr = C.join_sides(lk, rk, world)
    cap_r, cap_l = C.count_caps(srl, srr, world)
    kw = {}
    if with_heavy:
        hk, rcnt = _jax_detect(world, lbuf, rbuf)[:2]
        kw = dict(heavy_keys=jnp.asarray(hk), heavy_rcnt=jnp.asarray(rcnt))
    stats = _shard_map(world, lambda l, r: shard_join_count_stats(
        l.reshape(-1), r.reshape(-1), key_lo=bounds[0], key_hi=bounds[1],
        n_dev=world, cap_r=cap_r, cap_l=cap_l, **kw), 2, 6)
    mesh = _mesh(world)
    want = [int(x) for x in stats(_put(mesh, lbuf), _put(mesh, rbuf))]
    name = "count_stats_heavy" if with_heavy else "count_stats"
    for got in ranks[world].case(name):
        assert got["stats"].tolist() == want


# ------------------------------------------------ hashes, bit for bit
def _hash_keys(dtype):
    rng = np.random.default_rng(7 if dtype == np.int32 else 8)
    info = np.iinfo(dtype)
    sent_r, sent_l = C.sents(dtype)
    return np.concatenate([
        rng.integers(info.min, info.max, 4000, dtype=dtype, endpoint=True),
        rng.integers(-100, 100, 500).astype(dtype),
        np.array([0, -1, 1, info.min, info.max, sent_l, sent_r,
                  sent_l - 1, 2**32 - 1 if dtype == np.int64 else 7,
                  2**32 if dtype == np.int64 else 8], dtype=dtype)])


@pytest.mark.parametrize("n_dev", [1, 3, 4, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_owner_dest_bit_exact(dtype, n_dev):
    import jax.numpy as jnp
    from mplan2vdl_tpu.parallel import shuffle_join as J

    from mplan2vdl_tpu_torch.parallel import shuffle_join as T

    keys = _hash_keys(dtype)
    want = np.asarray(J.owner_dest(jnp.asarray(keys), 0, 1 << 20, n_dev))
    got = T.owner_dest(torch.from_numpy(keys), 0, 1 << 20, n_dev).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T.dest_histogram(torch.from_numpy(got), n_dev).numpy(),
        np.asarray(J.dest_histogram(jnp.asarray(want), n_dev)))


@pytest.mark.parametrize("S", [2, 3, 5])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_subrange_id_bit_exact(dtype, S):
    import jax.numpy as jnp
    from mplan2vdl_tpu.parallel import shuffle_join as J

    from mplan2vdl_tpu_torch.parallel import shuffle_join as T

    keys = _hash_keys(dtype)
    for n_dev in (1, 4, 8):
        want = np.asarray(J._subrange_id(jnp.asarray(keys), n_dev, S))
        got = T._subrange_id(torch.from_numpy(keys), n_dev, S).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_key_sents_and_clustered_spread():
    """The sentinels of both key widths, and clustered keys spread over
    four owners as JAX spreads them (no owner holds a majority)."""
    import jax.numpy as jnp
    from mplan2vdl_tpu.parallel import shuffle_join as J

    from mplan2vdl_tpu_torch.parallel import shuffle_join as T

    for jd, td in ((jnp.int32, torch.int32), (jnp.int64, torch.int64)):
        assert [int(x) for x in J.key_sents(jd)] == list(T.key_sents(td))
    assert (T.SENT_R, T.SENT_L) == (int(J.SENT_R), int(J.SENT_L))
    keys = C.clustered_inputs()[0]
    hist = T.dest_histogram(T.owner_dest(torch.from_numpy(keys), 0,
                                         1_000_000, 4), 4).numpy()
    want = np.asarray(J.dest_histogram(
        J.owner_dest(jnp.asarray(keys), 0, 1_000_000, 4), 4))
    np.testing.assert_array_equal(hist, want)
    assert hist.sum() == 4096 and hist.max() < 4096 // 2, hist
