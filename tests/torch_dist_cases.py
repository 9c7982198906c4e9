"""Rank bodies and inputs of the port's distribution tests
(``test_torch_parallel.py``, ``test_torch_shuffle_join.py``; the plan
distributor's suites live in ``torch_auto_cases.py``).

Each world of ranks is a set of processes started in the ``spawn`` mode
(never ``fork``: the pytest process runs JAX's threads) that meet through a
``FileStore`` and run every case of one suite over gloo, then write their
results as ``rank{r}.npz``.  This module imports neither ``jax`` nor
``pytest``, so a rank process loads torch and the port only.  The inputs
come from numpy seeds; the test files run the same inputs through the JAX
package on a mesh of as many CPU devices and compare.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

import torch_plans

# seconds a world of ranks may take for a whole suite
TIMEOUT_S = 240
# datagen store of the DistQuery cases (as tests/test_parallel.py)
STORE_SF, STORE_SEED = 0.005, 11
# the DistQuery cases: torch_plans' (the operator lambdas of
# tests/test_parallel.py)
Q6_COLUMNS, Q1_COLUMNS = (torch_plans.DIST_Q6_COLUMNS,
                          torch_plans.DIST_Q1_COLUMNS)
q6_query, q1_query = torch_plans.dist_q6_query, torch_plans.dist_q1_query




def wide_query(cols):
    """A group-by over more ids than segred.SMALL_DOMAIN (one per ship
    date), which takes DistQuery's sorted path."""
    lo = int(cols["l_shipdate"].min())
    return dict(
        domain=int(cols["l_shipdate"].max()) - lo + 1,
        mask_fn=lambda c: c["l_discount"] >= 5,
        key_fn=lambda c: c["l_shipdate"] - lo,
        agg_fns={"revenue": lambda c: c["l_extendedprice"]
                 * c["l_discount"],
                 "qty": lambda c: c["l_quantity"]})


DIST_QUERIES = {"q6": (Q6_COLUMNS, lambda cols: q6_query()),
                "q1": (Q1_COLUMNS, q1_query),
                "wide": (Q6_COLUMNS, wide_query)}


# ------------------------------------------------------------------ inputs
def shuffle_by_key_inputs():
    rng = np.random.default_rng(3)
    n, key_hi = 4096, 1000
    keys = rng.integers(0, key_hi, size=n).astype(np.int64)
    vals = rng.integers(0, 10**6, size=n).astype(np.int64)
    return keys, vals, key_hi


def groupby_inputs(case):
    """(keys, values, ops, key_hi) of each ShuffleGroupBy case, the inputs
    of tests/test_shuffle_agg.py (8 shards' worth of rows)."""
    if case == "sum_min":
        rng = np.random.default_rng(5)
        n, key_hi = 8 * 4096, 50_000
        keys = rng.integers(0, key_hi, size=n).astype(np.int64)
        a = rng.integers(-1000, 1000, size=n).astype(np.int64)
        b = rng.integers(0, 10**6, size=n).astype(np.int64)
        return keys, [a, b], ["sum", "min"], key_hi
    if case == "row_skew":
        n = 8 * 4096
        return (np.full(n, 31_337, np.int64), [np.arange(n, dtype=np.int64)],
                ["sum"], 50_000)
    if case == "key_clustering":
        rng = np.random.default_rng(9)
        n, key_hi = 8 * 1024, 80_000
        keys = rng.integers(0, 300, size=n).astype(np.int64)
        a = rng.integers(0, 1000, size=n).astype(np.int64)
        return keys, [a], ["sum"], key_hi
    if case == "max_overflow":
        # every key distinct and inside owner 0's range: over more than one
        # rank a bucket overflows; over one it cannot
        rng = np.random.default_rng(21)
        n, key_hi = 4096, 1 << 20
        keys = rng.permutation(n).astype(np.int64)
        a = rng.integers(-10**9, 10**9, size=n).astype(np.int64)
        return keys, [a, a], ["max", "sum"], key_hi
    raise KeyError(case)


GROUPBY_CASES = ("sum_min", "row_skew", "key_clustering", "max_overflow")


def join_inputs(case):
    """(lk, rk, key_bounds, heavy, env) of each ShuffleJoin case: the
    inputs of tests/test_shuffle_join.py, and three more (the fused
    exchange, int32 keys, and the pipelined exchange with int32 keys)."""
    env = {}
    heavy = True
    if case in ("random_inner", "fused_exchange", "int32_keys"):
        rng = np.random.default_rng(0)
        nl, nr, hi = 903, 411, 257
        lk = rng.integers(0, hi, nl).astype(np.int64)
        rk = rng.integers(0, hi, nr).astype(np.int64)
        if case == "fused_exchange":
            env = {"MPLAN2VDL_FUSED_EXCHANGE": "1"}
        if case == "int32_keys":
            lk, rk = lk.astype(np.int32), rk.astype(np.int32)
        return lk, rk, (0, hi), heavy, env
    if case == "semi_anti_outer":
        rng = np.random.default_rng(1)
        nl, nr, hi = 240, 100, 64
        lk = rng.integers(0, hi, nl).astype(np.int64)
        rk = rng.integers(0, hi // 2, nr).astype(np.int64)
        return lk, rk, (0, hi), heavy, env
    if case == "skew_retry":
        return (np.full(160, 7, np.int64), np.full(160, 7, np.int64),
                (0, 4096), False, env)
    if case == "hot_probe":
        rng = np.random.default_rng(11)
        nl, nr, hi = 1600, 400, 512
        lk = rng.integers(0, hi, nl).astype(np.int64)
        lk[:960] = 7
        rk = rng.integers(0, hi, nr).astype(np.int64)
        rk[:3] = 7
        return lk, rk, (0, hi), heavy, env
    if case == "hot_build":
        rng = np.random.default_rng(12)
        nl, nr, hi = 800, 800, 256
        lk = rng.integers(0, hi, nl).astype(np.int64)
        rk = rng.integers(0, hi, nr).astype(np.int64)
        rk[:400] = 9
        return lk, rk, (0, hi), heavy, env
    if case == "zipf":
        rng = np.random.default_rng(13)
        nl, nr, hi = 2000, 1000, 100_000
        lk = np.minimum(rng.zipf(1.5, nl), hi - 1).astype(np.int64)
        rk = np.minimum(rng.zipf(1.5, nr), hi - 1).astype(np.int64)
        return lk, rk, (0, hi), heavy, env
    if case == "invalid_rows":
        nl = nr = 80
        lk = np.arange(nl, dtype=np.int64)
        rk = np.arange(nr, dtype=np.int64)
        lk[::3] = 2**62 - 1
        rk[::5] = 2**62
        return lk, rk, (0, nl), heavy, env
    if case == "clustered":
        lk, rk = clustered_inputs()[1:]
        return lk, rk, (0, 1_000_000), heavy, env
    if case == "negative_bounds":
        rng = np.random.default_rng(2)
        lk = rng.integers(-50, 50, 96).astype(np.int64)
        rk = rng.integers(-50, 50, 96).astype(np.int64)
        return lk, rk, (-50, 50), heavy, env
    if case in ("pipelined", "pipelined_int32"):
        rng = np.random.default_rng(11)
        nl, nr, hi = 777, 505, 97
        lk = rng.integers(0, hi, nl).astype(np.int64)
        rk = rng.integers(0, hi, nr).astype(np.int64)
        lk[:200] = 42  # hot probe key: broadcast path engages
        if case == "pipelined_int32":
            lk, rk = lk.astype(np.int32), rk.astype(np.int32)
        return lk, rk, (0, hi), heavy, {"MPLAN2VDL_PIPELINE_EXCHANGE": "3"}
    raise KeyError(case)


JOIN_CASES = ("random_inner", "semi_anti_outer", "skew_retry", "hot_probe",
              "hot_build", "zipf", "invalid_rows", "clustered",
              "negative_bounds", "pipelined", "fused_exchange", "int32_keys",
              "pipelined_int32")


def clustered_inputs():
    """int32 keys in a narrow band for the owner histogram, then the
    clustered join's keys (one generator, as the JAX test draws them)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(1000, 1064, 4096).astype(np.int32)
    lk = rng.integers(1000, 1064, 512).astype(np.int64)
    rk = rng.integers(1000, 1064, 512).astype(np.int64)
    return keys, lk, rk


def heavy_detect_inputs():
    rng = np.random.default_rng(14)
    lk = rng.integers(0, 64, 640).astype(np.int64)
    rk = rng.integers(0, 64, 640).astype(np.int64)
    lk[:300] = 5
    rk[:200] = 5
    return lk, rk


def sents(dtype):
    """(SENT_R, SENT_L) of a numpy key dtype, as both packages set them."""
    if np.dtype(dtype) == np.int32:
        return 2**31 - 1, 2**31 - 2
    return 2**62, 2**62 - 1


def padded(arr, world, fill):
    """``arr`` padded with ``fill`` to ``world`` equal shards, and the
    shard length."""
    rows = -(-len(arr) // world)
    buf = np.full(world * rows, fill, dtype=np.asarray(arr).dtype)
    buf[:len(arr)] = arr
    return buf, rows


def join_sides(lk, rk, world):
    """Padded probe keys, build keys and build positions, and the shard
    lengths (srl, srr)."""
    sent_r, sent_l = sents(lk.dtype)
    lbuf, srl = padded(lk, world, sent_l)
    rbuf, srr = padded(rk, world, sent_r)
    pbuf, _ = padded(np.arange(len(rk), dtype=np.int64), world, 0)
    return lbuf, rbuf, pbuf, srl, srr


def count_caps(srl, srr, world):
    """cap_r and cap_l of ShuffleJoin at scale 1."""
    return (2 * -(-srr // world) + 64, 2 * -(-srl // world) + 64)


# -------------------------------------------------------------- rank side
def _local(mesh, buf, rows):
    return torch.from_numpy(
        np.ascontiguousarray(buf[mesh.rank * rows:(mesh.rank + 1) * rows])
    ).to(mesh.device)


@contextlib.contextmanager
def env_vars(env):
    """``env`` set in os.environ for the block, then the old values back."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _mesh_case(mesh):
    from mplan2vdl_tpu_torch.parallel import dist

    try:
        dist.make_mesh()
        err = ""
    except RuntimeError as e:
        err = str(e)
    return {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
            "backend": str(torch.distributed.get_backend(mesh.group)),
            "default_device_error": err}


def _dist_query(mesh, which):
    from mplan2vdl_tpu_torch.engine import datagen
    from mplan2vdl_tpu_torch.parallel import dist

    st = datagen.generate(sf=STORE_SF, seed=STORE_SEED)
    names, spec = DIST_QUERIES[which]
    cols = {c: st.columns[("lineitem", c)] for c in names}
    table = dist.ShardedTable.put(mesh, cols)
    return dist.DistQuery(table=table, **spec(cols))()


def _shuffle_by_key(mesh):
    from mplan2vdl_tpu_torch.parallel import dist

    keys, vals, key_hi = shuffle_by_key_inputs()
    rows = len(keys) // mesh.size
    ko, vo = dist.shuffle_by_key(mesh, _local(mesh, keys, rows),
                                 _local(mesh, vals, rows), key_hi)
    return {"keys": ko.numpy(), "vals": vo.numpy()}


def _groupby(mesh, case):
    from mplan2vdl_tpu_torch.parallel.shuffle_agg import ShuffleGroupBy

    keys, vals, ops, key_hi = groupby_inputs(case)
    rows = len(keys) // mesh.size
    gb = ShuffleGroupBy(mesh=mesh, shard_rows=rows, key_hi=key_hi, ops=ops)
    try:
        gk, gv = gb(_local(mesh, keys, rows),
                    [_local(mesh, v, rows) for v in vals])
    except RuntimeError as e:
        return {"error": np.array(str(e)), "cap": gb.cap}
    out = {"keys": gk, "cap": gb.cap}
    out.update({f"v{i}": v for i, v in enumerate(gv)})
    return out


def _join(mesh, case):
    from mplan2vdl_tpu_torch.parallel.shuffle_join import ShuffleJoin

    lk, rk, bounds, heavy, env = join_inputs(case)
    lbuf, rbuf, pbuf, srl, srr = join_sides(lk, rk, mesh.size)
    sj = ShuffleJoin(mesh=mesh, shard_rows_l=srl, shard_rows_r=srr,
                     key_bounds=bounds, heavy=heavy)
    with env_vars(env):
        lidx, ok, cnt, (pay,) = sj(
            _local(mesh, lbuf, srl), _local(mesh, rbuf, srr),
            [_local(mesh, pbuf, srr)])
    plan = sj._heavy_plan or (np.zeros(0, lk.dtype), 0, 0)
    return {"lidx": lidx, "ok": ok, "cnt": cnt, "pay": pay,
            "cap_scale": sj.cap_scale, "caps": np.array(sj._caps),
            "heavy_keys": plan[0], "cap_hb": plan[1], "cap_hp": plan[2]}


def _heavy_detect(mesh):
    from mplan2vdl_tpu_torch.parallel.shuffle_join import shard_heavy_detect

    lk, rk = heavy_detect_inputs()
    lbuf, rbuf, _, srl, srr = join_sides(lk, rk, mesh.size)
    hk, rcnt, n_heavy, cap_hb, cap_hp = shard_heavy_detect(
        _local(mesh, lbuf, srl), _local(mesh, rbuf, srr), mesh.size,
        mesh=mesh)
    return {"hk": hk.numpy(), "rcnt": rcnt.numpy(), "n_heavy": n_heavy,
            "cap_hb": cap_hb, "cap_hp": cap_hp}


def _count_stats(mesh, with_heavy):
    from mplan2vdl_tpu_torch.parallel.shuffle_join import (
        shard_heavy_detect, shard_join_count_stats)

    lk, rk, bounds, _, _ = join_inputs("hot_probe")
    lbuf, rbuf, _, srl, srr = join_sides(lk, rk, mesh.size)
    lkeys, rkeys = _local(mesh, lbuf, srl), _local(mesh, rbuf, srr)
    cap_r, cap_l = count_caps(srl, srr, mesh.size)
    kw = {}
    if with_heavy:
        hk, rcnt, _, _, _ = shard_heavy_detect(lkeys, rkeys, mesh.size,
                                               mesh=mesh)
        kw = dict(heavy_keys=hk, heavy_rcnt=rcnt)
    out = shard_join_count_stats(lkeys, rkeys, key_lo=bounds[0],
                                 key_hi=bounds[1], n_dev=mesh.size,
                                 cap_r=cap_r, cap_l=cap_l, mesh=mesh, **kw)
    return {"stats": np.array([int(x) for x in out])}


def _parallel_suite():
    cases = {"mesh": _mesh_case,
             "shuffle_by_key": _shuffle_by_key}
    for q in DIST_QUERIES:
        cases[q] = (lambda q: lambda m: _dist_query(m, q))(q)
    for c in GROUPBY_CASES:
        cases[f"groupby_{c}"] = (lambda c: lambda m: _groupby(m, c))(c)
    return cases


def _join_suite():
    cases = {f"join_{c}": (lambda c: lambda m: _join(m, c))(c)
             for c in JOIN_CASES}
    cases["heavy_detect"] = _heavy_detect
    cases["count_stats"] = lambda m: _count_stats(m, False)
    cases["count_stats_heavy"] = lambda m: _count_stats(m, True)
    return cases


def _auto_suite(which):
    def suite():
        import torch_auto_cases

        return getattr(torch_auto_cases, f"{which}_suite")()
    return suite


SUITES = {"parallel": _parallel_suite, "join": _join_suite,
          "auto_cli": _auto_suite("cli"), "auto_fuzz": _auto_suite("fuzz"),
          "auto_small": _auto_suite("small")}


def run_rank(rank, world, url, out_dir, suite):
    """One rank: join the world over gloo, run every case of ``suite``,
    write ``rank{rank}.npz`` (keys ``case.name``)."""
    torch.set_num_threads(1)
    from mplan2vdl_tpu_torch.parallel import multihost

    multihost.initialize(url, world, rank, device="cpu")
    try:
        mesh = multihost.data_mesh(device="cpu")
        out = {}
        for name, fn in SUITES[suite]().items():
            for k, v in fn(mesh).items():
                out[f"{name}.{k}"] = np.asarray(v)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


class Ranks:
    """A world of ``world`` rank processes running one suite, started at
    construction; ``case`` waits for them (at most TIMEOUT_S) and returns
    each rank's results of one case."""

    def __init__(self, suite: str, world: int, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.world, self.dir = world, directory
        url = "file://" + os.path.join(os.path.abspath(directory), "store")
        self.ctx = torch.multiprocessing.start_processes(
            run_rank, args=(world, url, directory, suite), nprocs=world,
            join=False, start_method="spawn")
        self._results = None

    def _wait(self):
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not self.ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world of {self.world} ranks ran "
                                       f"past {TIMEOUT_S} s")
        finally:
            self.close()
        return [dict(np.load(os.path.join(self.dir, f"rank{r}.npz")))
                for r in range(self.world)]

    def case(self, name: str):
        if self._results is None:
            try:
                self._results = self._wait()
            except Exception as e:  # every later case reports the same
                self._results = e
        if isinstance(self._results, Exception):
            raise RuntimeError(f"world of {self.world} ranks failed") \
                from self._results
        pre = name + "."
        return [{k[len(pre):]: v for k, v in res.items()
                 if k.startswith(pre)} for res in self._results]

    def close(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
