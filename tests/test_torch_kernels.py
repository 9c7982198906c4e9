"""The port's kernel modules against the JAX package's, on the CPU.

Each plain version (what a kernel wrapper runs for a CPU tensor) gets the
same numpy inputs as the JAX function, made from a seed, and must agree
exactly (tolerance 0: every value is an integer).  The case lists are those
of tests/test_compact.py, tests/test_sorted_gather.py,
tests/test_scatter_kernel.py, tests/test_multiagg.py and
tests/test_multiagg_mxu.py.  The JAX side runs as its own tests run it: the
Pallas kernels in interpret mode.  The CUDA kernels themselves run only on
the GPU, where chip_smoke.py holds them against these plain versions.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_plans

from mplan2vdl_tpu.engine.kernels import compact as jcompact
from mplan2vdl_tpu.engine.kernels import multiagg as jmultiagg
from mplan2vdl_tpu.engine.kernels import multiagg_mxu as jmxu
from mplan2vdl_tpu.engine.kernels import scatter as jscatter
from mplan2vdl_tpu.engine.kernels import segred as jsegred
from mplan2vdl_tpu.engine.kernels import sorted_gather as jgather
from mplan2vdl_tpu_torch.engine.kernels import compact as tcompact
from mplan2vdl_tpu_torch.engine.kernels import multiagg as tmultiagg
from mplan2vdl_tpu_torch.engine.kernels import multiagg_mxu as tmxu
from mplan2vdl_tpu_torch.engine.kernels import scatter as tscatter
from mplan2vdl_tpu_torch.engine.kernels import segred as tsegred
from mplan2vdl_tpu_torch.engine.kernels import sorted_gather as tgather


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("MPLAN2VDL_PL_INTERPRET", "1")


# ------------------------------------------------------------- compaction
def _masks():
    """(id, mask, n_out) over the cases of tests/test_compact.py."""
    out = []
    for n, p in [(100, 0.5), (8192, 0.3), (20000, 0.05), (16401, 0.9)]:
        rng = np.random.default_rng(1)
        out.append((f"random-{n}-{p}", rng.random(n) < p, None))
    out.append(("all", np.ones(9000, bool), None))
    out.append(("none", np.zeros(9000, bool), None))
    rng = np.random.default_rng(2)
    out.append(("n_out-trim", rng.random(20000) < 0.1, 4096))
    rng = np.random.default_rng(3)
    n = 8192 * 3 + 1
    strag = np.zeros(n, bool)
    strag[np.sort(rng.choice(n, 97, replace=False))] = True
    out.append(("block-boundary-carry", strag, None))
    # the CUDA kernel's tile (compact.TILE rows) and one row either side
    tile = tcompact.TILE
    for n in (tile - 1, tile + 1):
        rng = np.random.default_rng(n)
        out.append((f"tile{n - tile:+d}", rng.random(n) < 0.4, None))
    out.append(("all-true-two-tiles+1", np.ones(2 * tile + 1, bool), None))
    return out


@pytest.mark.parametrize("mask,n_out", [c[1:] for c in _masks()],
                         ids=[c[0] for c in _masks()])
def test_compact_matches_jax(interpret_mode, mask, n_out):
    want = np.asarray(jcompact.compact_positions(jnp.asarray(mask), n_out))
    got = tcompact.compact_positions(torch.from_numpy(mask), n_out)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_compact_scratch_sizing():
    """The look-back scratch: zeroed words only on first use, on growth
    (at least double) and when the epoch would wrap; otherwise each call
    draws its tickets after the previous call's and gets a new epoch."""
    assert (tcompact.tiles(1), tcompact.tiles(tcompact.TILE),
            tcompact.tiles(tcompact.TILE + 1)) == (1, 1, 2)
    assert tcompact.tiles(60_003_426) == 1832
    assert [tcompact.tail_blocks(k) for k in (0, 1, tcompact.TAIL_SLOTS,
                                              tcompact.TAIL_SLOTS + 1,
                                              60_003_426)] == [
        0, 1, 1, 2, tcompact.MAX_TAIL_BLOCKS]
    lb = tcompact.Lookback()
    assert lb.plan(3, 5) == (1 + tcompact.MIN_STATUS, 0, 1)
    assert lb.plan(1, 2) == (None, 5, 2)
    assert lb.plan(tcompact.MIN_STATUS, 7) == (None, 7, 3)
    fresh, base, epoch = lb.plan(tcompact.MIN_STATUS + 1, 4)
    assert (fresh, base, epoch) == (1 + 2 * tcompact.MIN_STATUS, 0, 1)
    assert lb.plan(7325, 7400) == (7326, 0, 1)
    lb.epoch = tcompact.EPOCH_LIMIT - 2
    assert lb.plan(1, 1) == (None, 7400, tcompact.EPOCH_LIMIT - 1)
    assert lb.plan(1, 1) == (1 + 2 * 7325, 0, 1)
    lb.forget()
    assert lb.plan(1, 1)[0] is not None


def test_compact_rejects_bad_input():
    with pytest.raises(TypeError):
        tcompact.compact_positions(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        tcompact.compact_positions(torch.zeros(8, dtype=torch.bool), 9)


# ----------------------------------------------------------------- gather
def _gather_cases():
    """(id, sources, positions, valid) over tests/test_sorted_gather.py."""
    out = []
    for sel in (0.9, 0.5, 0.2):
        rng = np.random.default_rng(3)
        n = 40_000
        src = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
        pos = np.sort(rng.choice(n, int(n * sel), replace=False))
        out.append((f"int32-sel{sel}", [src], pos.astype(np.int32), None))
    rng = np.random.default_rng(4)
    n = 20_000
    src = rng.integers(-(1 << 60), 1 << 60, n).astype(np.int64)
    pos = np.sort(rng.choice(n, n // 2, replace=False)).astype(np.int32)
    out.append(("int64", [src], pos, None))
    rng = np.random.default_rng(5)
    src = rng.integers(0, 1 << 30, n).astype(np.int32)
    pos = np.sort(rng.choice(n, 4000, replace=False)).astype(np.int32)
    pos[2500:] = 0  # garbage past valid, as _mask_tail leaves it
    out.append(("masked-tail", [src], pos, 2500))
    rng = np.random.default_rng(6)
    n = 600_000
    src = rng.integers(0, 1 << 30, n).astype(np.int32)
    pos = np.sort(rng.choice(n, 2048, replace=False)).astype(np.int32)
    out.append(("sparse-spans", [src], pos, None))
    rng = np.random.default_rng(7)
    n = 30_000
    src = rng.integers(0, 1 << 30, n).astype(np.int32)
    base = np.sort(rng.choice(n, 3000, replace=False))
    pos = np.sort(np.concatenate([base, base, base]))[:6144].astype(np.int32)
    out.append(("duplicates-clusters", [src], pos, None))
    rng = np.random.default_rng(8)
    n = 30_000
    srcs = [rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
            rng.integers(-(1 << 60), 1 << 60, n).astype(np.int64),
            rng.integers(0, 100, n).astype(np.int32)]
    pos = np.sort(rng.choice(n, n // 3, replace=False)).astype(np.int32)
    out.append(("many-mixed", srcs, pos, 9000))
    # the redesigned kernel's paths: both dtype groups, a split into two
    # launches, row counts around V = 4, unaligned position views,
    # consecutive runs, any order, the tail repeat from row 0, n = 1
    rng = np.random.default_rng(9)
    n = 12_000
    i64 = [rng.integers(-(1 << 62), 1 << 62, n) for _ in range(8)]
    i32 = [rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
           for _ in range(4)]
    asc = np.sort(rng.choice(n, n // 6, replace=False)).astype(np.int32)
    out.append(("k8-int64", i64, asc, None))
    out.append(("k9-split", i64 + i32[:1], asc, 1500))
    out.append(("k8-4int32-4int64", i32 + i64[:4], asc, None))
    for m in (1, 3, 5):
        out.append((f"m{m}", [i32[0], i64[0]], asc[:m], None))
    out.append(("m-ragged", [i32[0], i64[0]], asc[:4 * 101 + 3], None))
    for off in (1, 2, 3):
        out.append((f"pos-view{off}", [i32[1], i64[1]], asc[off:], None))
    out.append(("pos-view1-int64", [i32[1], i64[1]],
                asc.astype(np.int64)[1:], None))
    ident = np.arange(n, dtype=np.int32)
    out.append(("identity-expansion", [i64[2], i64[3], i32[2]], ident, None))
    out.append(("identity-plus-one", [i32[2], i64[2]], ident[1:], None))
    out.append(("random-permutation", [i32[3], i64[4]],
                rng.permutation(n).astype(np.int32), None))
    out.append(("random-permutation-k1", [i64[5]],
                rng.permutation(n).astype(np.int32), None))
    out.append(("valid0-host", [i32[0], i64[0]], asc, 0))
    out.append(("valid0-device", [i32[0], i64[0]], asc, np.array(0)))
    out.append(("n1", [i32[0][:1], i64[0][:1]],
                rng.integers(-3, 4, 77).astype(np.int32), None))
    return out


def _np_gather(srcs, pos, valid):
    """numpy statement of the contract: ``_prep_pos`` (the tail repeats
    the last valid position, positions clip into the source), then
    ``src[p]`` for each source."""
    m, n = len(pos), len(srcs[0])
    p = np.where(np.arange(m) < valid, pos,
                 pos[min(max(int(valid) - 1, 0), m - 1)])
    p = np.clip(p.astype(np.int64), 0, n - 1)
    return [s[p] for s in srcs]


@pytest.mark.parametrize("srcs,pos,valid", [c[1:] for c in _gather_cases()],
                         ids=[c[0] for c in _gather_cases()])
def test_gather_matches_jax(interpret_mode, srcs, pos, valid):
    """The JAX kernels where they take the case: their contract is
    ascending positions, and the JAX engine sends a k > 1 gather whose
    1024-row blocks span more than the widest window to XLA; elsewhere the
    numpy contract stands in.  A count held in an array is a device tensor for
    the port."""
    valid = len(pos) if valid is None else valid
    tvalid = torch.tensor(int(valid)) if isinstance(valid, np.ndarray) \
        else valid
    jpos = jnp.asarray(pos)
    prepped = _np_gather([np.arange(len(srcs[0]))], pos, valid)[0]
    ascending = bool(np.all(np.diff(prepped) >= 0))
    if len(srcs) == 1:
        want = ([np.asarray(jgather.sorted_gather(
            jnp.asarray(srcs[0]), jpos, valid))] if ascending
            else _np_gather(srcs, pos, valid))
        got = [tgather.sorted_gather(torch.from_numpy(srcs[0]),
                                     torch.from_numpy(pos), tvalid)]
    else:
        fit = jgather.resolve_fit(len(srcs[0]), jpos, valid)
        takes = fit is not False and ascending
        want = (_np_gather(srcs, pos, valid) if not takes else
                [np.asarray(w) for w in jgather.gather_many(
                    [jnp.asarray(s) for s in srcs], jpos, valid,
                    static_fit=fit)])
        got = tgather.gather_many([torch.from_numpy(s) for s in srcs],
                                  torch.from_numpy(pos), tvalid)
    for g, w, s in zip(got, want, srcs):
        assert g.dtype == torch.from_numpy(s).dtype
        # rows past valid are unspecified to callers: compare the prefix
        np.testing.assert_array_equal(g.numpy()[:valid], w[:valid])


# gather.cu's layout: 256-thread blocks (8 warps), at most 8 sources a
# launch
GATHER_WARPS, GATHER_MAX_SOURCES = 8, 8


def _gather_v(k):
    """gather.cu's rows per thread (kRows) of a launch of k sources."""
    return 2 if k <= 3 else 1


def _gather_rows(m, V):
    """gather.cu's rows-to-thread map: [tiles, V, 32] row indices (-1 past
    m).  Warp w of the grid owns tile w, the rows [w * 32 V, (w + 1) * 32
    V); lane l of it takes rows l, l + 32, ..., l + 32 (V - 1), so one
    load or store instruction of a warp (fixed r) covers 32 consecutive
    rows.  The grid has tiles / 8 blocks of 8 warps, rounded up; the last
    block's warps past the last tile return at once."""
    tile = 32 * V
    tiles = -(-m // tile)
    blocks = -(-tiles // GATHER_WARPS)
    assert (blocks - 1) * GATHER_WARPS < tiles <= blocks * GATHER_WARPS
    rows = (np.arange(tiles)[:, None, None] * tile
            + np.arange(V)[None, :, None] * 32 + np.arange(32))
    return np.where(rows < m, rows, -1)


def _gather_thread_model(srcs, pos, valid):
    """numpy statement of gather.cu.  The wrapper cuts the sources into
    launches of at most 8 in order; each launch groups its int32 and its
    int64 sources (the kernel's K4 and K8).  Rows map to threads as
    ``_gather_rows`` says, ``_gather_v`` of them a thread.  A row past m
    reads the position of row m - 1 and stores nothing; a row past
    ``valid`` takes the position of row valid - 1 (of row 0 when valid is
    0); every position then clips into the source.  All loads of a
    thread's V rows precede its stores.
    Returns the outputs and the launches."""
    m, n, k = len(pos), len(srcs[0]), len(srcs)
    vlast = min(max(valid - 1, 0), m - 1)
    outs = [np.zeros(m, s.dtype) for s in srcs]
    written = np.zeros((k, m), np.int64)
    launches = []
    for lo in range(0, k, GATHER_MAX_SOURCES):
        part = range(lo, min(lo + GATHER_MAX_SOURCES, k))
        g4 = [j for j in part if srcs[j].dtype == np.int32]
        g8 = [j for j in part if srcs[j].dtype == np.int64]
        assert 1 <= len(g4) + len(g8) <= GATHER_MAX_SOURCES
        launches.append((g4, g8))
        rows = _gather_rows(m, _gather_v(len(g4) + len(g8)))
        live = rows >= 0
        # every instruction: 32 consecutive rows, or the last tile's prefix
        assert (np.diff(rows, axis=2)[live[:, :, 1:]] == 1).all()
        i = np.where(live, rows, m - 1)
        q = np.clip(pos[np.where(i < valid, i, vlast)].astype(np.int64), 0,
                    n - 1)
        for j in g4 + g8:
            vals = srcs[j][q]              # the loads, every row
            outs[j][rows[live]] = vals[live]  # the stores, rows below m
            written[j, rows[live]] += 1
    assert (written == 1).all()  # every output row stored once
    return outs, launches


def _thread_map_case(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 3000))
    m = int(rng.integers(1, 2500))
    kind = ("ascending", "identity", "random", "runs")[seed % 4]
    if kind == "ascending":
        pos = np.sort(rng.integers(-2, n + 2, m + 3))
    elif kind == "identity":
        pos = np.arange(m + 3) + int(rng.integers(0, 5))
    elif kind == "random":
        pos = rng.integers(-2, n + 2, m + 3)
    else:  # runs of consecutive positions of random lengths
        starts = np.sort(rng.integers(0, n, m + 3))
        pos = np.sort(starts - (np.arange(m + 3)
                                % int(rng.integers(1, 40))))
    pdt = np.int64 if seed % 5 == 0 else np.int32
    off = int(rng.integers(0, 4))
    pos = pos.astype(pdt)[off:off + m]
    k = int(rng.integers(1, 13))
    soff = int(rng.integers(0, 2)) if seed % 3 == 0 else 0
    srcs = [(rng.integers(-(1 << 62), 1 << 62, n + soff) if rng.random() < .5
             else rng.integers(-(1 << 31), 1 << 31, n + soff).astype(np.int32)
             )[soff:] for _ in range(k)]
    valid = (len(pos), 0, int(rng.integers(0, len(pos) + 1)))[seed % 3]
    return srcs, pos, valid


@pytest.mark.parametrize("seed", range(24))
def test_gather_thread_map_arithmetic(seed):
    """The kernel's rows-to-thread mapping, tail repeat, ragged last tile,
    dtype grouping and launch split (the numpy model above) against the
    plain version, over random m, position orders and dtypes, view
    offsets, k and valid."""
    srcs, pos, valid = _thread_map_case(seed)
    outs, launches = _gather_thread_model(srcs, pos, valid)
    want = tgather.gather_many_plain([torch.from_numpy(s) for s in srcs],
                                     torch.from_numpy(pos), valid)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w.numpy())
    k = len(srcs)
    assert len(launches) == -(-k // GATHER_MAX_SOURCES)
    assert sorted(j for g4, g8 in launches for j in g4 + g8) == list(
        range(k))


def test_gather_thread_map_lines():
    """Why the rows are warp-interleaved: at the filter-project's 15.9%
    density one warp load of an int32 source spans about 7 of its 128-byte
    lines; with a lane's 4 rows side by side (one 16-byte access of
    positions and of outputs per lane) it spans about 23, and the L1 serves
    one line per cycle."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    pos = np.flatnonzero(rng.random(n) < 0.159)
    rows = _gather_rows(len(pos), V=4)
    full = rows[(rows >= 0).all(axis=(1, 2))]        # [tiles, 4, lanes]
    blocked = full[:, :1, :1] + 4 * np.arange(32) + np.arange(4)[:, None]

    def lines(r):  # mean 128-byte lines of an int32 source per instruction
        line = np.sort(pos[r] * 4 // 128, axis=-1)
        return (line[..., 1:] != line[..., :-1]).sum(axis=-1).mean() + 1

    interleaved, blocked = lines(full), lines(blocked)
    assert 6 < interleaved < 8 and 21 < blocked < 26, (interleaved, blocked)


def test_gather_device_valid_and_tail():
    """A count held in a tensor acts like the int; rows past ``valid``
    repeat the last valid position (``_prep_pos``)."""
    src = torch.arange(100, dtype=torch.int64) * 3
    pos = torch.tensor([1, 5, 9, 0, 0], dtype=torch.int32)
    for valid in (3, torch.tensor(3)):
        out = tgather.sorted_gather(src, pos, valid)
        assert out.tolist() == [3, 15, 27, 27, 27]


# ------------------------------------------------------ small-table gather
def _small_cases():
    """(id, sources, positions) over tests/test_sorted_gather.py's
    small-table cases, plus k = 3 with mixed dtypes and positions out of
    range (both kernels clip them)."""
    out = []
    rng = np.random.default_rng(8)
    for n, m in [(25, 5000), (7000, 20000), (60000, 8192)]:
        src = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
        pos = rng.integers(0, n, m).astype(np.int32)  # arbitrary order
        out.append((f"int32-{n}x{m}", [src], pos))
    rng = np.random.default_rng(9)
    n, m = 4000, 9000
    src = rng.integers(-(1 << 60), 1 << 60, n).astype(np.int64)
    out.append(("int64", [src], rng.integers(0, n, m).astype(np.int32)))
    rng = np.random.default_rng(10)
    n, m = 25, 6000
    srcs = [rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
            rng.integers(-(1 << 60), 1 << 60, n).astype(np.int64),
            rng.integers(0, 100, n).astype(np.int32)]
    out.append(("k3-mixed", srcs, rng.integers(0, n, m).astype(np.int32)))
    pos = rng.integers(-50, n + 50, m).astype(np.int32)
    out.append(("k3-out-of-range", srcs, pos))
    return out


@pytest.mark.parametrize("srcs,pos", [c[1:] for c in _small_cases()],
                         ids=[c[0] for c in _small_cases()])
def test_small_gather_matches_jax(interpret_mode, srcs, pos):
    jpos = jnp.asarray(pos)
    m = len(pos)
    if len(srcs) == 1:
        want = [np.asarray(jgather.small_table_gather(jnp.asarray(srcs[0]),
                                                      jpos, m))]
        got = [tgather.small_table_gather(torch.from_numpy(srcs[0]),
                                          torch.from_numpy(pos), m)]
    else:
        want = [np.asarray(w) for w in jgather.gather_many(
            [jnp.asarray(s) for s in srcs], jpos, m, small=True)]
        got = tgather.gather_many([torch.from_numpy(s) for s in srcs],
                                  torch.from_numpy(pos), m, small=True)
    for g, w, s in zip(got, want, srcs):
        assert g.dtype == torch.from_numpy(s).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_small_gather_clips_without_tail_repeat():
    """Unlike the monotone gather, rows past ``valid`` are not redirected
    to the last valid position: every position is only clipped."""
    src = torch.arange(10, dtype=torch.int32) * 3
    pos = torch.tensor([4, -2, 99, 1, 0], dtype=torch.int64)
    assert tgather.small_table_gather(src, pos, 2).tolist() == [12, 0, 27,
                                                                3, 0]
    with pytest.raises(ValueError, match="small-table"):
        tgather.small_table_gather(
            torch.zeros(tgather.SMALL_TABLE + 1, dtype=torch.int32), pos, 5)


# -------------------------------------------------------- monotone scatter
def _scatter_cases():
    """(id, pos, src, L) over the cases of tests/test_scatter_kernel.py and
    the edges of csrc/scatter.cu's output tiles and walk chunks (the one
    copy of both lists is torch_plans')."""
    return torch_plans.scatter_cases() + torch_plans.scatter_edge_cases(
        tscatter.TILE, tscatter.CHUNK)


SCATTER_CASES = {c[0]: c[1:] for c in _scatter_cases()}


@functools.lru_cache(maxsize=None)
def _scatter_jax(case):
    """The JAX kernel's output for a case, in interpret mode."""
    pos, src, L = SCATTER_CASES[case]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPLAN2VDL_PL_INTERPRET", "1")
        return np.asarray(jscatter.monotone_scatter(jnp.asarray(pos),
                                                    jnp.asarray(src), L))


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_matches_jax(case):
    pos, src, L = SCATTER_CASES[case]
    want = _scatter_jax(case)
    tpos, tsrc = torch.from_numpy(pos), torch.from_numpy(src)
    got = tscatter.monotone_scatter(tpos, tsrc, L)
    assert got.dtype == tsrc.dtype and got.shape == (L,)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tscatter.monotone_scatter_plain(tpos.long(), tsrc, L)
    np.testing.assert_array_equal(plain.numpy(), want)


def _scatter_model(pos, src, L, per_block):
    """numpy statement of csrc/scatter.cu's partition.  Blocks own spans of
    ``per_block`` output tiles of TILE slots.  Warp 0 finds the span's first
    source row by a 32-ary search.  Each tile takes the rows walked from
    there in CHUNK-row steps, up to the first step that holds a position
    past the tile (or until the tile is full).  The rows of a step that
    land in the tile must be a prefix of the step.  The tile is staged
    zeroed and stored whole, so every slot is stored exactly once."""
    T, C = tscatter.TILE, tscatter.CHUNK
    n = len(pos)
    p64 = pos.astype(np.int64)
    lanes = np.arange(32)

    def at(i):  # positions of rows i, past the end as +inf
        return np.where(i < n, p64[np.clip(i, 0, max(n - 1, 0))] if n
                        else 0, np.iinfo(np.int64).max)

    def first_row_at(target):
        lo, hi = 0, n
        while hi - lo > 32:
            step = -(-(hi - lo) // 32)
            i = lo + (lanes + 1) * step - 1
            ge = (i >= hi) | (at(np.minimum(i, hi)) >= target)
            if not ge.any():
                return hi
            f = int(np.argmax(ge))
            hi = min(lo + (f + 1) * step - 1, hi)
            lo += f * step
        i = lo + lanes
        ge = (i >= hi) | (at(np.minimum(i, hi)) >= target)
        return lo + int(np.argmax(ge)) if ge.any() else hi

    tiles = -(-L // T)
    out = np.zeros(L, src.dtype)
    stores = np.zeros(L, np.int64)
    for t0 in range(0, tiles, per_block):
        row = first_row_at(t0 * T)
        assert row == int(np.searchsorted(np.minimum(p64, L), t0 * T))
        for t in range(t0, min(t0 + per_block, tiles)):
            lo = t * T
            m = min(T, L - lo)
            tile = np.zeros(T, src.dtype)
            staged, steps = 0, 0
            while True:
                i = row + np.arange(C)
                p = at(i)
                hit = (p >= lo) & (p < lo + m)
                c = int(hit.sum())
                assert hit[:c].all(), "a step's in-tile rows are no prefix"
                tile[p[hit] - lo] = src[i[hit]]
                row, staged, steps = row + c, staged + c, steps + 1
                if c < C or staged == m:
                    break
            assert staged <= m and steps <= m // C + 1
            out[lo:lo + m] = tile[:m]
            stores[lo:lo + m] += 1
    assert (stores == 1).all()
    return out


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_partition_matches_jax(case):
    """The tile -> source-run split of csrc/scatter.cu, with one tile, a
    few tiles and every tile per block, against the JAX kernel."""
    pos, src, L = SCATTER_CASES[case]
    want = _scatter_jax(case)
    tiles = -(-L // tscatter.TILE)
    for per_block in sorted({1, 2, 3, tiles}):
        np.testing.assert_array_equal(
            _scatter_model(pos, src, L, per_block), want)


def test_scatter_model_edges():
    """No rows, no slots, and rows that all fall outside the slots."""
    pos = np.array([5, 9, 9], np.int32)
    src = np.array([1, 2, 3], np.int32)
    assert _scatter_model(pos[:0], src[:0], 5000, 1).tolist() == [0] * 5000
    assert _scatter_model(pos, src, 0, 1).tolist() == []
    assert _scatter_model(pos, src, 5, 1).tolist() == [0] * 5
    assert tscatter.monotone_scatter(torch.from_numpy(pos),
                                     torch.from_numpy(src), 0).shape == (0,)


def test_scatter_rejects_bad_input():
    p = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tscatter.monotone_scatter(p, torch.zeros(4, dtype=torch.float32), 4)
    with pytest.raises(ValueError):
        tscatter.monotone_scatter(p, torch.zeros(3, dtype=torch.int32), 4)
    assert tscatter.monotone_scatter(p[:0], p[:0], 3).tolist() == [0, 0, 0]


# ------------------------------------------------------- fused aggregate
def _pad(a, block=jmultiagg.BLOCK, fill=0):
    m = -(-len(a) // block) * block
    out = np.full(m, fill, a.dtype)
    out[:len(a)] = a
    return out


def _q1_like(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    cols = [rng.integers(100, 500_000, n).astype(np.int32),
            rng.integers(90_000, 11_000_000, n).astype(np.int32),
            rng.integers(0, 11, n).astype(np.int32),
            rng.integers(0, 9, n).astype(np.int32)]
    gid = rng.integers(0, 6, n).astype(np.int32)
    gid[rng.random(n) < 0.3] = -1  # masked-out rows
    specs = [
        dict(base=0, bits=20),
        dict(base=1, bits=24),
        dict(base=1, factors=((100, -1, 2),), bits=31),
        dict(base=1, factors=((100, -1, 2), (100, 1, 3)), bits=38),
        dict(base=2, bits=4),
        dict(base=None, bits=1),
        dict(base=0, bits=31, op="max"),
    ]
    return cols, gid, specs, 6, jmultiagg.BLOCK


def _extremes():
    n = 2048
    cols = [np.full(n, 2**31 - 1, np.int32), np.zeros(n, np.int32)]
    specs = [dict(base=0, factors=((100, -1, 1), (100, 1, 1)), bits=45)]
    return cols, np.zeros(n, np.int32), specs, 1, 2048


def _q1_groups(seed, groups, one_group=False):
    """Q1-like columns and nine specs of Q1's shapes (sums, counts, maxes) over
    ``groups`` groups, or with every row in group 3 (the most contention
    for a per-row update of shared cells)."""
    cols, gid, specs, _, block = _q1_like(seed)
    rng = np.random.default_rng(seed + 100)
    gid = rng.integers(-1, groups, len(gid)).astype(np.int32)
    if one_group:
        gid[:] = 3
    specs = specs + [dict(base=3, bits=31, op="max"), dict(base=0, bits=20)]
    return cols, gid, specs, groups, block


AGG_CASES = {0: lambda: _q1_like(0), 1: lambda: _q1_like(1),
             2: lambda: _q1_like(2), "extremes": _extremes,
             "groups-16": lambda: _q1_groups(3, 16),
             "one-group": lambda: _q1_groups(4, 8, one_group=True)}


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_fused_group_aggregate_matches_jax(case):
    cols, gid, specs, groups, block = AGG_CASES[case]()
    want = np.asarray(jmultiagg.fused_group_aggregate(
        [jnp.asarray(_pad(c, block)) for c in cols],
        jnp.asarray(_pad(gid, block, fill=-1)),
        [jmultiagg.AggSpec(**s) for s in specs], groups, block=block,
        interpret=True))
    got = tmultiagg.fused_group_aggregate(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid),
        [tmultiagg.AggSpec(**s) for s in specs], groups)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_lane_path_takes_every_engine_family(monkeypatch):
    """The kernel's fast path (lane-private tables) takes every family that
    fuse.plan_fusions can emit at Q1's shape, alone and split as the MXU
    routing splits it; the general path takes the rest."""
    from mplan2vdl_tpu_torch.engine import datagen, fuse, lower

    assert tmultiagg.LANE_MAX_GROUPS == fuse.MAX_DOMAIN
    st = datagen.generate(sf=0.01, seed=7)
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "1")
    cq = lower.compile_plan_text(torch_plans.PLAN_Q1, st.make_catalog(), st,
                                 device="cpu")
    (fam,) = cq.families
    specs = list(fam.specs) + [tmultiagg.AggSpec(base=None, bits=1)]
    assert (fam.domain, len(specs)) == (8, 9)
    maxes = [s for s in specs if s.op == "max"]
    for groups in range(1, fuse.MAX_DOMAIN + 1):
        for k in (len(specs), len(maxes), 1):
            assert tmultiagg.lane_path(groups, k), (groups, k)
    assert not tmultiagg.lane_path(fuse.MAX_DOMAIN + 1, len(specs))
    assert not tmultiagg.lane_path(8, tmultiagg.LANE_MAX_SPECS + 1)
    assert tmultiagg.lane_path(16, tmultiagg.LANE_MAX_SPECS)


def test_spec_words_layout():
    specs = [tmultiagg.AggSpec(base=3, factors=((100, -1, 4), (7, 1, 0))),
             tmultiagg.AggSpec(base=None, bits=1),
             tmultiagg.AggSpec(base=1, bits=31, op="max")]
    assert tmultiagg.spec_words(specs) == [0, 3, 2, 100, -1, 4, 7, 1, 0,
                                           0, -1, 0, 1, 1, 0]
    assert [s.nlimb for s in specs] == [2, 1, 1]


# ------------------------------------------- tensor-core fused aggregate
def _mxu_q1(seed, n, groups):
    """tests/test_multiagg_mxu.py's Q1-shaped family."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(-1, groups, size=n).astype(np.int32)
    cols = [rng.integers(0, 5100, size=n).astype(np.int32),
            rng.integers(0, 10_000_000, size=n).astype(np.int32),
            rng.integers(0, 11, size=n).astype(np.int32),
            rng.integers(0, 9, size=n).astype(np.int32)]
    specs = [dict(base=0, bits=13), dict(base=1, bits=24),
             dict(base=1, factors=((100, -1, 2),), bits=32),
             dict(base=1, factors=((100, -1, 2), (100, 1, 3)), bits=41),
             dict(base=2, bits=4), dict(base=None, bits=1)]
    return cols, gid, specs, groups


def _mxu_near_bound():
    rng = np.random.default_rng(3)
    n, groups = 40_000, 3
    gid = rng.integers(0, groups, size=n).astype(np.int32)
    cols = [np.full(n, 2**31 - 1, dtype=np.int32),
            np.full(n, 32766, dtype=np.int32)]
    specs = [dict(base=0, bits=31), dict(base=0, factors=((1, 1, 1),),
                                          bits=46)]
    return cols, gid, specs, groups


def _mxu_specs(seed, n, k):
    """The Q1-shaped family's specs repeated to ``k`` sum specs."""
    cols, gid, specs, groups = _mxu_q1(seed, n, 8)
    return cols, gid, (specs * 3)[:k], groups


MXU_CASES = {"q1-shape": lambda: _mxu_q1(0, 60_000, 4),
             "odd-tail": lambda: _mxu_q1(1, 30_001, 7),
             "near-bits-bound": _mxu_near_bound,
             **{f"fuzz-{seed}": (lambda seed=seed: _mxu_q1(
                 seed, 17_000 + seed * 997, 2 + seed % 6))
                for seed in range(4, 10)},
             "groups-37": lambda: _mxu_q1(11, 20_000, 37),
             "groups-16": lambda: _mxu_q1(12, 20_001, 16),
             "groups-17": lambda: _mxu_q1(13, 20_003, 17),
             "specs-12": lambda: _mxu_specs(14, 10_001, 12),
             "specs-13": lambda: _mxu_specs(15, 10_003, 13)}


@pytest.mark.parametrize("case", list(MXU_CASES))
def test_mxu_aggregate_matches_jax(case):
    """The port's CPU path (the plain version of the tensor-core kernel)
    against the JAX MXU kernel in interpret mode and the reference."""
    cols, gid, specs, groups = MXU_CASES[case]()
    want = np.asarray(jmxu.fused_group_aggregate_mxu(
        [jnp.asarray(c) for c in cols], jnp.asarray(gid),
        [jmultiagg.AggSpec(**s) for s in specs], groups, interpret=True))
    ref = np.asarray(jmultiagg.reference_group_aggregate(
        cols, gid, [jmultiagg.AggSpec(**s) for s in specs], groups))
    got = tmxu.fused_group_aggregate_mxu(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid),
        [tmultiagg.AggSpec(**s) for s in specs], groups)
    assert got.dtype == torch.int64 and got.shape == (groups, len(specs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref)


def _fast_path_model(cols, gid, specs, groups):
    """numpy statement of what the kernel's fast path computes from the
    wrapper's fast_args: each spec's value in 32-bit arithmetic when it has
    at most 4 byte planes (exact modulo 2^32), else 64-bit; its byte
    planes contracted with the one-hot of the group id in int32 partial
    sums over FLUSH_STEPS warp steps; then sum_k plane_k << 8k, wrapping."""
    used, words, heads = tmxu.fast_args(specs)
    staged = [np.asarray(cols[i]) for i in used]
    n = len(gid)
    onehot = (np.asarray(gid)[:, None] == np.arange(groups)).astype(np.int64)
    flush = tmxu.FLUSH_STEPS * tmxu.FAST_STEP_ROWS
    out = np.zeros((groups, len(specs)), np.uint64)
    for s, (base, nf, w, plane, nplanes) in enumerate(heads):
        u, width = (np.uint32, 32) if nplanes <= 4 else (np.uint64, 64)
        v = (np.ones(n, u) if base < 0
             else staged[base].astype(np.int64).astype(u))
        for f in range(nf):
            c, sign, slot = words[w + 3 * f: w + 3 * f + 3]
            v = v * (u(c % 2**width) + u(sign % 2**width)
                     * staged[slot].astype(np.int64).astype(u))
        for k in range(nplanes):
            byte = ((v >> u(8 * k)) & u(0xFF)).astype(np.int64)
            for r0 in range(0, n, flush):
                part = byte[r0:r0 + flush] @ onehot[r0:r0 + flush]
                assert part.max(initial=0) < 2**31
                out[:, s] += part.astype(np.uint64) << np.uint64(8 * k)
    return out.view(np.int64)


@pytest.mark.parametrize("case", ["q1-shape", "odd-tail", "near-bits-bound",
                                  "groups-16", "specs-12"])
def test_mxu_fast_path_arithmetic(case):
    """The fast path's arithmetic (32-bit values for specs of at most 4
    planes, the wrapper's column slots, factor words and heads) against the
    plain version."""
    cols, gid, specs, groups = MXU_CASES[case]()
    specs = [tmultiagg.AggSpec(**s) for s in specs]
    assert tmxu.fast_path(groups, specs)
    want = tmxu.fused_group_aggregate_mxu_plain(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), specs,
        groups)
    np.testing.assert_array_equal(_fast_path_model(cols, gid, specs, groups),
                                  want.numpy())


def test_mxu_fast_args_layout():
    """What the wrapper computes for the fast path: the used columns in
    order of first use, the factor triples renumbered to their slots, the
    per-spec heads at the planes of plane_offsets, and a flush interval
    that keeps every int32 fragment cell below 2^31."""
    S = tmultiagg.AggSpec
    specs = [S(base=3, bits=13),
             S(base=5, factors=((100, -1, 4), (100, 1, 3)), bits=41),
             S(base=None, bits=1),
             S(base=None, factors=((7, 1, 4),), bits=12),
             S(base=5, bits=64)]
    used, words, heads = tmxu.fast_args(specs)
    assert used == [3, 5, 4]
    assert words == [100, -1, 2, 100, 1, 0, 7, 1, 2]
    assert tmxu.plane_offsets(specs) == [0, 2, 8, 9, 11, 19]
    assert heads == [(0, 0, 0, 0, 2), (1, 2, 0, 2, 6), (-1, 0, 6, 8, 1),
                     (-1, 1, 6, 9, 2), (1, 0, 9, 11, 8)]
    assert all(1 <= h[4] <= 8 for h in heads)
    # a cell gains at most 255 per row of a warp step
    assert tmxu.FAST_STEP_ROWS == 32 * 4
    assert tmxu.FLUSH_STEPS * tmxu.FAST_STEP_ROWS == tmxu.FLUSH_ROWS
    assert 255 * tmxu.FAST_STEP_ROWS * tmxu.FLUSH_STEPS < 2**31
    assert tmxu.fast_args([S(base=None, bits=1)]) == ([], [],
                                                      [(-1, 0, 0, 0, 1)])


def test_mxu_fast_path_takes_every_engine_family(monkeypatch):
    """The tensor-core kernel's fast path takes every sum family that
    fuse.plan_fusions can emit at Q1's shape under the MXU routing (the
    family's sums with the appended count), at 1 to fuse.MAX_DOMAIN
    groups; 17 groups and 13 sum specs take the general path."""
    from mplan2vdl_tpu_torch.engine import datagen, fuse, lower

    assert tmxu.FAST_MAX_GROUPS == fuse.MAX_DOMAIN
    st = datagen.generate(sf=0.01, seed=7)
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", "1")
    cq = lower.compile_plan_text(torch_plans.PLAN_Q1, st.make_catalog(), st,
                                 device="cpu")
    (fam,) = cq.families
    specs = list(fam.specs) + [tmultiagg.AggSpec(base=None, bits=1)]
    sums = [s for s in specs if s.op == "sum"]
    assert (fam.domain, len(sums), tmxu.plane_offsets(sums)[-1]) == (8, 7,
                                                                     17)
    for groups in range(1, fuse.MAX_DOMAIN + 1):
        for k in range(1, len(sums) + 1):
            assert tmxu.fast_path(groups, sums[:k]), (groups, k)
    assert not tmxu.fast_path(fuse.MAX_DOMAIN + 1, sums)
    assert not tmxu.fast_path(8, (sums * 2)[:tmxu.FAST_MAX_SPECS + 1])
    assert tmxu.fast_path(16, (sums * 2)[:tmxu.FAST_MAX_SPECS])


def test_mxu_aggregate_refuses_max_specs():
    cols = [torch.arange(10, dtype=torch.int32)]
    gid = torch.zeros(10, dtype=torch.int32)
    specs = [tmultiagg.AggSpec(base=0, bits=4),
             tmultiagg.AggSpec(base=0, bits=4, op="max")]
    with pytest.raises(ValueError, match="sums only"):
        tmxu.fused_group_aggregate_mxu(cols, gid, specs, 1)
    assert tmxu.plane_offsets(specs[:1] + [
        tmultiagg.AggSpec(base=None, bits=1),
        tmultiagg.AggSpec(base=0, bits=46)]) == [0, 1, 2, 8]


def test_mxu_switch(monkeypatch):
    """Read as the JAX engine reads MPLAN2VDL_MXU_AGG; off by default."""
    for value, on in ((None, False), ("", False), ("0", False), ("1", True)):
        if value is None:
            monkeypatch.delenv("MPLAN2VDL_MXU_AGG", raising=False)
        else:
            monkeypatch.setenv("MPLAN2VDL_MXU_AGG", value)
        assert tmxu.mxu_agg_on() is on is jmxu.mxu_agg_on()


# ------------------------------------------------- segmented reductions
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_masked_group_reduce_with_counts_matches_jax(op, dtype):
    rng = np.random.default_rng(11)
    n, domain = 3000, 7
    info = np.iinfo(dtype)
    data = rng.integers(info.min // 4, info.max // 4, n).astype(dtype)
    ids = rng.integers(0, domain + 1, n)  # domain = masked-out slot
    ids[:5] = 3  # group 6 may stay empty; group 3 never does
    jagg, jcnt = jsegred.masked_group_reduce_with_counts(
        jnp.asarray(data), jnp.asarray(ids), domain, op)
    tagg, tcnt = tsegred.masked_group_reduce_with_counts(
        torch.from_numpy(data), torch.from_numpy(ids), domain, op)
    np.testing.assert_array_equal(tagg.numpy(), np.asarray(jagg))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))


# ------------------------------------------- prefix sums and searches
@pytest.mark.parametrize("dtype,n", [(np.int32, 1), (np.int32, 5000),
                                     (np.int64, 5000)])
def test_cumsum_matches_jax(dtype, n):
    from mplan2vdl_tpu.engine import scan as jscan
    from mplan2vdl_tpu_torch.engine import scan as tscan

    rng = np.random.default_rng(12)
    x = rng.integers(-1000, 1000, n).astype(dtype)
    want = np.asarray(jscan.cumsum(jnp.asarray(x)))
    got = tscan.cumsum(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    flags = (x > 0).astype(np.int32)
    want = np.asarray(jscan.cumsum_flags(jnp.asarray(flags)))
    got = tscan.cumsum_flags(torch.from_numpy(flags))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_fast_matches_jax(side):
    from mplan2vdl_tpu.engine import mergesearch as jms
    from mplan2vdl_tpu_torch.engine import mergesearch as tms

    rng = np.random.default_rng(13)
    table = np.sort(rng.integers(0, 500, 300)).astype(np.int32)
    queries = rng.integers(-10, 510, 4000).astype(np.int32)
    want = np.asarray(jms.searchsorted_fast(jnp.asarray(table),
                                            jnp.asarray(queries), side))
    got = tms.searchsorted_fast(torch.from_numpy(table),
                                torch.from_numpy(queries), side)
    np.testing.assert_array_equal(got.numpy(), want)
