"""The port's two probe kernels and tools against the JAX package's probes,
on the CPU.

``radix_rank`` (the plain version its wrapper runs for CPU tensors) against
``tools/probe_radix.rank_kernel`` and a numpy statement of the rank; the
twelve kernel-pattern probes of ``tools/probe_kernels`` against
``tools/probe_mosaic`` (same inputs, same numpy answers).  The JAX tools are
loaded by file path and run in interpret mode.  Every comparison is exact
(the values are integers).  The CUDA kernels run only on the GPU, where
chip_smoke.py holds them against these plain versions.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mplan2vdl_tpu_torch.engine.kernels import probes as P
from mplan2vdl_tpu_torch.engine.kernels import radix_rank as rr
from mplan2vdl_tpu_torch.tools import probe_kernels, probe_radix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -------------------------------------------------------------- digit rank
KINDS = ["random", "all-equal", "ascending", "alternating", "warp-boundary"]
# (nbits, n): every digit width of the contract
WIDTHS = [(4, 16384), (8, 8192), (1, 16384), (2, 16384), (3, 16384),
          (5, 8192), (6, 8192), (7, 8192)]


def _keys(kind, n):
    if kind == "random":
        return np.random.default_rng(5).integers(0, 1 << 24, n,
                                                 dtype=np.int32)
    if kind == "all-equal":
        return np.full(n, 0xABCDEF, np.int32)
    if kind == "alternating":  # two digits that differ in every bit
        return np.where(np.arange(n) % 2 == 0, 0x5A5A5A5A,
                        0x25A5A5A5).astype(np.int32)
    if kind == "warp-boundary":  # the digit changes at each 1024-key run
        return (np.arange(n) // rr.WARP_KEYS).astype(np.int32)
    return np.arange(n, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _rank_jax(nbits, n, kind):
    """The JAX probe's checksum of the rank, in interpret mode."""
    jtool = _load_tool("probe_radix")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtool.pl, "pallas_call", functools.partial(
            jtool.pl.pallas_call, interpret=True))
        return int(jtool.rank_kernel(nbits)(jnp.asarray(_keys(kind, n))))


def _rank_numpy(x, nbits):
    """Per 8192-element block, each element's 1-based position among the
    equal digits of its block, by a stable sort on the digit."""
    d = (x & ((1 << nbits) - 1)).reshape(-1, rr.BLOCK)
    out = np.empty_like(d)
    for b, row in enumerate(d):
        order = np.argsort(row, kind="stable")
        s = row[order]
        head = np.r_[True, s[1:] != s[:-1]]
        start = np.maximum.accumulate(np.where(head, np.arange(len(s)), 0))
        out[b, order] = np.arange(len(s)) - start + 1
    return out.reshape(-1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nbits,n", WIDTHS)
def test_radix_rank_matches_jax(nbits, n, kind):
    x = _keys(kind, n)
    got = rr.radix_rank(torch.from_numpy(x), nbits)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), _rank_numpy(x, nbits))
    assert int(rr.radix_rank_checksum(got)) == _rank_jax(nbits, n, kind)


def _rank_model(x, nbits):
    """numpy statement of csrc/radix_rank.cu.  A block's 8192 keys are 8
    warps' runs of WARP_KEYS = 1024; lane l of a warp holds keys
    r * 32 + l of its run (r < 32).  Round r: the lanes sharing a lane's
    digit are the AND of nbits ballots (each bit's ballot, or its
    complement); the lane's rank is the count of those peers at or below
    it plus the warp's running count of its digit, which the round's peers
    then raise by their number.  After the rounds, each warp's digit
    counts are scanned across the 8 warps (exclusive) and added."""
    R = 1 << nbits
    W = rr.BLOCK // rr.WARP_KEYS
    d = (x & (R - 1)).reshape(-1, W, rr.WARP_KEYS // 32, 32)
    blocks = d.shape[0]
    lanes = np.arange(32, dtype=np.uint64)
    at_or_below = ((np.uint64(2) << lanes) - np.uint64(1)).astype(np.uint32)
    weights = (np.uint64(1) << lanes)
    running = np.zeros((blocks, W, R), np.int64)
    rank = np.empty(d.shape, np.int64)
    for r in range(d.shape[2]):
        dig = d[:, :, r, :]                                   # [B, W, 32]
        peers = np.full(dig.shape, 0xFFFFFFFF, np.uint32)
        for b in range(nbits):
            bit = (dig >> b) & 1
            ballot = (bit.astype(np.uint64) * weights).sum(-1).astype(
                np.uint32)[..., None]
            peers &= np.where(bit == 1, ballot, ~ballot)
        below = np.bitwise_count(peers & at_or_below).astype(np.int64)
        assert (below >= 1).all()                     # a lane is its own peer
        rank[:, :, r, :] = np.take_along_axis(running, dig, axis=2) + below
        for lane in range(32):      # the round's peers raise their count
            np.add.at(running, (np.arange(blocks)[:, None],
                                np.arange(W)[None, :], dig[:, :, lane]), 1)
    assert (running.sum(-1) == rr.WARP_KEYS).all()
    offset = np.cumsum(running, axis=1) - running            # [B, W, R]
    rank += np.take_along_axis(offset, d.reshape(blocks, W, -1), axis=2
                               ).reshape(d.shape)
    return rank.reshape(-1).astype(np.int32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nbits,n", WIDTHS)
def test_radix_rank_partition_matches_jax(nbits, n, kind):
    """The kernel's warp-local ranks, per-warp counts and cross-warp
    offsets, against the JAX probe's checksum and the plain version."""
    x = _keys(kind, n)
    got = _rank_model(x, nbits)
    np.testing.assert_array_equal(
        got, rr.radix_rank_plain(torch.from_numpy(x), nbits).numpy())
    assert int(rr.radix_rank_checksum(torch.from_numpy(got))) == _rank_jax(
        nbits, n, kind)


def test_radix_rank_rejects_bad_input():
    with pytest.raises(ValueError, match="multiple of 8192"):
        rr.radix_rank(torch.zeros(8191, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="nbits"):
        rr.radix_rank(torch.zeros(8192, dtype=torch.int32), 9)
    with pytest.raises(TypeError):
        rr.radix_rank(torch.zeros(8192, dtype=torch.int64), 4)


# ------------------------------------------------------- pattern probes
@pytest.fixture(scope="module")
def mosaic():
    """name -> (ok, want, inputs) of each probe of tools/probe_mosaic.py,
    run in interpret mode."""
    jtool = _load_tool("probe_mosaic")
    seen = {}
    run_probe = jtool.run_probe

    def record(name, kernel, out_shape, want, *args):
        ok = run_probe(name, kernel, out_shape, want, *args)
        seen[name] = (ok, want, [np.asarray(a) for a in args])
        return ok

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtool, "INTERPRET", True)
        mp.setattr(jtool, "run_probe", record)
        jtool.main()
    return seen


PROBES = ["transpose_16x128", "reshape_to_1xSC", "reshape_to_SCx1",
          "dot_general_2d_contract", "masked_lane_dot",
          "strided_sublane_slice", "stack_plus_dot_general",
          "dot_abT_contract_lanes", "matmul_with_rhs_T", "reshape_stack_dot",
          "take_along_axis_wide1024", "take_flat_vector"]


@pytest.mark.parametrize("name", PROBES)
def test_probe_matches_mosaic_probe(mosaic, name):
    ok, want, args = mosaic[name]
    assert ok, f"the JAX probe {name} failed in interpret mode"
    mine = [p for p in probe_kernels.make_probes("cpu")
            if p.name.split(" [")[0] == name]
    assert len(mine) == (2 if name in ("masked_lane_dot",
                                       "stack_plus_dot_general",
                                       "dot_abT_contract_lanes") else 1)
    for p in mine:
        np.testing.assert_array_equal(p.want, want)
        assert p.want.dtype == want.dtype
        assert len(p.inputs) == len(args)
        for t, a in zip(p.inputs, args):
            np.testing.assert_array_equal(t.numpy(), a)
        assert probe_kernels.check(p), p.name  # the wrappers, on the CPU
        assert probe_kernels.check(p, P.PLAIN), p.name


def test_probe_names_are_the_originals(mosaic):
    assert list(mosaic) == PROBES
    assert [p.name.split(" [")[0] for p in probe_kernels.make_probes("cpu")
            if "[" not in p.name] == PROBES


# ------------------------------------------- one launch a probe (models)
def _mode(name, args):
    """The rhs mode of a recorded contraction call."""
    return args[5] if name == "fma_contract" else args[6]


class _Recorder:
    """The plain versions under the wrappers' names, each call recorded."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(P.PLAIN, name)

        def call(*args, **kw):
            self.calls.append((name, args, kw))
            return fn(*args, **kw)
        return call


# the wrapper and rhs mode each probe run calls once
CALLS = {"transpose_16x128": ("transpose", None),
         "reshape_to_1xSC": ("rows_copy", None),
         "reshape_to_SCx1": ("rows_copy", None),
         "dot_general_2d_contract": ("fma_contract", P.RHS_ROWS),
         "masked_lane_dot": ("fma_contract", P.RHS_ONEHOT),
         "masked_lane_dot [mma u8]": ("mma_contract", P.RHS_ONEHOT),
         "strided_sublane_slice": ("rows_copy", None),
         "stack_plus_dot_general": ("fma_contract", P.RHS_ONEHOT),
         "stack_plus_dot_general [mma u8]": ("mma_contract", P.RHS_ONEHOT),
         "dot_abT_contract_lanes": ("fma_contract", P.RHS_ROWS),
         "dot_abT_contract_lanes [mma u8]": ("mma_contract", P.RHS_ROWS),
         "matmul_with_rhs_T": ("fma_contract", P.RHS_ROWS_T),
         "reshape_stack_dot": ("fma_contract", P.RHS_KEY),
         "take_along_axis_wide1024": ("take", None),
         "take_flat_vector": ("take", None)}


@pytest.mark.parametrize("name", list(CALLS))
def test_probe_is_one_call(mosaic, name):
    """Each probe run calls one wrapper once (one kernel launch on the
    card): probe 9's transpose runs inside its contraction (RHS_ROWS_T),
    and the plain version of that call gives the JAX probe's answer."""
    probe, = [p for p in probe_kernels.make_probes("cpu") if p.name == name]
    rec = _Recorder()
    got = probe.run(rec).numpy()
    assert [c[0] for c in rec.calls] == [CALLS[name][0]]
    if CALLS[name][1] is not None:
        assert _mode(*rec.calls[0][:2]) == CALLS[name][1]
    want = mosaic[name.split(" [")[0]][1]
    np.testing.assert_array_equal(got.astype(want.dtype), want)


def _rhs_dense(rhs, mode, batch, n, k, key):
    """numpy [batch, n, k] int64 of a contraction's rhs."""
    if mode in (P.RHS_ROWS, P.RHS_ROWS_T):
        return rhs.reshape(batch, n, k).astype(np.int64)
    keys = rhs.reshape(batch, 1, k)
    want = np.arange(n).reshape(1, n, 1) if mode == P.RHS_ONEHOT else key
    return np.broadcast_to((keys == want).astype(np.int64), (batch, n, k))


def _fma_model(a, rhs, m, n, k, mode, key=0, batch=1):
    """numpy statement of csrc/probes.cu's fma_kernel: block (b, i) gives
    thread t the contraction rows t, t + FMA_THREADS, ... in float32; mode
    RHS_ROWS_T first stages the rhs chunk by chunk as its transpose, t[c *
    stride + j] with stride n | 1, each (j, c) stored once; each warp sums
    its 32 threads by xor shuffles, and the block its 8 warps in order."""
    T, W = P.FMA_THREADS, P.FMA_THREADS // 32
    A = a.reshape(batch * m, k).astype(np.float32)
    R = _rhs_dense(rhs, mode, batch, n, k, key)
    if mode == P.RHS_ROWS_T:
        stride = n | 1
        kc = P.STAGE_WORDS // stride // T * T
        staged = np.empty((batch, n, k), np.int64)
        for k0 in range(0, k, kc):
            rows = min(kc, k - k0)
            e = np.arange(n * rows)
            j, c = e // rows, e % rows
            slot = c * stride + j
            assert len(np.unique(slot)) == len(slot) and \
                slot.max() < P.STAGE_WORDS
            t = np.zeros((batch, P.STAGE_WORDS), np.int64)
            t[:, slot] = R[:, j, k0 + c]
            cc = np.arange(rows)
            staged[:, :, k0 + cc] = t[:, (cc * stride)[None, :]
                                      + np.arange(n)[:, None]]
        np.testing.assert_array_equal(staged, R)
        R = staged
    if mode == P.RHS_KEY:  # one sum, stored in every column
        R = R[:, :1]
    pad = -k % T
    A = np.pad(A, ((0, 0), (0, pad))).reshape(batch * m, -1, T)
    R = np.pad(R.astype(np.float32), ((0, 0), (0, 0), (0, pad))
               ).reshape(batch, R.shape[1], -1, T)
    acc = np.zeros((batch * m, R.shape[1], T), np.float32)
    for step in range(A.shape[1]):
        acc += A[:, None, step, :] * R[np.arange(batch * m) // m, :, step, :]
    lanes = acc.reshape(batch * m, R.shape[1], W, 32)
    for d in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ d]
    out = np.zeros((batch * m, R.shape[1]), np.float32)
    for w in range(W):
        out += lanes[:, :, w, 0]
    return np.broadcast_to(out.reshape(batch, m, -1), (batch, m, n))


def _mma_model(a, nlimb, rhs, m, n, k, mode, key=0, batch=1):
    """numpy statement of csrc/probes.cu's mma_kernel: min(MMA_GROUPS,
    steps) groups of 4 warps a block; group g takes the MMA_STEP_ROWS-row
    steps g, g + G, ...; warp w of a group the step's rows 128 w ..
    128 w + 127 (mma_u8.cuh's contract_step); each warp's cell of plane
    l * m + i and group j is an int32 sum of byte products, and the block
    adds the warps' cells and shifts limb l by 8 l in int64."""
    steps = -(-k // P.MMA_STEP_ROWS)
    G = min(P.MMA_GROUPS, steps)
    r = np.arange(k)
    warp = 4 * ((r // P.MMA_STEP_ROWS) % G) + (r % P.MMA_STEP_ROWS) // 128
    A = a.reshape(batch, m, k).astype(np.int64)
    planes = np.concatenate([(A >> (8 * l)) & 0xFF for l in range(nlimb)],
                            axis=1)                         # [b, np, k]
    groups = _rhs_dense(rhs, mode, batch, n, k, key) & 0xFF  # [b, n, k]
    cells = np.stack([np.einsum("bpk,bqk->bpq", planes[..., warp == w],
                                groups[..., warp == w])
                      for w in range(4 * G)])               # [w, b, np, n]
    assert cells.max() < 2**31            # no warp's int32 cell overflows
    tot = cells.sum(0).reshape(batch, nlimb, m, n)
    return sum(tot[:, l] << (8 * l) for l in range(nlimb))


def test_mma_warp_cells_stay_below_2_31():
    """At the wrapper's depth bounds, a warp's int32 cell cannot pass 2^31:
    255 * 255 a row in mode RHS_ROWS, 255 in the masks, over its rows."""
    for depth, per_row in ((P.MMA_ROWS_DEPTH, 255 * 255),
                           (P.MMA_MASK_DEPTH, 255)):
        steps = -(-depth // P.MMA_STEP_ROWS)
        G = min(P.MMA_GROUPS, steps)
        rows = -(-steps // G) * 128  # the most rows one warp sums
        assert rows * per_row < 2**31


def _contract_cases():
    import torch_plans

    return {c[0]: c for c in torch_plans.probe_contract_cases()}


@pytest.mark.parametrize("case", list(_contract_cases()))
def test_contract_cases_model_and_plain(case):
    """torch_plans' contraction edge cases (chip_smoke.py holds the kernel
    against the plain version on them): the kernel's model and the plain
    version against numpy's int64 contraction."""
    name, op, a, rhs, kw = _contract_cases()[case]
    kw = dict(kw)
    nlimb = kw.pop("nlimb", None)
    dense = _rhs_dense(rhs, kw["mode"], kw["batch"], kw["n"], kw["k"],
                       kw["key"])
    want = np.einsum("bmk,bnk->bmn",
                     a.reshape(kw["batch"], kw["m"], kw["k"]).astype(
                         np.int64), dense & (0xFF if nlimb else -1))
    A, R = torch.from_numpy(a), torch.from_numpy(rhs)
    if op == "fma":
        assert want.max() < 2**24
        np.testing.assert_array_equal(_fma_model(a, rhs, **kw), want)
        got = P.fma_contract(A, R, **kw)
    else:
        np.testing.assert_array_equal(_mma_model(a, nlimb, rhs, **kw), want)
        got = P.mma_contract(A, nlimb, R, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def _fake_card(monkeypatch):
    """Sends the wrappers down their card path on CPU tensors, with a
    numpy "device" behind _lib.call: each C entry reads its inputs from
    their pointers, runs the kernel's model and writes its output.  Every
    output starts as garbage (torch.empty), and torch.zeros raises, so a
    kernel that leaves an output unwritten or a wrapper that fills one
    first fails.  Returns the list of entries called."""
    P._templates.clear()
    import ctypes

    def arr(ptr, n, dt):
        ct = {np.int32: ctypes.c_int32, np.int64: ctypes.c_int64,
              np.float32: ctypes.c_float}[dt]
        return np.ctypeslib.as_array((ct * n).from_address(ptr))

    def transpose(x, rows, cols, out, s):
        arr(out, rows * cols, np.int32)[:] = arr(
            x, rows * cols, np.int32).reshape(rows, cols).T.reshape(-1)
        return 0

    def rows_copy(x, src_cols, row0, step, rows, cols, out, s):
        r, c = np.arange(rows)[:, None], np.arange(cols)[None, :]
        idx = (row0 + r * step) * src_cols + c
        arr(out, rows * cols, np.int32)[:] = arr(
            x, int(idx.max()) + 1, np.int32)[idx].reshape(-1)
        return 0

    def fma(a, rhs, batch, m, n, k, mode, key, out, s):
        nr = batch * n * k if mode <= P.RHS_ROWS_T else batch * k
        arr(out, batch * m * n, np.float32)[:] = _fma_model(
            arr(a, batch * m * k, np.int32), arr(rhs, nr, np.int32), m, n,
            k, mode, key, batch).reshape(-1)
        return 0

    def mma(a, nlimb, rhs, batch, m, n, k, mode, key, out, s):
        nr = batch * n * k if mode == P.RHS_ROWS else batch * k
        arr(out, batch * m * n, np.int64)[:] = _mma_model(
            arr(a, batch * m * k, np.int32), nlimb, arr(rhs, nr, np.int32),
            m, n, k, mode, key, batch).reshape(-1)
        return 0

    def take(table, tn, idx, m, blocks, out, s):
        i = np.clip(arr(idx, m, np.int32), 0, tn - 1)
        arr(out, m, np.int32)[:] = arr(table, tn, np.int32)[i]
        return 0

    device = {"m2v_probe_transpose": transpose,
              "m2v_probe_rows_copy": rows_copy, "m2v_probe_fma": fma,
              "m2v_probe_mma": mma, "m2v_probe_take": take}
    called = []

    def call(name, *args):
        called.append(name)
        return device[name](*args)

    empty, empty_like = torch.empty, torch.empty_like

    def garbage(*args, **kw):
        return empty(*args, **kw).fill_(-7)

    def garbage_like(t, **kw):
        return empty_like(t, **kw).fill_(-7)

    def no_zeros(*args, **kw):
        raise AssertionError("a wrapper filled an output with torch.zeros")

    monkeypatch.setattr(P, "_on_card", lambda t: True)
    monkeypatch.setattr(P._lib, "call", call)
    monkeypatch.setattr(P._lib, "stream", lambda t: 0)
    monkeypatch.setattr(torch, "empty", garbage)
    monkeypatch.setattr(torch, "empty_like", garbage_like)
    monkeypatch.setattr(torch, "zeros", no_zeros)
    return called


@pytest.mark.parametrize("name", list(CALLS))
def test_card_path_is_one_launch_that_writes_every_output(
        mosaic, monkeypatch, name):
    """Each probe's card path: one launch of its C entry, into an output
    that nothing fills first, and the kernel's model gives the JAX probe's
    answer (mma_contract: no zero fill; probe 9: one launch)."""
    probe, = [p for p in probe_kernels.make_probes("cpu") if p.name == name]
    before = P.launches
    called = _fake_card(monkeypatch)
    got = probe.run(P).numpy()
    monkeypatch.undo()
    assert called == ["m2v_probe_" + CALLS[name][0].split("_contract")[0]]
    assert P.launches == before + 1
    want = mosaic[name.split(" [")[0]][1]
    np.testing.assert_array_equal(got.astype(want.dtype), want)


def test_launch_path_raises_on_a_failed_launch(monkeypatch):
    """The lean launch path still raises on a nonzero return code, names
    the CUDA error, and counts no launch; with the library loaded it takes
    no lock and resolves no entry by name."""
    from mplan2vdl_tpu_torch.engine.kernels import _lib

    class FakeLib:
        def m2v_error_string(self, rc):
            return b"an illegal memory access was encountered"

    entries = {"m2v_probe_transpose": lambda *a: 700}

    class NoLock:
        def __enter__(self):
            raise AssertionError("the loaded library took the lock")

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(_lib, "_lib", FakeLib())
    monkeypatch.setattr(_lib, "_entries", entries)
    monkeypatch.setattr(_lib, "_lock", NoLock())
    monkeypatch.setattr(_lib, "stream", lambda t: 0)
    monkeypatch.setattr(P, "_on_card", lambda t: True)
    before = P.launches
    with pytest.raises(RuntimeError, match=r"probe transpose: CUDA error "
                                           r"700 \(an illegal memory"):
        P.transpose(torch.zeros((4, 8), dtype=torch.int32))
    assert P.launches == before
    assert _lib.call("m2v_probe_transpose", 1) == 700
    with pytest.raises(RuntimeError, match="multiagg: CUDA error 700"):
        _lib.check(700, "multiagg")


def test_importing_the_kernels_builds_nothing():
    """Importing every kernel module (and the probe tools) starts no
    compiler and loads no library: the CPU tests run with no nvcc."""
    import subprocess
    import sys

    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import importlib, pkgutil\n"
        "import mplan2vdl_tpu_torch.engine.kernels as K\n"
        "for m in pkgutil.iter_modules(K.__path__):\n"
        "    importlib.import_module(f'{K.__name__}.{m.name}')\n"
        "import mplan2vdl_tpu_torch.tools.probe_kernels\n"
        "import mplan2vdl_tpu_torch.tools.bench_probes\n"
        "from mplan2vdl_tpu_torch.engine.kernels import _lib\n"
        "assert _lib._lib is None and _lib._entries == {}\n"
        "assert _lib.build_info == {}\n"
        "print('nothing built')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "nothing built"


# -------------------------------------------------------------- the tools
@pytest.mark.parametrize("tool,argv", [
    (probe_kernels, []),
    (probe_radix, ["--sizes", "8192", "--iters", "1"])])
def test_tool_refuses_without_cuda(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def test_tools_run_on_cpu_when_asked(capsys):
    assert probe_kernels.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "15 of 15 probes OK" in out and "WRONG" not in out
    assert probe_radix.main(["--cpu", "--sizes", "8192,16384",
                             "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("ns/el vs torch.sort") == 4
    assert sum(ln.startswith("n=") and "ns/el" in ln
               for ln in out.splitlines()) == 2 * 5 + 4
