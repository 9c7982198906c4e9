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
