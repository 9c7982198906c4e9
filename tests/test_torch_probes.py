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
def _keys(kind, n):
    if kind == "random":
        return np.random.default_rng(5).integers(0, 1 << 24, n,
                                                 dtype=np.int32)
    if kind == "all-equal":
        return np.full(n, 0xABCDEF, np.int32)
    return np.arange(n, dtype=np.int32)


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


@pytest.mark.parametrize("kind", ["random", "all-equal", "ascending"])
@pytest.mark.parametrize("nbits,n", [(4, 16384), (8, 8192)])
def test_radix_rank_matches_jax(monkeypatch, nbits, n, kind):
    jtool = _load_tool("probe_radix")
    monkeypatch.setattr(jtool.pl, "pallas_call", functools.partial(
        jtool.pl.pallas_call, interpret=True))
    x = _keys(kind, n)
    want_sum = int(jtool.rank_kernel(nbits)(jnp.asarray(x)))
    got = rr.radix_rank(torch.from_numpy(x), nbits)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), _rank_numpy(x, nbits))
    assert int(rr.radix_rank_checksum(got)) == want_sum


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
