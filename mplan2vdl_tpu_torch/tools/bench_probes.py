"""Host and device time of the kernel-pattern probes, each beside the
shortest PyTorch expression of the same function, on one card.

    python -m mplan2vdl_tpu_torch.tools.bench_probes [--turns 5]
        [--reps 200] [--host-calls 10000] [--out FILE]

For each of the fifteen probe runs of ``tools/probe_kernels.py``:

- ``device``: kernels and device microseconds per call, from
  ``torch.profiler``'s device events over ``PROFILE_CALLS`` calls (every
  kernel and copy the call puts on the card, the launch ranges' own spans
  left out);
- ``host_us``: microseconds per call on the host clock over
  ``--host-calls`` calls with no synchronize between them;
- the same two for its library expression (``LIBRARY``: the shortest
  PyTorch expression of the probe's function, with its count of PyTorch
  calls), which is checked against the probe's numpy answer.

``launch_pieces`` times each piece of a launch alone over ``--host-calls``
calls: loading the library, reading the stream handle (the public calls and
the private one beside them), the profiler flag, the wrappers' argument
checks, ``torch.empty``, the ctypes call of the empty kernel's entry, and,
through a small library of its own built into ``build/bench_probes/``
(loaded as a ``CDLL`` and as a ``PyDLL``), a ctypes call that does
nothing, with no argument and with ten, an empty launch with no error
check, and ``cudaGetLastError`` alone.

``turns`` times every probe, its plain version, its library expression and
an empty launch with CUDA events in interleaved turns (probes in order, then
in reverse), so that their medians and the share of the launch bound in
each turn come from the same minutes of the card.  ``chip_smoke.py`` phase
5 runs ``one_kernel_each`` and ``turns``.  Needs one CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List

import torch

from ..engine.kernels import _lib
from ..engine.kernels import probes as P
from . import probe_kernels

S, C = probe_kernels.S, probe_kernels.C
PROFILE_CALLS = 50


def _scatter_sum(rows, vals, gid, groups):
    return torch.zeros(rows, groups, device=vals.device).scatter_add_(
        1, gid.long(), vals.float())


# probe name (without its variant) -> (expression, PyTorch calls, function
# of the probe's inputs); the port never calls these
LIBRARY: Dict[str, tuple] = {
    "transpose_16x128": ("x.t().contiguous()", 2,
                         lambda x: x.t().contiguous()),
    "reshape_to_1xSC": ("x.reshape(1, S*C).clone()", 2,
                        lambda x: x.reshape(1, S * C).clone()),
    "reshape_to_SCx1": ("x.reshape(S*C, 1).clone()", 2,
                        lambda x: x.reshape(S * C, 1).clone()),
    "dot_general_2d_contract": (
        "torch.tensordot(v.float(), m.float(), dims=([1, 2], [1, 2]))", 3,
        lambda v, m: torch.tensordot(v.float(), m.float(),
                                     dims=([1, 2], [1, 2]))),
    "masked_lane_dot": (
        "torch.zeros(S, G).scatter_add_(1, gid.long(), vals.float())", 4,
        lambda vals, gid: _scatter_sum(S, vals, gid, 4)),
    "strided_sublane_slice": ("tall[1::S].contiguous()", 2,
                              lambda tall: tall[1::S].contiguous()),
    "stack_plus_dot_general": (
        "torch.zeros(1, G).scatter_add_(1, gid.reshape(1, -1).long(), "
        "vals.reshape(1, -1).float()).expand(S, G)", 5,
        lambda vals, gid: _scatter_sum(1, vals.reshape(1, -1),
                                       gid.reshape(1, -1), 4).expand(S, 4)),
    "dot_abT_contract_lanes": ("flatv.float() @ flatm.float().T", 3,
                               lambda a, b: a.float() @ b.float().T),
    "matmul_with_rhs_T": ("flatv.float() @ flatm.float().T", 3,
                          lambda a, b: a.float() @ b.float().T),
    "reshape_stack_dot": (
        "(vals3.reshape(R, -1).float() @ (gid.reshape(-1) == 1).float())"
        "[:, None].expand(R, G)", 5,
        lambda v, g: (v.reshape(v.shape[0], -1).float()
                      @ (g.reshape(-1) == 1).float())[:, None].expand(
                          v.shape[0], 4)),
    "take_along_axis_wide1024": ("src.reshape(-1)[idx]", 2,
                                 lambda src, idx: src.reshape(-1)[idx]),
    "take_flat_vector": ("src.reshape(-1)[idx]", 2,
                         lambda src, idx: src.reshape(-1)[idx]),
}


def library(p: probe_kernels.Probe):
    """(expression, PyTorch calls, thunk) of a probe's library yardstick."""
    text, calls, fn = LIBRARY[p.name.split(" [")[0]]
    return text, calls, lambda: fn(*p.inputs)


def cuda_ms(fn: Callable, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls (CUDA events,
    after two warm-up calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn: Callable, calls: int) -> float:
    """Host microseconds per call over ``calls`` calls, no synchronize
    between them (the launch queue may throttle the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def _profiled(fn: Callable, calls: int) -> tuple:
    """(device events, device microseconds, names) of ``calls`` calls in
    the recorded step of torch.profiler, after a warm-up step of as many
    calls under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    n, us, names = 0, 0.0, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False) or e.key.startswith("m2v_"):
            continue
        n += e.count
        us += getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        names[e.key[:80]] = e.count / calls
    return n, us, names


def device(fn: Callable, calls: int = PROFILE_CALLS, tries: int = 3) -> dict:
    """Device work per call under torch.profiler: kernels (and copies) per
    call, device microseconds per call, and the kernels' names.  The
    tracer sometimes drops a session's device events, so the session that
    recorded the most of ``tries`` counts."""
    n, us, names = max((_profiled(fn, calls) for _ in range(tries)),
                       key=lambda r: r[0])
    return {"kernels": n / calls, "device_us": us / calls, "names": names}


def one_kernel_each(probes: List[probe_kernels.Probe],
                    calls: int = 10) -> Dict[str, dict]:
    """Each probe's ``device`` record over ``calls`` calls; raises unless
    the profiler saw exactly ``calls`` device kernels, one a call, for
    every probe.  A session that saw more fails at once; one that saw
    fewer (dropped events) is tried again, up to three times."""
    out, bad = {}, {}
    for p in probes:
        for _ in range(3):
            n, us, names = _profiled(lambda: p.run(P), calls)
            if n >= calls:
                break
        out[p.name] = {"kernels": n / calls, "device_us": us / calls,
                       "names": names}
        if n != calls:
            bad[p.name] = names
    if bad:
        raise AssertionError(f"probes that do not run one kernel a call: "
                             f"{bad}")
    return out


_BENCH_SRC = r"""
#include <cuda_runtime.h>
__global__ void bp_empty() {}
extern "C" {
int bp_nothing(void) { return 0; }
int bp_nothing10(void* a, void* b, int c, int d, int e, int f, int g, int h,
                 void* i, void* j) { return 0; }
int bp_last_error(void) { return (int)cudaGetLastError(); }
int bp_launch(void* s) {
  bp_empty<<<1, 1, 0, (cudaStream_t)s>>>();
  return 0;
}
}
"""


def _bench_lib():
    """The tool's own library of do-nothing entries (built each run),
    loaded as a ``CDLL`` (the GIL released around each call, as the
    kernel library is) and as a ``PyDLL`` (the GIL held)."""
    d = os.path.join(os.path.dirname(_lib.BUILD_DIR), "bench_probes")
    os.makedirs(d, exist_ok=True)
    src, so = os.path.join(d, "bench.cu"), os.path.join(d, "libbench.so")
    with open(src, "w") as f:
        f.write(_BENCH_SRC)
    subprocess.run([_lib.nvcc(), *_lib.NVCC_FLAGS, "-shared", src, "-o", so],
                   check=True, capture_output=True, text=True)
    return _bind(ctypes.CDLL(so)), _bind(ctypes.PyDLL(so))


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    sig = {"bp_nothing": [], "bp_nothing10": [vp, vp, i, i, i, i, i, i, vp,
                                              vp],
           "bp_last_error": [], "bp_launch": [vp]}
    for name, args in sig.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def launch_pieces(dev, calls: int) -> Dict[str, float]:
    """Host microseconds per call of each piece of a probe launch, alone
    (the median of three rounds over the pieces).  A piece the checkout
    lacks is left out, so that the tool also runs on an older one."""
    lib = _lib.lib()
    bench, pybench = _bench_lib()
    x = torch.zeros((S, C), dtype=torch.int32, device=dev)
    idx = dev.index or 0
    s = torch.cuda.current_stream(dev).cuda_stream
    noop = lib.m2v_probe_noop
    pieces: Dict[str, Callable] = {
        "_lib.lib()": _lib.lib,
        "_lib.stream(x)": lambda: _lib.stream(x),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.cuda.current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(idx).cuda_stream,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.autograd._profiler_enabled()":
            torch.autograd._profiler_enabled,
        "getattr(lib, entry)": lambda: getattr(lib, "m2v_probe_noop"),
        "torch.empty((C, S), int32)": lambda: torch.empty(
            (C, S), dtype=torch.int32, device=dev),
        "x.new_empty((C, S))": lambda: x.new_empty((C, S)),
        "ctypes: m2v_probe_noop(stream) (launch + cudaGetLastError)":
            lambda: noop(s),
        "ctypes: a C entry that does nothing, no argument": bench.bp_nothing,
        "ctypes: a C entry that does nothing, ten arguments":
            lambda: bench.bp_nothing10(1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
        "ctypes (PyDLL): a C entry that does nothing, ten arguments":
            lambda: pybench.bp_nothing10(1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
        "ctypes: an empty launch, no error check": lambda: bench.bp_launch(s),
        "x.get_device()": x.get_device,
        "x.device": lambda: x.device,
        "torch.empty((C, S), int32, device=x.device)": lambda: torch.empty(
            (C, S), dtype=torch.int32, device=x.device),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "torch.empty((C, S), int32, device=index)": lambda: torch.empty(
            (C, S), dtype=torch.int32, device=idx),
        "torch.empty(C, S, int32, device=index)": lambda: torch.empty(
            C, S, dtype=torch.int32, device=idx),
        "torch.empty((C, S), int32, device='cuda')": lambda: torch.empty(
            (C, S), dtype=torch.int32, device="cuda"),
        "x.t() (a view)": x.t,
        "out[0] (a view)": lambda: x[0],
        "x.reshape(S * C, 1) (a view)": lambda: x.reshape(S * C, 1),
        "ctypes: cudaGetLastError alone": bench.bp_last_error,
        "_lib.check(0, what)": lambda: _lib.check(0, "x"),
        "probes.noop(dev)": lambda: P.noop(dev),
        "torch.accelerator.current_stream(index).native_handle":
            lambda: torch.accelerator.current_stream(idx).native_handle,
        "_lib.call(noop entry, stream)":
            lambda: _lib.call("m2v_probe_noop", s),
    }
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):  # private
        pieces["torch._C._cuda_getCurrentRawStream(index) (private)"] = \
            lambda: torch._C._cuda_getCurrentRawStream(idx)
    if hasattr(P, "_need"):
        pieces["probes._need(x)"] = lambda: P._need(x)
    if hasattr(P, "_contract_args"):
        a = torch.zeros((8, 2048), dtype=torch.int32, device=dev)
        b = torch.zeros((4, 2048), dtype=torch.int32, device=dev)
        pieces["probes._contract_args(a, rhs, ...)"] = \
            lambda: P._contract_args(a, b, 8, 4, 2048, P.RHS_ROWS, 1)
    runs = {name: [] for name in pieces}
    for _ in range(3):  # three rounds over the pieces; the median of each
        for name, fn in pieces.items():
            runs[name].append(host_us(fn, calls))
    return {name: statistics.median(v) for name, v in runs.items()}


def turns(probes: List[probe_kernels.Probe], dev, n_turns: int,
          reps: int) -> dict:
    """Every probe, its plain version and its library expression, with an
    empty launch before each probe, timed with CUDA events in ``n_turns``
    interleaved turns (the probes in order, then in reverse), after one
    warm-up turn that is dropped.  Per probe the medians; per turn the sum
    of the probes, the median of its empty launches and the share of the
    launch bound (one pass's launches at the empty launch's time, over the
    sum)."""
    if dev.index is None:  # an empty launch names its device's index
        dev = torch.device(dev.type, torch.cuda.current_device())
    P.launches = 0
    for p in probes:
        p.run(P)
    launches = P.launches
    rec = {p.name: {"ms": [], "plain_ms": [], "library_ms": []}
           for p in probes}
    per_turn = []
    for t in range(-1, n_turns):  # turn -1 warms up and is dropped
        order = probes if t % 2 == 0 else probes[::-1]
        total, noops = 0.0, []
        for p in order:
            lib = library(p)[2]
            noops.append(cuda_ms(lambda: P.noop(dev), reps))
            ms = cuda_ms(lambda: p.run(P), reps)
            rec[p.name]["ms"].append(ms)
            rec[p.name]["plain_ms"].append(cuda_ms(lambda: p.run(P.PLAIN),
                                                   reps))
            rec[p.name]["library_ms"].append(cuda_ms(lib, reps))
            total += ms
        noop_ms = statistics.median(noops)
        if t < 0:
            rec = {p.name: {k: [] for k in rec[p.name]} for p in probes}
            continue
        per_turn.append({"ms": total, "noop_ms": noop_ms,
                         "share": launches * noop_ms / total})
    med = {name: {k: statistics.median(v) for k, v in r.items()}
           for name, r in rec.items()}
    return {"probes": med, "turns": per_turn, "launches": launches,
            "noop_ms": statistics.median(t["noop_ms"] for t in per_turn),
            "ms": statistics.median(t["ms"] for t in per_turn),
            "min_share": min(t["share"] for t in per_turn)}


def check_library(p: probe_kernels.Probe) -> bool:
    """The library expression gives the probe's numpy answer."""
    import numpy as np

    got = library(p)[2]().cpu().numpy()
    return got.shape == p.want.shape and bool(
        np.array_equal(got.astype(p.want.dtype), p.want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--host-calls", type=int, default=10000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_probes: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    head = {"card": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    print(json.dumps(head), flush=True)
    probes = probe_kernels.make_probes(dev)
    out = {**head, "probes": {}}
    for p in probes:
        if not probe_kernels.check(p) or not check_library(p):
            raise AssertionError(f"{p.name}: the kernel or its library "
                                 "expression is wrong")
        text, ncalls, lib = library(p)
        rec = {"probe": p.name, "library": text, "library_calls": ncalls,
               "device": device(lambda: p.run(P)),
               "host_us": host_us(lambda: p.run(P), args.host_calls),
               "library_device": device(lib),
               "library_host_us": host_us(lib, args.host_calls)}
        out["probes"][p.name] = rec
        print(json.dumps(rec), flush=True)
    out["noop"] = {"device": device(lambda: P.noop(dev)),
                   "host_us": host_us(lambda: P.noop(dev), args.host_calls)}
    print(json.dumps({"noop": out["noop"]}), flush=True)
    out["pieces"] = launch_pieces(dev, args.host_calls)
    print(json.dumps({"pieces": out["pieces"]}), flush=True)
    out["turns"] = turns(probes, dev, args.turns, args.reps)
    print(json.dumps({"turns": out["turns"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
