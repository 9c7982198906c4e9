"""The gather kernel (``csrc/gather.cu``) at the engine's shapes, beside
other versions of its source, on one card.

    python -m mplan2vdl_tpu_torch.tools.bench_gather [--old [NAME=]FILE ...]
        [--plans DIR] [--sf 10] [--seed 1] [--reps 20] [--out FILE]

``shapes`` builds the gathers the engine launches, over the lineitem columns
of ``datagen.generate(sf, seed)`` (``chip_smoke.py`` phase 3 times the same
shapes through the wrapper):

- (a) k = 1 int32 through the 15.9% compaction of ``l_shipdate`` in 1994
  (ascending, the filter-project's positions);
- (b) k = 4 int32 through the same positions;
- (c) the join expansion (``lower._expansion``): int64, int64, int32
  through the identity positions of every lineitem row;
- (d) k = 1 int32 through a random permutation of the lineitem rows (a
  sparse fold's sort permutation, ``lower._eval_sparse_fold``);
- (e) k = 8 int64 through the 15.9% positions;
- (f) k = 1 int64 through the stable sort permutation of ``l_shipdate``
  (the dense-domain join's per-day group-by: rows of one day scattered
  over the table).

The checkout's ``gather.cu`` (``new``) and each ``--old`` source with the
same C entry (``m2v_gather``), such as the PR 1 design from git history,
are built with ``nvcc`` into libraries of their own under
``build/bench_gather/``, all at once; each library's ptxas registers and
spills are printed, and the resident blocks per SM of the instantiations
at the shapes where the library reports them (``m2v_gather_blocks_per_sm``).
For each shape every version is checked equal to the plain version, then
timed in turns (v0, v1, ..., vk, vk, ..., v0; CUDA events over ``--reps``
calls after two warm-up calls, the mean of a version's two turns), beside
``torch.index_select``. One JSON line per shape; each has the byte bound
(positions, selected elements and outputs once at 3.35 TB/s) and the same
count with each source read in 32-byte sectors (``sector_count``).

``--plans DIR`` also runs each ``DIR/*.mplan`` through the engine with
``gather.cu``'s launches routed to each version in turns (``engine_ab``),
such as ``chip_smoke.py``'s phase-4 plans that launch the kernel (its
``CLI_PLANS`` and ``PLAN_DENSE_JOIN``, ``PLAN_DISTINCT_WIDE`` and
``PLAN_Q4_ALL``), each written to a file.

Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..engine.kernels import _lib
from ..engine.kernels import sorted_gather as sg
from ..oracle.tpch import day

HBM_BYTES_PER_S = 3.35e12
SECTOR = 32
COLUMNS = ("l_shipdate", "l_orderkey", "l_quantity", "l_extendedprice",
           "l_discount")
BENCH_DIR = os.path.join(os.path.dirname(_lib.BUILD_DIR), "bench_gather")

Build = Callable[[], Tuple[List[torch.Tensor], torch.Tensor, int]]


@dataclass
class Shape:
    tag: str
    what: str
    build: Build


def shapes(cols: Dict[str, torch.Tensor], seed: int) -> List[Shape]:
    """Shapes (a)-(f) over the lineitem ``cols`` (``COLUMNS``, one device);
    each ``build()`` makes (sources, positions, valid) when called."""
    ship = cols["l_shipdate"]
    dev = ship.device
    n = ship.shape[0]
    okey, qty, price, disc = (cols[c] for c in COLUMNS[1:])

    def sel():
        return torch.nonzero((ship >= day(1994, 1, 1))
                             & (ship < day(1995, 1, 1))
                             ).reshape(-1).to(torch.int32)

    def wide(i):  # an int64 source whose high and low halves both vary
        a, b = (okey, qty, price, disc)[i % 4], (price, okey, disc, qty)[i % 4]
        return (a.to(torch.int64) << (29 + i)) - b.to(torch.int64)

    def a():
        p = sel()
        return [okey], p, p.shape[0]

    def b():
        p = sel()
        return [okey, qty, price, disc], p, p.shape[0]

    def c():
        return ([wide(0), wide(1), qty],
                torch.arange(n, dtype=torch.int32, device=dev), n)

    def d():
        g = torch.Generator(device=dev).manual_seed(seed)
        return [okey], torch.randperm(n, generator=g, device=dev).to(
            torch.int32), n

    def e():
        p = sel()
        return [wide(i) for i in range(8)], p, p.shape[0]

    def f():
        perm = torch.sort(ship, stable=True).indices.to(torch.int32)
        return [wide(2)], perm, n

    return [Shape("a", "k=1 int32 at 15.9% ascending", a),
            Shape("b", "k=4 int32 at 15.9% ascending", b),
            Shape("c", "k=3 int64/int64/int32 at identity positions "
                  "(join expansion)", c),
            Shape("d", "k=1 int32 through a random permutation", d),
            Shape("e", "k=8 int64 at 15.9% ascending", e),
            Shape("f", "k=1 int64 through the stable sort permutation of "
                  "l_shipdate", f)]


def byte_count(srcs: Sequence[torch.Tensor], pos: torch.Tensor) -> int:
    """Positions read once, each selected element read once, each output
    written once."""
    m = pos.shape[0]
    return m * pos.element_size() + sum(2 * m * s.element_size()
                                        for s in srcs)


def sector_count(srcs: Sequence[torch.Tensor], pos: torch.Tensor,
                 valid: int) -> int:
    """Like ``byte_count``, but each source read in 32-byte sectors, one
    for each run of consecutive rows whose elements share a sector: the
    distinct sectors touched when positions ascend, about one sector a row
    through a random permutation (no reuse from the cache)."""
    p = sg.prep_pos(srcs[0].shape[0], pos, valid)
    m = pos.shape[0]
    reads = {}
    for es in sorted({s.element_size() for s in srcs}):
        sec = p * es // SECTOR
        reads[es] = (1 + int((sec[1:] != sec[:-1]).sum())) * SECTOR
    return m * pos.element_size() + sum(reads[s.element_size()]
                                        + m * s.element_size() for s in srcs)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls (CUDA events), after two
    warm-up calls."""
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


def build_versions(olds: Dict[str, str]) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """The checkout's ``gather.cu`` (``new``) and each source of ``olds``
    (name -> file), each built in its own ``nvcc`` process, all started
    together; name -> (library, ptxas report)."""
    os.makedirs(BENCH_DIR, exist_ok=True)
    exe = _lib.nvcc()
    todo = [*olds.items(), ("new", os.path.join(_lib.CSRC, "gather.cu"))]
    procs = []
    for name, src in todo:
        so = os.path.join(BENCH_DIR, f"libgather_{name}.so")
        cmd = [exe, *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", src, "-o",
               so]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{out}")
        lib = ctypes.CDLL(so)
        lib.m2v_gather.argtypes = _lib._SIGNATURES["m2v_gather"][0]
        lib.m2v_gather.restype = ctypes.c_int
        lib.m2v_gather_max_sources.restype = ctypes.c_int
        libs[name] = (lib, out)
    return libs


def blocks_per_sm(lib: ctypes.CDLL, srcs: Sequence[torch.Tensor],
                  pos: torch.Tensor):
    """Resident blocks per SM of the instantiation ``lib`` launches for
    these sources and positions (one launch's worth), or None where the
    library does not report it."""
    fn = getattr(lib, "m2v_gather_blocks_per_sm", None)
    if fn is None:
        return None
    fn.argtypes = _lib._SIGNATURES["m2v_gather_blocks_per_sm"][0]
    fn.restype = ctypes.c_int
    part = srcs[:lib.m2v_gather_max_sources()]
    k8 = sum(s.element_size() == 8 for s in part)
    return fn(len(part) - k8, k8, pos.element_size())


def launcher(lib: ctypes.CDLL, srcs: List[torch.Tensor], pos: torch.Tensor,
             valid: int):
    """The outputs and a function that gathers into them through
    ``lib.m2v_gather`` (the wrapper's launches, outputs allocated once)."""
    m, n = pos.shape[0], srcs[0].shape[0]
    outs = [torch.empty(m, dtype=s.dtype, device=s.device) for s in srcs]
    cap = lib.m2v_gather_max_sources()
    parts = [(_lib.ptrs(srcs[lo:lo + cap]), _lib.ptrs(outs[lo:lo + cap]),
              _lib.ints([s.element_size() for s in srcs[lo:lo + cap]]),
              len(srcs[lo:lo + cap])) for lo in range(0, len(srcs), cap)]
    stream = _lib.stream(pos)

    def run():
        for ps, po, es, k in parts:
            rc = lib.m2v_gather(ps, po, es, k, pos.data_ptr(),
                                pos.element_size(), m, n, valid, None, stream)
            if rc != 0:
                raise RuntimeError(f"m2v_gather: CUDA error {rc}")
    return outs, run


def ptxas_summary(report: str) -> List[str]:
    """The register, shared-memory and spill lines of a ptxas report, one
    per kernel."""
    rows, fn = [], ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "Used" in ln:
            rows.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" \
                not in ln:
            rows.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    return rows


def shape_ab(libs: Dict[str, Tuple[ctypes.CDLL, str]],
             cols: Dict[str, torch.Tensor], seed: int,
             reps: int) -> List[dict]:
    """Every version at each shape of ``shapes``: checked equal to the
    plain version, then timed in turns; one JSON line per shape."""
    names = list(libs)
    order = names + names[::-1]
    out = []
    for sh in shapes(cols, seed):
        srcs, pos, valid = sh.build()
        want = sg.gather_many_plain(srcs, pos, valid)
        runs = {}
        for name in names:
            outs, fn = launcher(libs[name][0], srcs, pos, valid)
            fn()
            torch.cuda.synchronize()
            for o, w in zip(outs, want):
                if not torch.equal(o, w):
                    raise AssertionError(f"({sh.tag}) {name} differs "
                                         "from the plain version")
            runs[name] = fn
        del want
        times = {name: [] for name in names}
        for name in order:
            times[name].append(cuda_ms(runs[name], reps))
        posl = pos.long()
        lib_ms = cuda_ms(lambda: [torch.index_select(s, 0, posl)
                                  for s in srcs], reps)
        nbytes = byte_count(srcs, pos)
        rec = {"shape": sh.tag, "what": sh.what,
               "k": len(srcs), "m": pos.shape[0], "n": srcs[0].shape[0],
               "blocks_per_sm": {name: blocks_per_sm(libs[name][0], srcs, pos)
                                 for name in names},
               "ms": {k: sum(v) / len(v) for k, v in times.items()},
               "turns": times, "library_ms": lib_ms,
               "bytes": nbytes, "bound_ms": bound_ms(nbytes),
               "sector_ms": bound_ms(sector_count(srcs, pos, valid))}
        rec["share_of_bound"] = {k: rec["bound_ms"] / v
                                 for k, v in rec["ms"].items()}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del srcs, pos, posl, runs
        torch.cuda.empty_cache()
    return out


def engine_ab(libs: Dict[str, Tuple[ctypes.CDLL, str]], st,
              plans: Dict[str, str], names: Sequence[str]) -> dict:
    """Each of ``plans`` (name -> mplan text) through the engine with
    ``gather.cu``'s launches routed to each version of ``names`` in turns
    (v0, ..., vk, vk, ..., v0): the gather kernels' device ms of one
    profiled call (torch.profiler) and the median of 3 warm calls (host
    clock, synchronized).  One JSON line per plan and one with the sums."""
    import re
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..engine.lower import CompiledQuery, plan_to_vexps

    cfg = st.make_catalog()
    call = _lib.call
    order = list(names) + list(names)[::-1]
    total = {v: [0.0, 0.0, 0] for v in names}
    out = {"plans": []}

    def routed(lib):
        def fn(entry, *a):
            if entry == "m2v_gather":
                return lib.m2v_gather(*a)
            return call(entry, *a)
        return fn

    for plan_name, plan in plans.items():
        os.environ.pop("MPLAN2VDL_FUSED_AGG", None)
        cq = CompiledQuery(cfg, plan_to_vexps(plan, cfg), st, device="cuda")
        cq.run()
        rec = {v: [] for v in names}
        try:
            for v in order:
                _lib.call = routed(libs[v][0])
                cq.run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    cq.run()
                    torch.cuda.synchronize()
                ms, launches = 0.0, 0
                for e in prof.key_averages():
                    if (e.device_type == DeviceType.CUDA and re.search(
                            r"(?<![A-Za-z0-9_])gather_kernel\b", e.key)):
                        ms += getattr(e, "self_device_time_total",
                                      getattr(e, "self_cuda_time_total", 0))
                        launches += e.count
                wall = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    cq.run()
                    torch.cuda.synchronize()
                    wall.append((time.perf_counter() - t0) * 1e3)
                rec[v].append((ms / 1e3, sorted(wall)[1], launches))
        finally:
            _lib.call = call
        line = {"plan": plan_name,
                "gather_ms": {v: sum(r[0] for r in rec[v]) / 2 for v in names},
                "median_ms": {v: sum(r[1] for r in rec[v]) / 2 for v in names},
                "launches": rec[names[0]][0][2]}
        for v in names:
            total[v][0] += line["gather_ms"][v]
            total[v][1] += line["median_ms"][v]
            total[v][2] += line["launches"]
        print(json.dumps(line), flush=True)
        out["plans"].append(line)
        del cq
        torch.cuda.empty_cache()
    out["total"] = {v: {"gather_ms": t[0], "median_ms": t[1], "launches": t[2]}
                    for v, t in total.items()}
    print(json.dumps({"engine_total": out["total"]}), flush=True)
    return out


def run(sf: float, seed: int, reps: int, olds: Dict[str, str],
        plans: Dict[str, str]) -> dict:
    from ..engine import datagen

    dev = torch.device("cuda")
    libs = build_versions(olds)
    for name, (_, report) in libs.items():
        rows = ptxas_summary(report)
        print(json.dumps({"version": name, "kernels": len(
            [r for r in rows if "registers" in r]),
            "spilling": [r for r in rows if "spill" in r],
            "max_registers": max((int(r.split("Used ")[1].split()[0])
                                  for r in rows if "Used " in r),
                                 default=None)}), flush=True)
    st = datagen.generate(sf=sf, seed=seed)
    cols = {c: torch.from_numpy(st.columns[("lineitem", c)].copy()).to(dev)
            for c in COLUMNS}
    out = {"shapes": shape_ab(libs, cols, seed, reps)}
    del cols
    torch.cuda.empty_cache()
    if plans:
        out["engine"] = engine_ab(libs, st, plans, list(libs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", default=[],
                    metavar="[NAME=]FILE",
                    help="another gather.cu to build and time beside the "
                    "checkout's (NAME defaults to pr1); may repeat")
    ap.add_argument("--plans", default=None, metavar="DIR",
                    help="also run each DIR/*.mplan through the engine "
                    "with each version in turns")
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="also write the records as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_gather: no CUDA device", file=sys.stderr)
        return 2
    olds = dict(o.split("=", 1) if "=" in o else ("pr1", o)
                for o in args.old)
    plans = {}
    if args.plans:
        for f in sorted(os.listdir(args.plans)):
            if f.endswith(".mplan"):
                with open(os.path.join(args.plans, f)) as fh:
                    plans[f[:-len(".mplan")]] = fh.read()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    recs = run(args.sf, args.seed, args.reps, olds, plans)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, **recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
