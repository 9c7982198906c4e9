"""Drives the PyTorch/CUDA port (``mplan2vdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--sf 10] [--seed 1] [--out FILE] [--profile DIR]

Nine phases, each a method of ``Smoke`` whose docstring says what it holds;
any failure ends the run with a nonzero exit, and nothing is caught:
  1. ``card``: the card (``nvidia-smi`` name and power limit) and the
     torch, CUDA, nvcc and driver versions;
  2. ``build``: the CUDA kernels of ``engine/kernels/csrc``, with ptxas's
     register and spill lines;
  3. ``kernel_phase``: each kernel exactly equal to its plain PyTorch
     version at the shapes of a TPC-H store of the chosen scale and at the
     edges of its design, then timed with CUDA events beside its plain
     version and a library yardstick;
  4. ``query_phase``: the port end to end (``plan_to_vexps`` +
     ``CompiledQuery`` on ``cuda``) on each plan of ``CLI_PLANS``, Q1 also
     under its switches, and on a hand-built ``Semisort`` DAG, each run
     row-exact against its oracle and held to its kernel launches and its
     engine path, then timed;
  5. ``probe_phase``: the probe tools and the probe kernels, exact against
     their plain versions, then timed in interleaved turns;
  6. ``cli_phase``: the command line, each command in its own process;
  7. ``dist_phase``: the distribution primitives (``parallel/``) at world
     size 1 over NCCL on the card;
  8. ``auto_phase``: the plan distributor on each plan of ``AUTO_PLANS`` in
     the same world;
  9. ``census_phase``: the JAX package's CPU plan census
     (tests/torch_census_cases.py) on the card, held against the port's
     relational oracle.
Each phase's seconds are printed as it ends (``{"phase_s": ...}``).
The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits nonzero and prints no result.  The plan texts, their
numpy oracles and the kernels' cases come from tests/torch_plans.py, the
copy the tests share; ``--profile DIR`` traces one warm call of each query
(phase 4) and distributed plan (phase 8) with torch.profiler.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# the plans, oracles and cases the tests share (tests/torch_plans.py), and
# the census's and the expression fold's cases beside them
if os.path.join(REPO, "tests") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_plans as plans  # noqa: E402

# timed launches per kernel (after two warm-up launches)
REPS = 20
# phase 5: interleaved turns of the probes, calls a turn, and host-clock calls
PROBE_TURNS, PROBE_REPS, PROBE_HOST_CALLS = 5, 200, 10_000

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12

# each CUDA kernel (csrc/<name>.cu, or csrc/<source>.cu): the TPU kernel it
# replaces (JAX package, file:line), the module and counter of its launches
# (the probe kernels' counted over the probe tools, the others over the
# queries), and its CUDA functions as the profiler names them
KERNEL_SOURCE = "mplan2vdl_tpu_torch/engine/kernels/csrc/{}.cu"
KERNELS = {
    "compact": dict(
        replaces="mplan2vdl_tpu/engine/kernels/compact.py:176",
        counter=("compact", "launches"), functions=("compact_kernel",)),
    "gather": dict(
        replaces="mplan2vdl_tpu/engine/kernels/sorted_gather.py:297"
                 " + mplan2vdl_tpu/engine/kernels/sorted_gather.py:507",
        counter=("sorted_gather", "launches"), functions=("gather_kernel",)),
    "multiagg": dict(
        replaces="mplan2vdl_tpu/engine/kernels/multiagg.py:252",
        counter=("multiagg", "launches"),
        functions=("lane_kernel", "shared_kernel")),
    "scatter": dict(
        replaces="mplan2vdl_tpu/engine/kernels/scatter.py:236",
        counter=("scatter", "launches"), functions=("scatter_kernel",)),
    "small_gather": dict(
        replaces="mplan2vdl_tpu/engine/kernels/sorted_gather.py:243"
                 " + mplan2vdl_tpu/engine/kernels/sorted_gather.py:507",
        counter=("sorted_gather", "small_launches"),
        functions=("small_gather_kernel",)),
    "multiagg_mxu": dict(
        replaces="mplan2vdl_tpu/engine/kernels/multiagg_mxu.py:196",
        counter=("multiagg_mxu", "launches"),
        functions=("mxu_kernel", "fast_kernel")),
    "radix_rank": dict(replaces="tools/probe_radix.py:65",
                       counter=("radix_rank", "launches"), probe=True),
    "probes": dict(replaces="tools/probe_mosaic.py:39",
                   counter=("probes", "launches"), probe=True),
    "exprfold": dict(
        replaces="none: XLA's loop fusion of a one-group fold's tree",
        counter=("exprfold", "launches"), functions=("expr_fold_kernel",)),
    "group_ids": dict(
        replaces="none: XLA's loop fusion of a fused family's key and mask",
        source="exprfold", counter=("exprfold", "group_launches"),
        functions=("group_ids_kernel",)),
}

Q1_MXU = "Q1 fused MXU (MPLAN2VDL_MXU_AGG=1)"
# phase 4's run of a hand-built VIR DAG: Semisort, which no plan emits
SEMISORT_RUN = "Semisort"
# the kernels of Q5, whose launches (C entry points ``m2v_<kernel>``) its
# profiler trace must name beside their CUDA functions
Q5_KERNELS = ("compact", "gather", "scatter", "small_gather")
# the scale of the --tbl runs: the ingest parses text in Python loops, and
# SF10's .tbl text is about 10 GB
TBL_SF = 0.1
# phase 9: the JAX package's CPU plan census (tests/torch_census_cases.py)
# on the card, held against the port's relational oracle.  Its store is SF1
# (lineitem 6,001,215 rows), not SF10: the oracle runs on the host in numpy,
# and its group-bys (np.unique over the key rows, np.add.at folds) take tens
# of seconds a plan over SF10's 60M rows, too long for ~100 plans in one run
CENSUS_SF = 1.0
CENSUS_CUT = ("SF1, not SF10: the numpy oracle takes tens of seconds a plan "
              "over SF10's 60M lineitem rows, too long for ~100 plans")
# the fuzz plans' three passes: (family line, MPLAN2VDL_FUSED_AGG,
# MPLAN2VDL_MXU_AGG); the default gate leaves SF1 unfused
FUZZ_PASSES = (("fuzz", None, None), ("fuzz_fused", "1", None),
               ("fuzz_mxu", "1", "1"))
# what each family is held against besides the row count
CENSUS_REFERENCE = {"fuzz": "relinterp", "ordered": "relinterp, in order",
                    "null": "sqlite", "corners": "relinterp",
                    "semi_anti": "relinterp",
                    "distinct": "relinterp and a numpy distinct count",
                    "tpch": "relinterp"}
# worker processes computing the census oracles while the card runs
CENSUS_WORKERS = 6
# the query runs of the general-join slice, and the engine kernels they
# must launch between them
JOIN_RUNS = ("Q9", "Q13", "Q17", "substring group-by")
JOIN_KERNELS = ("compact", "gather", "small_gather")
# the engine kernels each ordered run (ORDER BY, top N, the
# repeated-position scatter, count(DISTINCT)) must launch
ORDERED_KERNELS = ("compact", "gather", "scatter")


def _sh(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


@contextlib.contextmanager
def engine_seam(wrap=None, env=None):
    """The one place where the card runner reaches into the engine.  While
    open, each ``wrap`` entry, a name of ``engine.lower`` (a method as
    ``"Compiler.name"``) -> ``around(original, *args, **kwargs)``, puts a
    function that calls ``around`` in the name's place, and each ``env``
    switch is set (None: unset); on exit both are restored."""
    from mplan2vdl_tpu_torch.engine import lower

    def setenv(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    saved_env = {k: os.environ.get(k) for k in env or {}}
    saved = []
    try:
        setenv(env or {})
        for name, around in (wrap or {}).items():
            owner = lower.Compiler if name.startswith("Compiler.") else lower
            attr = name.rpartition(".")[2]
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, lambda *a, _fn=fn, _around=around, **k:
                    _around(_fn, *a, **k))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
        setenv(saved_env)


# Itanium-mangled template argument types of the kernels
MANGLED_TYPES = {"i": "int", "x": "long long", "l": "long", "j": "unsigned",
                 "h": "unsigned char", "b": "bool"}


def _template_args(mangled: str) -> str:
    """``Li2ELi1Ei`` -> ``2,1,int``: the template arguments of a mangled
    kernel name (integer and bool literals, builtin types)."""
    import re

    args = []
    for lit, ty in re.findall(r"L[ib](\d+)E|([a-z])", mangled):
        args.append(lit if lit else MANGLED_TYPES.get(ty, ty))
    return ",".join(args)


def _engine_kernel(key: str):
    """The engine kernel whose CUDA function a profiler entry names, or
    None."""
    import re

    # a name must not follow an identifier character: small_gather_kernel
    # is not gather_kernel
    for k, meta in KERNELS.items():
        if any(re.search(rf"(?<![A-Za-z0-9_]){f}\b", key)
               for f in meta.get("functions", ())):
            return k
    return None


def _dev_us(e) -> float:
    """Device microseconds of a torch.profiler key-average entry."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def gather_shape(srcs, pos):
    """(k, source dtypes, position dtype, m, n) of a gather."""
    return (len(srcs), "/".join(str(s.dtype)[6:] for s in srcs),
            str(pos.dtype)[6:], pos.shape[0], srcs[0].shape[0])


def gather_class(srcs, pos, valid):
    """The census class of a gather: its ``gather_shape`` and the order of
    the valid positions (consecutive, ascending or unordered).  Reads the
    positions back to the host."""
    m = pos.shape[0]
    v = max(min(int(valid), m), 0)
    d = pos[1:v].long() - pos[:max(v - 1, 0)].long()
    order = ("consecutive" if bool((d == 1).all())
             else "ascending" if bool((d >= 0).all()) else "unordered")
    return gather_shape(srcs, pos) + (order,)


def _counter(kernel):
    """(wrapper module, counter attribute) of a kernel's launches."""
    import importlib

    mod, attr = KERNELS[kernel]["counter"]
    return importlib.import_module(
        f"mplan2vdl_tpu_torch.engine.kernels.{mod}"), attr


def kernel_counters(probe=False):
    """The engine kernels' (or, given ``probe``, the probe kernels')
    launch counters: kernel name -> (wrapper module, counter attribute)."""
    return {k: _counter(k) for k, m in KERNELS.items()
            if m.get("probe", False) == probe}


def reset_launches(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_launches(counters):
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def part_joins(dq):
    """Each partitioned shuffle join of a distributed plan ``dq``: its
    right frame, whether it is outer, its pair count and, from the
    heavy-key round (``caps["heavy"]``), the heavy keys with their exact
    build-row and pair capacities."""
    import torch

    from mplan2vdl_tpu_torch.parallel.shuffle_join import key_sents

    out = []
    for pj in dq.part_joins.values():
        caps = pj["caps"] or {}
        heavy = caps.get("heavy")
        big = key_sents(torch.int32 if pj.get("k32") else torch.int64)[0]
        keys = [int(k) for k in heavy["hk"] if k != big] if heavy else []
        out.append({"right": pj["table"] or "fact frame",
                    "outer": bool(pj["outer"]), "pairs": caps.get("total"),
                    "n_heavy": len(keys), "heavy_keys": keys,
                    "cap_hb": heavy["cap_hb"] if heavy else None,
                    "cap_hp": heavy["cap_hp"] if heavy else None})
    return out


class FirstRuns:
    """What the first call of each phase-4 run shows through ``engine_seam``
    (``spies``): the engine's scatters, the repeated-position scatters,
    count(DISTINCT)'s group domains and pair sorts (``paths``, beside the
    join log's counts), and gather.cu's launches in classes (``census``;
    ``seq``, each run's classes in order, names its calls when profiled)."""

    def __init__(self):
        self.scatters, self.repeats, self.paths = {}, {}, {}
        self.census, self.seq = {}, {}

    def spies(self, query):
        """``engine_seam``'s wrappers for the first call of ``query``."""
        from mplan2vdl_tpu_torch.engine import lower
        from mplan2vdl_tpu_torch.engine.kernels import sorted_gather as sg
        from mplan2vdl_tpu_torch.tools import bench_gather

        rec = self.paths[query] = {"dense_joins": 0, "merge_joins": 0,
                                   "distinct_domains": [], "pair_sorts": []}
        seq = self.seq[query] = []

        def scatter(fn, p, src, L):
            valid = int(((p >= 0) & (p < L)).sum())
            self.scatters.setdefault(query, []).append({
                "n": p.shape[0], "valid": valid, "L": L,
                "pos": str(p.dtype), "src": str(src.dtype),
                "bound_ms": _bound_ms(p.shape[0] * p.element_size()
                                      + valid * src.element_size()
                                      + L * src.element_size())})
            return fn(p, src, L)

        def repeat(fn, p, src, L):
            live = p[p < L]
            self.repeats.setdefault(query, []).append({
                "n": p.shape[0], "L": L, "valid": live.shape[0],
                "distinct": int(live.unique().numel())})
            return fn(p, src, L)

        def distinct(fn, c, vx, dt, domain, L_out):
            rec["distinct_domains"].append(domain)
            return fn(c, vx, dt, domain, L_out)

        def pairs(fn, ids, vals, domain, vlo, vhi):
            top = (domain + 1) * (vhi - vlo + 1)
            rec["pair_sorts"].append({
                "n": ids.shape[0], "domain": domain, "width": vhi - vlo + 1,
                "packed": top <= lower.PACK_LIMIT,
                "key_bits": (top - 1).bit_length()})
            return fn(ids, vals, domain, vlo, vhi)

        def gathers(fn, srcs, pos, valid, small=False):
            if small:
                return fn(srcs, pos, valid, small=small)
            key = gather_class(srcs, pos, valid)
            before = sg.launches
            out = fn(srcs, pos, valid, small=small)
            cls = self.census.setdefault(key, dict(
                zip(("k", "srcs", "pos", "m", "n", "order"), key), calls=0,
                launches=0, queries=[],
                bound_ms=_bound_ms(bench_gather.byte_count(srcs, pos))))
            cls["calls"] += 1
            cls["launches"] += sg.launches - before
            if query not in cls["queries"]:
                cls["queries"].append(query)
            seq.append(key)
            return out
        return {"monotone_scatter": scatter, "repeat_scatter": repeat,
                "Compiler._eval_fold_distinct": distinct,
                "_sort_pairs": pairs, "gather_many": gathers}


class Smoke:
    def __init__(self, args):
        import torch

        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda")
        self.records = {"kernel_checks": [], "kernel_times": [],
                        "queries": [], "dist": []}

    # ----------------------------------------------------------- utilities
    def sync(self):
        self.torch.cuda.synchronize()

    def cuda_ms(self, fn, reps):
        """Mean ms per call over ``reps`` calls, timed with CUDA events
        after two warm-up calls."""
        torch = self.torch
        for _ in range(2):
            fn()
        self.sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_ms(self, kernel, fn):
        """``cuda_ms(fn, REPS)``, and the launches ``kernel``'s counter
        saw over those calls and their warm-up."""
        mod, attr = _counter(kernel)
        setattr(mod, attr, 0)
        ms = self.cuda_ms(fn, REPS)
        return ms, getattr(mod, attr)

    def warm_ms(self, fn, calls):
        """Host ms of each of ``calls`` calls of ``fn``, each to the end of
        its device work."""
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    def equal(self, what, got, want):
        """Holds a kernel's output to its plain version's, exactly; a check
        is named after its kernel first (``summary`` reads the name)."""
        torch = self.torch
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        err = 0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{what}: {g.dtype}{tuple(g.shape)} vs "
                                     f"plain {w.dtype}{tuple(w.shape)}")
            g, w = g.reshape(-1), w.reshape(-1)
            for a in range(0, g.numel(), 1 << 27):  # bounded temporaries
                err = max(err, int((g[a:a + (1 << 27)].to(torch.int64)
                                    - w[a:a + (1 << 27)].to(torch.int64))
                                   .abs().max()))
        self.sync()
        print(json.dumps({"check": what, "max_abs_err": err}), flush=True)
        self.records["kernel_checks"].append({"check": what,
                                              "max_abs_err": err})
        if err != 0:
            raise AssertionError(f"{what}: kernel differs from plain "
                                 f"version (max abs err {err})")

    def oracle(self, fn, *args):
        """``fn(*args)``, its seconds printed as an ``{"oracle": ...}``
        line."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(json.dumps({"oracle": fn.__name__,
                          "s": time.perf_counter() - t0}), flush=True)
        return out

    def tpch_want(self, name):
        """``oracle/tpch``'s Q6 or Q1 result over the store, computed once
        (Q1 takes over a minute at SF10) for phases 4 and 7."""
        from mplan2vdl_tpu_torch.oracle import tpch

        cache = self.__dict__.setdefault("_tpch_want", {})
        if name not in cache:
            cache[name] = self.oracle(getattr(tpch, name), self.st)
        return cache[name]

    # -------------------------------------------------------------- phases
    def card(self):
        torch = self.torch
        self.smi = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines()[0]
        driver = _sh(["nvidia-smi", "--query-gpu=driver_version",
                      "--format=csv,noheader"]).splitlines()[0]
        from mplan2vdl_tpu_torch.engine.kernels import _lib

        nvcc = _sh([_lib.nvcc(), "--version"]).splitlines()[-1]
        print(self.smi, flush=True)
        print(json.dumps({"torch": torch.__version__,
                          "cuda": torch.version.cuda, "nvcc": nvcc,
                          "driver": driver, "python": sys.version.split()[0],
                          "device": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()}), flush=True)

    def build(self):
        from mplan2vdl_tpu_torch.engine.kernels import _lib

        import re

        secs = _lib.build()
        _lib.lib()
        for src, out in _lib.build_info["ptxas"].items():
            fn = ""  # the kernel ptxas reports on, as name<template args>
            for ln in out.splitlines():
                m = re.search(r"entry function '[^']*?\d([a-z][a-z_]*_kernel)"
                              r"(?:I((?:L[ib]\d+E|[a-z])+)E)?", ln)
                if m:
                    fn = m[1] + (f"<{_template_args(m[2])}>" if m[2] else "")
                if "Used" in ln or "spill" in ln:
                    print(f"ptxas {src} {fn}: {ln.strip()}", flush=True)
        print(json.dumps({"build_s": secs}), flush=True)

    def store(self):
        from mplan2vdl_tpu_torch.engine import datagen

        t0 = time.perf_counter()
        self.st = datagen.generate(sf=self.args.sf, seed=self.args.seed)
        t1 = time.perf_counter()
        self.cfg = self.st.make_catalog()
        self.n = len(self.st.columns[("lineitem", "l_orderkey")])
        self.n_orders = len(self.st.columns[("orders", "o_orderkey")])
        print(json.dumps({"datagen_s": t1 - t0,
                          "catalog_s": time.perf_counter() - t1,
                          "sf": self.args.sf, "lineitem_rows": self.n}),
              flush=True)

    def col(self, name):
        import numpy as np

        return self.torch.from_numpy(np.require(
            self.st.columns[("lineitem", name)],
            requirements=["C", "W"])).to(self.dev)

    def kernel_phase(self):
        """Phase 3: the compaction, the gather and the fused aggregate
        here, the other kernels in the methods it ends with; each case
        (its ``{"check": ...}`` line names it) exact against the kernel's
        plain version, then the kernel timed."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import compact, multiagg
        from mplan2vdl_tpu_torch.engine.kernels import sorted_gather as sg
        from mplan2vdl_tpu_torch.oracle.tpch import day

        ship, disc, qty = (self.col("l_shipdate"), self.col("l_discount"),
                           self.col("l_quantity"))
        n = ship.shape[0]
        m159 = (ship >= day(1994, 1, 1)) & (ship < day(1995, 1, 1))
        m19 = m159 & (disc >= 5) & (disc <= 7) & (qty < 2400)
        # Q1's shipdate cut keeps every row of this generator's lineitem;
        # hash the row index for a mask of Q1's TPC-H density instead
        rows = torch.arange(n, device=self.dev)
        m986 = (rows * 2654435761 % 1000) < 986
        cnt = {k: int(m.sum()) for k, m in
               (("1.9%", m19), ("15.9%", m159), ("98.6%", m986))}
        print(json.dumps({"densities": {k: v / n for k, v in cnt.items()}}),
              flush=True)
        self.timed = {}

        # ---- compaction
        def cmp_case(what, mask, n_out=None):
            self.equal(f"compact {what}", compact.compact_positions(
                mask, n_out), compact.compact_positions_plain(mask, n_out))

        for k, m in (("1.9%", m19), ("15.9%", m159), ("98.6%", m986)):
            cmp_case(f"density {k} n_out=count", m, max(cnt[k], 1))
            cmp_case(f"density {k} n_out=n", m)
        cmp_case("all-false", torch.zeros(n, dtype=torch.bool,
                                          device=self.dev))
        cmp_case("all-true", torch.ones(n, dtype=torch.bool, device=self.dev))
        odd = 4096 * max(n // 8192, 1) + 77
        cmp_case(f"n={odd} (not a block multiple)", m159[:odd])
        cmp_case("n_out trimmed to half the count", m159, cnt["15.9%"] // 2)
        cmp_case("unaligned view", m159[3:])
        cmp_case("n=1", m159[:1])
        tile = compact.TILE
        one = torch.zeros(n, dtype=torch.bool, device=self.dev)
        one[5] = True
        cmp_case("single true row in the first tile", one)
        one[5], one[n - 1] = False, True
        cmp_case("single true row in the last row", one)
        for k in (tile - 1, tile, tile + 1):
            cmp_case(f"n={k} (tile {tile} {k - tile:+d})", m159[:k])
        cmp_case("n_out = count + 100000 (zero tail)", m159,
                 cnt["15.9%"] + 100_000)
        # many calls in a row on masks of changing length: stale tickets,
        # status words or epochs would show here
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed + 3)
        for i in range(50):
            k = int(torch.randint(1, min(n, 3 * tile * (i + 1)) + 1, (1,),
                                  generator=gen, device=self.dev))
            m = torch.rand(k, generator=gen, device=self.dev) < (i % 10) / 9
            got = compact.compact_positions(m, k // (1 + i % 3))
            want = compact.compact_positions_plain(m, k // (1 + i % 3))
            if not torch.equal(got, want):
                raise AssertionError(f"compact: call {i} of 50 (n={k}) "
                                     "differs from the plain version")
        self.equal("compact 50 calls in a row, changing n", got, want)
        del one

        # no fill per call: once the look-back scratch exists, calls reuse
        # it (tickets and epochs advance), so a call is the one kernel that
        # m2v_compact launches.  (A profiler session here once left the
        # later --profile tables short of kernel records.)
        c159 = cnt["15.9%"]
        compact.compact_positions(m159, c159)
        key = (self.dev.index or 0, torch.cuda.current_stream().cuda_stream)
        state, buf = compact._scratch[key]
        epoch, ptr = state.epoch, buf.data_ptr()
        for _ in range(3):
            compact.compact_positions(m159, c159)
        state, buf = compact._scratch[key]
        if (state.epoch, buf.data_ptr()) != (epoch + 3, ptr):
            raise AssertionError("compact: the look-back scratch was "
                                 "allocated again between calls")
        print(json.dumps({"compact scratch reused, epoch": state.epoch}),
              flush=True)

        for k, m in (("15.9%", m159), ("1.9%", m19), ("98.6%", m986)):
            c = cnt[k]
            ms, timed_launches = self.kernel_ms(
                "compact", lambda: compact.compact_positions(m, c))
            plain_ms = self.cuda_ms(
                lambda: compact.compact_positions_plain(m, c), 3)
            lib_ms = self.cuda_ms(lambda: torch.nonzero(m), REPS)
            self.kernel_time("compact" if k == "15.9%" else f"compact {k}",
                             f"mask bool[{n}] {k} -> int32[{c}]", ms,
                             plain_ms, lib_ms, _bound_ms(n + 4 * c),
                             timed_launches)

        # ---- gather
        from mplan2vdl_tpu_torch.engine.kernels import _lib
        from mplan2vdl_tpu_torch.tools import bench_gather

        pos = compact.compact_positions(m159, c159)
        names = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount"]
        srcs = [self.col(c) for c in names]
        wide = (srcs[2].to(torch.int64) << 33) - srcs[0].to(torch.int64)

        def g_case(what, ss, p, valid):
            # rows past valid are unspecified to callers but equal here
            self.equal(f"gather {what}", sg.gather_many(ss, p, valid),
                       sg.gather_many_plain(ss, p, valid))

        g_case("k=4 int32", srcs, pos, c159)
        g_case("k=1 int32", srcs[:1], pos, c159)
        g_case("k=1 int64", [wide], pos, c159)
        g_case("k=4 mixed int32/int64", [srcs[0], wide, srcs[2], wide], pos,
               c159)
        g_case("k=9 (two launches)", srcs * 2 + [wide], pos, c159)
        tail = pos.clone()
        tail[c159 // 2:] = 0
        g_case("masked tail, host valid", srcs, tail, c159 // 2)
        g_case("masked tail, device valid", srcs, tail,
               torch.tensor(c159 // 2, device=self.dev))
        dup = torch.repeat_interleave(pos[: c159 // 2], 2)
        g_case("duplicate positions", srcs, dup, dup.shape[0])
        g_case("int64 positions", srcs, pos.to(torch.int64), c159)
        # the kernel's paths: each dtype group full, both groups in one
        # launch, tiny m and a ragged last tile, position and source views
        # off any alignment, consecutive runs, a permutation, the tail
        # repeat from row 0, a one-row source
        wides = [wide + j for j in range(8)]
        g_case("k=8 int64", wides, pos, c159)
        g_case("k=9 int64 (two launches)", wides + [wide], pos, c159)
        g_case("k=8 mixed 4 int32 + 4 int64", srcs + wides[:4], pos, c159)
        for m in (1, 3, 5):
            g_case(f"m={m}", [srcs[0], wide], pos[:m], m)
        ragged = max(c159 // 1024 * 1024 - 347, 1)
        g_case(f"m={ragged} (a ragged last tile)", [srcs[0], wide],
               pos[:ragged], ragged)
        for off in (1, 2, 3):
            g_case(f"pos[{off}:] int32 view", [srcs[0], wide], pos[off:],
                   c159 - off)
        g_case("pos[1:] int64 view", [srcs[0], wide], pos.to(torch.int64)[1:],
               c159 - 1)
        g_case("source views [1:] (unaligned)", [srcs[0][1:], wide[1:]], pos,
               c159)
        ident = torch.arange(n, dtype=torch.int32, device=self.dev)
        g_case("identity positions k=3 int64/int64/int32", [wide, wides[1],
                                                            srcs[1]], ident, n)
        g_case("identity positions from 1 (a view)", [wide, srcs[1]],
               ident[1:], n - 1)
        g_case("identity positions, source views [1:]", [srcs[1][1:],
                                                         wide[1:]],
               ident[:n - 1], n - 1)
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed + 5)
        perm = torch.randperm(n, generator=gen, device=self.dev).to(
            torch.int32)
        g_case("random permutation", [srcs[0], wide], perm, n)
        g_case("valid=0, host", [srcs[0], wide], pos, 0)
        g_case("valid=0, device", [srcs[0], wide], pos,
               torch.tensor(0, device=self.dev))
        g_case("n=1", [srcs[0][:1], wide[:1]], pos, c159)
        del tail, dup, wides, ident, perm

        # the engine's shapes (a)-(f) (bench_gather.shapes): the kernel, its
        # plain version, torch.index_select, the byte bound and the bytes
        # counted in 32-byte sectors; (b) and (a) keep their names of
        # earlier runs
        cols = {c: self.col(c) for c in bench_gather.COLUMNS}
        rename = {"a": "gather k=1", "b": "gather"}
        for sh in bench_gather.shapes(cols, self.args.seed):
            ss, p, valid = sh.build()
            g_case(f"({sh.tag}) {sh.what}", ss, p, valid)
            ms, timed_launches = self.kernel_ms(
                "gather", lambda: sg.gather_many(ss, p, valid))
            plain_ms = self.cuda_ms(
                lambda: sg.gather_many_plain(ss, p, valid), REPS)
            posl = p.long()
            lib_ms = self.cuda_ms(
                lambda: [torch.index_select(s, 0, posl) for s in ss], REPS)
            self.kernel_time(
                rename.get(sh.tag, f"gather ({sh.tag})"),
                f"({sh.tag}) {sh.what}: k={len(ss)} "
                f"{'/'.join(str(s.dtype)[6:] for s in ss)}[{ss[0].shape[0]}] "
                f"at {str(p.dtype)[6:]}[{p.shape[0]}]", ms, plain_ms, lib_ms,
                _bound_ms(bench_gather.byte_count(ss, p)), timed_launches,
                sector_ms=_bound_ms(
                    bench_gather.sector_count(ss, p, valid)),
                blocks_per_sm=bench_gather.blocks_per_sm(_lib.lib(), ss, p))
            del ss, p, posl
        del cols

        # ---- fused aggregate
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery, \
            plan_to_vexps

        with engine_seam(env={"MPLAN2VDL_FUSED_AGG": "1"}):
            fam = CompiledQuery(self.cfg, plan_to_vexps(
                plans.PLAN_Q1, self.cfg), self.st, device="cuda").families[0]
        specs = list(fam.specs) + [multiagg.AggSpec(base=None, bits=1)]
        cols = [self.col(nm[1]).to(torch.int32) for nm in fam.load_names]
        rf, ls = self.col("l_returnflag"), self.col("l_linestatus")
        gid = torch.where(ship <= day(1998, 9, 2), rf * 2 + ls,
                          -1).to(torch.int32)

        def a_case(what, cs, g, sp, groups):
            path = ("lane" if multiagg.lane_path(groups, len(sp))
                    else "shared")
            got = multiagg.fused_group_aggregate(cs, g, sp, groups)
            want = multiagg.reference_group_aggregate(cs, g, sp, groups)
            self.equal(f"multiagg {what} ({path})", got, want)
            return path

        a_case(f"Q1 specs n={n}", cols, gid, specs, fam.domain)
        gneg = gid.clone()
        gneg[::7] = -5
        a_case("negative gid rows", cols, gneg, specs, fam.domain)
        odd = min(1_000_003, n)
        a_case(f"n={odd} (not a block multiple)", [c[:odd] for c in cols],
               gid[:odd], specs, fam.domain)
        nb = 150_001
        big = torch.full((nb,), 2**31 - 1, dtype=torch.int32, device=self.dev)
        zero = torch.zeros(nb, dtype=torch.int32, device=self.dev)
        near = [multiagg.AggSpec(base=0, factors=((100, -1, 1), (100, 1, 1)),
                                 bits=45),
                multiagg.AggSpec(base=0, bits=31, op="max"),
                multiagg.AggSpec(base=None, bits=1)]
        a_case("values near the bits bound", [big, zero],
               torch.zeros(nb, dtype=torch.int32, device=self.dev), near, 1)
        paths = set()
        g0 = torch.where(gid >= 0, 0, -1).to(torch.int32)
        paths.add(a_case("every row in one group", cols, g0, specs,
                         fam.domain))
        g16 = (rows * 2654435761 % 16).to(torch.int32)
        paths.add(a_case("16 groups x Q1's specs", cols, g16, specs, 16))
        g17 = (rows * 2654435761 % 17).to(torch.int32)
        paths.add(a_case("17 groups", cols, g17, specs, 17))
        many = specs + specs[:multiagg.LANE_MAX_SPECS + 1 - len(specs)]
        paths.add(a_case(f"{len(many)} specs", cols, gid, many, fam.domain))
        for k in (3, 100, 1000):
            paths.add(a_case(f"n={k} (below one block)", [c[:k] for c in cols],
                             gid[:k], specs, fam.domain))
        unaligned = [c[1:] for c in cols]
        paths.add(a_case("unaligned views", unaligned, gid[1:], specs,
                         fam.domain))
        if paths != {"lane", "shared"}:
            raise AssertionError(f"multiagg checked only {paths}")
        del g0, unaligned

        ms, timed_launches = self.kernel_ms("multiagg", lambda: (
            multiagg.fused_group_aggregate(cols, gid, specs, fam.domain)))
        plain_ms = self.cuda_ms(lambda: multiagg.reference_group_aggregate(
            cols, gid, specs, fam.domain), 2)
        self.kernel_time("multiagg", f"{len(specs)} Q1 specs x "
                         f"{fam.domain} groups over {len(cols)} int32[{n}] "
                         "columns + int32 gid", ms, plain_ms, None,
                         _bound_ms(4 * (len(cols) + 1) * n), timed_launches)
        # the fast path's largest engine family, and the general path
        for groups, g in ((16, g16), (17, g17)):
            ms = self.cuda_ms(lambda: multiagg.fused_group_aggregate(
                cols, g, specs, groups), REPS)
            path = "lane" if multiagg.lane_path(groups, len(specs)) \
                else "shared"
            self.kernel_time(f"multiagg {groups} groups ({path})",
                             f"{len(specs)} Q1 specs x {groups} groups, "
                             "hashed row ids", ms, None, None,
                             _bound_ms(4 * (len(cols) + 1) * n), None)
        del g16, g17

        self.scatter_kernel()
        self.small_gather_kernel()
        self.mxu_kernel(fam, cols, gid)
        self.radix_kernel()
        self.exprfold_kernel(m19)
        self.group_ids_kernel()

    def mxu_kernel(self, fam, cols, gid):
        """The tensor-core aggregate on Q1's sum specs (the family's sums
        and the appended count, as the engine routes them), and its corner
        cases on both of its paths; both paths timed beside multiagg.cu on
        the same specs."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import multiagg
        from mplan2vdl_tpu_torch.engine.kernels import multiagg_mxu as mx

        Spec = multiagg.AggSpec
        n = gid.shape[0]
        specs = [s for s in fam.specs if s.op == "sum"] + [
            Spec(base=None, bits=1)]
        used = {i for s in specs for i in
                ([] if s.base is None else [s.base])
                + [f[2] for f in s.factors]}
        rows = torch.arange(n, device=self.dev)

        def path(sp, groups):
            return "fast" if mx.fast_path(groups, sp) else "general"

        def x_case(what, cs, g, sp, groups, **kw):
            got = mx.fused_group_aggregate_mxu(cs, g, sp, groups, **kw)
            want = mx.fused_group_aggregate_mxu_plain(cs, g, sp, groups)
            self.equal(f"multiagg_mxu {what} ({path(sp, groups)})", got,
                       want)
            return path(sp, groups)

        paths = set()
        x_case(f"Q1 {len(specs)} sum specs n={n}", cols, gid, specs,
               fam.domain)
        gneg = gid.clone()
        gneg[::7] = -5
        gneg[3::7] = fam.domain  # past the last group: skipped too
        x_case("negative and too-large gid rows", cols, gneg, specs,
               fam.domain)
        del gneg
        # neither a multiple of 4 rows nor of a 128-row warp step
        for k in (min(1_000_003, n), min(128 * 1000 + 77, n), 3, 100):
            x_case(f"n={k} (not a step multiple)", [c[:k] for c in cols],
                   gid[:k], specs, fam.domain)
        x_case("unaligned views", [c[1:] for c in cols], gid[1:], specs,
               fam.domain)
        g16 = (rows * 2654435761 % 16).to(torch.int32)
        g17 = (rows * 2654435761 % 17).to(torch.int32)
        paths.add(x_case("16 groups", cols, g16, specs, 16))
        paths.add(x_case("17 groups", cols, g17, specs, 17))
        g37 = (rows * 2654435761 % 37).to(torch.int32)
        paths.add(x_case("37 groups (several group tiles)", cols, g37, specs,
                         37))
        del g37
        for k in (mx.FAST_MAX_SPECS, mx.FAST_MAX_SPECS + 1):
            many = (specs * 2)[:k]
            paths.add(x_case(f"{k} sum specs", cols, gid, many, fam.domain))
        # as tests/test_multiagg_mxu.py: base 2^31-1 times 1 + 32766, bits
        # 46; 100,003 rows keep every total below 2^63
        nb = min(100_003, n)
        big = torch.full((nb,), 2**31 - 1, dtype=torch.int32, device=self.dev)
        fac = torch.full((nb,), 32766, dtype=torch.int32, device=self.dev)
        near = [Spec(base=0, bits=31),
                Spec(base=0, factors=((1, 1, 1),), bits=46)]
        for groups in (3, 17):
            paths.add(x_case(f"values near the bits bound, {groups} groups",
                             [big, fac], (rows[:nb] % groups).to(torch.int32),
                             near, groups))
        # one block over every row, every byte plane 255: without the int32
        # flush a cell would pass 2^31 after 2^23 rows of a warp (one warp
        # takes them all) or of a block (the general path)
        full = [torch.full((n,), v, dtype=torch.int32, device=self.dev)
                for v in (2**16 - 1, 2**16, 2**24 - 1)]
        ff = [Spec(base=None, factors=((255, 0, 0),), bits=8),
              Spec(base=0, bits=16),
              Spec(base=2, bits=24),
              Spec(base=0, factors=((1, 1, 1),), bits=32)]  # 2^32 - 1
        zero = torch.zeros(n, dtype=torch.int32, device=self.dev)
        x_case(f"one block over {n} rows, every plane 255", full, zero, ff,
               1, max_blocks=1)
        x_case(f"one warp over {n} rows, every plane 255", full, zero, ff, 1,
               max_blocks=1, max_warps=1)
        paths.add(x_case(f"one block over {n} rows, every plane 255, 13 "
                         "specs", full, zero, (ff * 4)[:13], 1,
                         max_blocks=1))
        if paths != {"fast", "general"}:
            raise AssertionError(f"multiagg_mxu checked only {paths}")
        del full, zero, big, fac

        nbytes = 4 * (len(used) + 1) * n
        shape = (f"{len(specs)} Q1 sum specs x {{}} groups over "
                 f"{len(used)} int32[{n}] columns + int32 gid")
        ms, timed_launches = self.kernel_ms("multiagg_mxu", lambda: (
            mx.fused_group_aggregate_mxu(cols, gid, specs, fam.domain)))
        plain_ms = self.cuda_ms(lambda: mx.fused_group_aggregate_mxu_plain(
            cols, gid, specs, fam.domain), 2)
        self.kernel_time("multiagg_mxu", shape.format(fam.domain) + " ("
                         f"{path(specs, fam.domain)})", ms, plain_ms, None,
                         _bound_ms(nbytes), timed_launches)
        ms = self.cuda_ms(lambda: multiagg.fused_group_aggregate(
            cols, gid, specs, fam.domain), REPS)
        self.kernel_time("multiagg on the same sum specs",
                         shape.format(fam.domain), ms, None, None,
                         _bound_ms(nbytes), None)
        # the fast path's largest group count and the general path, hashed
        # row ids, each beside multiagg.cu on the same specs
        for groups, g in ((16, g16), (17, g17)):
            ms = self.cuda_ms(lambda: mx.fused_group_aggregate_mxu(
                cols, g, specs, groups), REPS)
            self.kernel_time(f"multiagg_mxu {groups} groups "
                             f"({path(specs, groups)})", shape.format(groups),
                             ms, None, None, _bound_ms(nbytes), None)
            ms = self.cuda_ms(lambda: multiagg.fused_group_aggregate(
                cols, g, specs, groups), REPS)
            self.kernel_time(f"multiagg {groups} groups on the same sum "
                             "specs", shape.format(groups), ms, None, None,
                             _bound_ms(nbytes), None)
        del g16, g17

    def radix_kernel(self):
        """The digit rank over the lineitem row count rounded up to a block
        (the sparse group-by's key count) at every digit width, 1 to 8
        bits, over random 24-bit, all-equal, ascending and alternating
        keys, and keys whose digit changes at each warp's 1024-key run;
        timed on the random keys with torch.sort beside it."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import radix_rank as rr

        n = -(-self.n // rr.BLOCK) * rr.BLOCK
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed + 2)
        keys = torch.randint(0, 1 << 24, (n,), generator=gen,
                             device=self.dev, dtype=torch.int32)
        i = torch.arange(n, dtype=torch.int32, device=self.dev)
        sets = (("random 24-bit", keys),
                ("all-equal", torch.full((n,), 0xABCDEF, dtype=torch.int32,
                                         device=self.dev)),
                ("ascending", i),
                # two digits that differ in every bit
                ("alternating", torch.where(i % 2 == 0, 0x5A5A5A5A,
                                            0x25A5A5A5).to(torch.int32)),
                ("warp-boundary", i // rr.WARP_KEYS))
        for nbits in range(1, 9):
            for what, x in sets:
                got = rr.radix_rank(x, nbits)
                self.equal(f"radix_rank nbits={nbits} {what} keys n={n}",
                           got, rr.radix_rank_plain(x, nbits))
        del sets, i
        for nbits, name in ((4, "radix_rank nbits=4"), (8, "radix_rank")):
            ms, timed_launches = self.kernel_ms(
                "radix_rank", lambda: rr.radix_rank(keys, nbits))
            plain_ms = self.cuda_ms(lambda: rr.radix_rank_plain(keys, nbits),
                                    1)
            self.kernel_time(name, f"int32[{n}] random 24-bit keys, "
                             f"{1 << nbits} buckets", ms, plain_ms, None,
                             _bound_ms(8 * n), timed_launches)
        ms = self.cuda_ms(lambda: torch.sort(keys, stable=True), REPS)
        self.kernel_time("torch.sort(stable=True) on the same keys",
                         f"int32[{n}] -> values + int64 indices", ms, None,
                         None, _bound_ms(n * (4 + 4 + 8)), None)

    def scatter_kernel(self):
        """The monotone scatter: every case of the CPU tests and the edges
        of its tiles and chunks, exact against the plain version; then the
        slots of an orders-sized table at 2%, 15% (the density of Q3's and
        Q5's mask-deduction scatters) and 100%, the edge cases there, and
        a few rows into just over 2^31 slots; times at the three
        densities."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import compact, scatter

        dev = self.dev

        def s_case(what, p, src, L):
            self.equal(f"scatter {what}", scatter.monotone_scatter(p, src, L),
                       scatter.monotone_scatter_plain(p, src, L))

        for what, p, src, L in (plans.scatter_cases()
                                + plans.scatter_edge_cases(scatter.TILE,
                                                           scatter.CHUNK)):
            s_case(f"{what} L={L}", torch.from_numpy(p).to(dev),
                   torch.from_numpy(src).to(dev), L)

        L = self.n_orders
        slots = torch.arange(L, device=dev)
        gen = torch.Generator(device=dev).manual_seed(self.args.seed)

        def positions(percent):
            m = (slots * 2654435761 % 100) < percent
            return compact.compact_positions(m, int(m.sum()))

        def rand(k, dtype):
            bits = 62 if dtype == torch.int64 else 30
            return torch.randint(-(1 << bits), 1 << bits, (k,),
                                 generator=gen, device=dev, dtype=dtype)

        p2, p15 = positions(2), positions(15)
        c2, c15 = p2.shape[0], p15.shape[0]
        pall = slots.to(torch.int32)
        s32 = rand(c15, torch.int32)
        s_case(f"L={L} 2% int32", p2, rand(c2, torch.int32), L)
        s_case(f"L={L} 15% int32", p15, s32, L)
        s_case(f"L={L} 15% int64", p15, rand(c15, torch.int64), L)
        s_case(f"L={L} 100% int32", pall, rand(L, torch.int32), L)
        s_case(f"L={L} 100% int64, int64 positions", slots,
               rand(L, torch.int64), L)
        tail = p15.clone()
        tail[c15 // 2:] = L
        s_case(f"L={L} 15%, invalid tail mapped to L", tail, s32, L)
        s_case(f"L={L} n=0", p15[:0], s32[:0], L)
        s_case(f"L={L} one valid row at L-1", torch.tensor(
            [L - 1], dtype=torch.int32, device=dev), s32[:1], L)
        s_case(f"L={L} all {c15} rows invalid", torch.full_like(p15, L),
               s32, L)
        s_case("L=0", p15, s32, 0)
        # int64 positions past 2^31 (the engine's pdt for L > INT32_MAX):
        # an int32 output of 8.6 GB, rows at its ends and around 2^31
        big = (1 << 31) + 5
        pbig = torch.tensor([0, 5, (1 << 31) - 1, 1 << 31, big - 1, big,
                             big + 3], dtype=torch.int64, device=dev)
        s_case(f"L={big} int64 positions, int32 source", pbig,
               rand(pbig.shape[0], torch.int32), big)
        self.sync()
        del pbig
        torch.cuda.empty_cache()

        for name, p, src in (("scatter", p15, s32),
                             ("scatter 2%", p2, rand(c2, torch.int32)),
                             ("scatter 100%", pall, rand(L, torch.int32))):
            c = p.shape[0]
            ms, timed_launches = self.kernel_ms(
                "scatter", lambda: scatter.monotone_scatter(p, src, L))
            plain_ms = self.cuda_ms(
                lambda: scatter.monotone_scatter_plain(p, src, L), REPS)
            p64 = p.long()
            lib_ms = self.cuda_ms(lambda: torch.zeros(
                L, dtype=src.dtype, device=dev).index_copy_(0, p64, src),
                REPS)
            self.kernel_time(name, f"int32[{c}] at ascending int32 "
                             f"positions into int32[{L}] "
                             f"({100 * c / L:.1f}%)", ms, plain_ms, lib_ms,
                             _bound_ms(c * (4 + 4) + 4 * L), timed_launches)

    def small_gather_kernel(self):
        """The small-table gather at lineitem-many random positions into
        tables of region, nation and SMALL_TABLE size."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import _lib
        from mplan2vdl_tpu_torch.engine.kernels import sorted_gather as sg

        m = self.n
        budget = _lib.lib().m2v_small_gather_smem_budget()
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed + 1)

        def table(k, dtype):
            bits = 62 if dtype == torch.int64 else 30
            return torch.randint(-(1 << bits), 1 << bits, (k,),
                                 generator=gen, device=self.dev, dtype=dtype)

        def positions(n):
            return torch.randint(0, n, (m,), generator=gen, device=self.dev,
                                 dtype=torch.int32)

        def g_case(what, ss, p):
            nbytes = sum(-(-s.numel() * s.element_size() // 16) * 16
                         for s in ss)
            branch = "shared" if nbytes <= budget else "ldg"
            got = sg.gather_many(ss, p, m, small=True)
            want = sg.small_gather_plain(ss, p)
            self.equal(f"small_gather {what} ({branch})", got, want)
            return branch

        branches = set()
        for n in (5, 25, sg.SMALL_TABLE):
            p = positions(n)
            t32, t64 = table(n, torch.int32), table(n, torch.int64)
            branches.add(g_case(f"k=1 int32[{n}]", [t32], p))
            branches.add(g_case(f"k=3 int32/int64/int32 [{n}]",
                                [t32, t64, table(n, torch.int32)], p))
        wild = positions(25)
        wild[::3] = -7
        wild[1::3] = 25 + 1000
        branches.add(g_case("out-of-range positions clip",
                            [table(25, torch.int32)], wild))
        p64 = positions(25).to(torch.int64)
        branches.add(g_case("int64 positions", [table(25, torch.int64)],
                            p64))
        ten = [table(25, torch.int32) for _ in range(9)] + [
            table(25, torch.int64)]
        branches.add(g_case("k=10 (two launches)", ten, positions(25)))
        if branches != {"shared", "ldg"}:
            raise AssertionError(f"small_gather checked only {branches}")

        # Q5's shape: one int32 nation column at lineitem-many positions
        t25, p25 = table(25, torch.int32), positions(25)
        ms, timed_launches = self.kernel_ms(
            "small_gather", lambda: sg.small_table_gather(t25, p25, m))
        plain_ms = self.cuda_ms(lambda: sg.small_gather_plain([t25], p25),
                                REPS)
        pl = p25.long()
        lib_ms = self.cuda_ms(lambda: torch.index_select(t25, 0, pl), REPS)
        self.kernel_time("small_gather", f"k=1 int32[25] at int32[{m}] "
                         "random positions", ms, plain_ms, lib_ms,
                         _bound_ms(m * 4 + m * 4 + 25 * 4), timed_launches)
        # the batched call (gather_many(small=True)): three nation-sized
        # columns, mixed widths, sharing the positions
        t3 = [t25, table(25, torch.int64), table(25, torch.int32)]
        ms, timed_launches = self.kernel_ms(
            "small_gather", lambda: sg.gather_many(t3, p25, m, small=True))
        plain_ms = self.cuda_ms(lambda: sg.small_gather_plain(t3, p25), REPS)
        lib_ms = self.cuda_ms(
            lambda: [torch.index_select(t, 0, pl) for t in t3], REPS)
        nbytes = m * 4 + sum((m + 25) * t.element_size() for t in t3)
        self.kernel_time("small_gather k=3", "k=3 int32/int64/int32[25] at "
                         f"int32[{m}] random positions", ms, plain_ms,
                         lib_ms, _bound_ms(nbytes), timed_launches)

    def exprfold_kernel(self, q6_mask):
        """The expression fold: Q6's call as the engine makes it (its
        program, immediates and resident lineitem columns), exact against
        the plain version and the library expression over every row, over
        a ragged count of them and over unaligned views; the random
        programs of ``tests/torch_exprfold_cases.py`` (every leaf dtype,
        64-bit values, sum, min and max) at every lineitem row and at a
        ragged count; one launch a call.  Then Q6's call timed beside its
        plain version and ``torch.where(mask, price * disc, 0).sum()``
        (``q6_mask``, Q6's mask, already made)."""
        torch = self.torch
        from mplan2vdl_tpu_torch import mplan as M
        from mplan2vdl_tpu_torch import vir as V
        from mplan2vdl_tpu_torch.engine import datagen, exprfold, lower
        from mplan2vdl_tpu_torch.engine.kernels import exprfold as kx

        import torch_exprfold_cases as cases

        def check(what, leaves, program, imms, foldop, fold32):
            before = kx.launches
            got = kx.expr_fold(leaves, program, imms, foldop, fold32)
            if kx.launches != before + 1:
                raise AssertionError(f"exprfold {what}: "
                                     f"{kx.launches - before} launches")
            want = kx.expr_fold_plain(leaves, program, imms, foldop, fold32)
            self.equal(f"exprfold {what}", got, want)
            return got

        calls = []

        def record(fold, *a):
            calls.append(a)
            return fold(*a)

        cq = lower.CompiledQuery(self.cfg, lower.plan_to_vexps(
            plans.PLAN_Q6, self.cfg), self.st, device=self.dev)
        with engine_seam(wrap={"expr_fold": record}):
            cq()
        if cq.expr_folds != 1 or len(calls) != 1:
            raise AssertionError(f"Q6: {cq.expr_folds} one-pass folds, "
                                 f"{len(calls)} calls, not one")
        (plan,) = cq.expr_plans.values()
        leaves, program, imms, foldop, fold32 = calls[0]
        n = leaves[0].shape[0]
        col = dict(zip((v.vx.name[1] for v in plan.leaves), leaves))
        price, disc = col["l_extendedprice"], col["l_discount"]
        got = check(f"Q6 {len(leaves)} int32[{n}]", *calls[0])
        lib = [int(torch.where(q6_mask, price * disc, 0).sum()),
               int(q6_mask.sum())]
        if got.tolist() != lib:
            raise AssertionError(f"exprfold Q6: {got.tolist()}, library "
                                 f"expression {lib}")
        ragged = 1_000_003
        check(f"Q6 n={ragged}", [t[:ragged] for t in leaves], program, imms,
              foldop, fold32)
        check("Q6 unaligned views", [t[3:] for t in leaves], program, imms,
              foldop, fold32)
        del cq

        st = datagen.generate(sf=0.001, seed=5)
        cases.add_leaves(st, 5)
        widths = set()
        for i, (name, p) in enumerate(cases.card_plans(
                st.make_catalog(), V, M, exprfold.plan_fold)):
            for rows in (n, ragged):
                data = cases.leaf_data(torch, p, rows, self.dev,
                                       self.args.seed + i)
                check(f"{name} {len(p.program)} steps n={rows}", data,
                      p.program, cases.immediates(p), p.foldop, p.fold32)
                widths.add(any(t.dtype == torch.int64 for t in data))
                del data
        if widths != {False, True}:
            raise AssertionError("exprfold: the random programs read int64 "
                                 f"leaves in none or all ({widths})")

        args = (leaves, program, imms, foldop, fold32)
        ms, timed_launches = self.kernel_ms("exprfold",
                                            lambda: kx.expr_fold(*args))
        plain_ms = self.cuda_ms(lambda: kx.expr_fold_plain(*args), 3)
        lib_ms = self.cuda_ms(lambda: torch.where(
            q6_mask, price * disc, 0).sum(), REPS)
        nbytes = sum(t.numel() * t.element_size() for t in leaves) + 24
        self.kernel_time("exprfold", f"Q6's fold: {len(leaves)} int32[{n}] "
                         f"leaves, {len(program)} steps", ms, plain_ms,
                         lib_ms, _bound_ms(nbytes), timed_launches)

    def group_ids_kernel(self):
        """The group ids: Q1's call as the engine makes it with
        MPLAN2VDL_FUSED_AGG=1 (its program, immediates and resident
        lineitem columns), exact against the plain version and the library
        expression over every row, over a ragged count of them and over
        unaligned views; the random keys of
        ``tests/torch_exprfold_cases.py`` (every leaf dtype, 64-bit values,
        pivots below, inside and above the keys) at every lineitem row and
        at a ragged count; one launch a call.  Then Q1's call timed beside
        its plain version and the library yardstick
        ``torch.where(shipdate <= k, ((rf << 1) | ls).clamp(0, 7), -1)``,
        which the engine never calls."""
        torch = self.torch
        from mplan2vdl_tpu_torch import mplan as M
        from mplan2vdl_tpu_torch import vir as V
        from mplan2vdl_tpu_torch.engine import datagen, exprfold, lower
        from mplan2vdl_tpu_torch.engine.kernels import exprfold as kx
        from mplan2vdl_tpu_torch.oracle.tpch import day

        import torch_exprfold_cases as cases

        def check(what, leaves, program, imms, rmin, rcount):
            before = kx.group_launches
            got = kx.group_ids(leaves, program, imms, rmin, rcount)
            if kx.group_launches != before + 1:
                raise AssertionError(f"group_ids {what}: "
                                     f"{kx.group_launches - before} launches")
            want = kx.group_ids_plain(leaves, program, imms, rmin, rcount)
            self.equal(f"group_ids {what}", got, want)
            return got

        calls = []

        def record(ids, *a):
            calls.append(a)
            return ids(*a)

        with engine_seam(env={"MPLAN2VDL_FUSED_AGG": "1"}):
            cq = lower.CompiledQuery(self.cfg, lower.plan_to_vexps(
                plans.PLAN_Q1, self.cfg), self.st, device=self.dev)
            with engine_seam(wrap={"group_ids": record}):
                cq()
        if cq.key_programs != 1 or len(calls) != 1:
            raise AssertionError(f"Q1 fused: {cq.key_programs} group-id "
                                 f"passes, {len(calls)} calls, not one")
        (plan,) = cq.key_plans.values()
        leaves, program, imms, rmin, rcount = calls[0]
        n = leaves[0].shape[0]
        col = dict(zip((v.vx.name[1] for v in plan.leaves), leaves))
        ship, rf, ls = (col["l_shipdate"], col["l_returnflag"],
                        col["l_linestatus"])
        got = check(f"Q1 {len(leaves)} int32[{n}]", *calls[0])
        cut = day(1998, 9, 2)

        def library():
            return torch.where(ship <= cut, ((rf << 1) | ls).clamp(0, 7), -1)

        if not torch.equal(got, library().to(torch.int32)):
            raise AssertionError("group_ids Q1: the ids differ from the "
                                 "library expression's")
        ragged = 1_000_003
        check(f"Q1 n={ragged}", [t[:ragged] for t in leaves], program, imms,
              rmin, rcount)
        check("Q1 unaligned views", [t[3:] for t in leaves], program, imms,
              rmin, rcount)
        del cq, got

        st = datagen.generate(sf=0.001, seed=5)
        cases.add_leaves(st, 5)
        widths = set()
        for i, (name, p) in enumerate(cases.key_plans(
                st.make_catalog(), V, M, exprfold.plan_group_ids)):
            for rows in (n, ragged):
                data = cases.leaf_data(torch, p, rows, self.dev,
                                       self.args.seed + 100 + i)
                check(f"{name} {len(p.program)} steps n={rows}", data,
                      p.program, cases.immediates(p), p.rmin, p.rcount)
                widths.add(any(t.dtype == torch.int64 for t in data))
                del data
        if widths != {False, True}:
            raise AssertionError("group_ids: the random keys read int64 "
                                 f"leaves in none or all ({widths})")

        args = (leaves, program, imms, rmin, rcount)
        ms, timed_launches = self.kernel_ms("group_ids",
                                            lambda: kx.group_ids(*args))
        plain_ms = self.cuda_ms(lambda: kx.group_ids_plain(*args), 3)
        lib_ms = self.cuda_ms(library, REPS)
        nbytes = sum(t.numel() * t.element_size() for t in leaves) + 4 * n
        self.kernel_time("group_ids", f"Q1's ids: {len(leaves)} int32[{n}] "
                         f"leaves, {len(program)} steps, int32[{n}] ids", ms,
                         plain_ms, lib_ms, _bound_ms(nbytes), timed_launches)

    def kernel_time(self, name, shape, ms, plain_ms, lib_ms, bound_ms,
                    launches, **extra):
        rec = {"kernel": name, "shape": shape, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "launches": launches, **extra,
               "card": self.smi}
        self.timed[name] = rec
        self.records["kernel_times"].append(rec)
        print(json.dumps(rec), flush=True)

    def plan_checks(self):
        """``AUTO_PLANS`` name -> the check of a result of that plan against
        its oracle (Q4, Q16, Q4 over all orders and the filter-project in
        order, Q3's top 10 tie-tolerantly), built once for phases 4 and 8;
        each oracle's seconds are printed as it runs."""
        if getattr(self, "_checks", None) is not None:
            return self._checks
        import numpy as np

        from mplan2vdl_tpu_torch.oracle import tpch

        st, P = self.st, plans

        def rows(columns, want, in_order=False):
            def check(res):
                assert [nm[-1] for nm in res.names] == columns, res.names
                if not in_order:
                    assert P.same_rows(res.columns, want), "rows differ"
                    return
                assert len(res.columns) == len(want)
                for g, w in zip(res.columns, want):
                    assert np.array_equal(np.asarray(g, np.int64),
                                          np.asarray(w, np.int64)), \
                        "rows differ or are out of order"
            return check

        def want(oracle):
            return self.oracle(oracle, st)

        want_q6, want_q1 = self.tpch_want("q6"), self.tpch_want("q1")
        ship = st.columns[("lineitem", "l_shipdate")]
        fp = (ship >= tpch.day(1994, 1, 1)) & (ship < tpch.day(1995, 1, 1))
        want_q3 = want(P.oracle_q3)
        top10 = P.q3_top10(want_q3)

        def check_top10(res):
            # tie-tolerant: sorted by revenue descending, then o_orderdate,
            # and the same multiset of (revenue, o_orderdate) as the oracle
            assert [nm[-1] for nm in res.names] == P.Q3_COLUMNS, res.names
            rev = np.asarray(res.columns[1], np.int64)
            date = np.asarray(res.columns[2], np.int64)
            keys = list(zip((-rev).tolist(), date.tolist()))
            assert len(keys) == 10 and keys == sorted(keys), "not sorted"
            assert sorted(zip(rev.tolist(), date.tolist())) == sorted(zip(
                np.asarray(top10[1], np.int64).tolist(),
                np.asarray(top10[2], np.int64).tolist())), \
                "order keys differ"

        self._checks = {
            "q6": rows(["revenue"], [want_q6["revenue"]]),
            "q1": rows(P.Q1_COLUMNS, [want_q1[k] for k in P.Q1_COLUMNS]),
            "filter_project": rows(P.FP_COLUMNS, [
                st.columns[("lineitem", c)][fp] for c in P.FP_COLUMNS],
                in_order=True),
            "q3": rows(P.Q3_COLUMNS, want_q3), "q3_top10": check_top10,
            "q5": rows(P.Q5_COLUMNS, want(P.oracle_q5)),
            "sparse_groupby": rows(P.SPARSE_COLUMNS,
                                   want(P.oracle_sparse_groupby)),
            "q9": rows(P.Q9_COLUMNS, want(P.oracle_q9)),
            "q13": rows(P.Q13_COLUMNS, want(P.oracle_q13)),
            "q17": rows(P.Q17_COLUMNS, want(P.oracle_q17)),
            "substr_groupby": rows(P.SUBSTR_COLUMNS,
                                   want(P.oracle_substr_groupby)),
            "q4": rows(P.Q4_COLUMNS, want(P.oracle_q4), in_order=True),
            "q16": rows(P.Q16_COLUMNS, want(P.oracle_q16), in_order=True),
            "self_join": rows(P.SELF_JOIN_COLUMNS,
                              want(P.oracle_self_join)),
            "dense_join": rows(P.DENSE_JOIN_COLUMNS,
                               want(P.oracle_dense_join)),
            "distinct_dense": rows(P.DISTINCT_DENSE_COLUMNS,
                                   want(P.oracle_distinct_dense)),
            "distinct_wide": rows(P.DISTINCT_WIDE_COLUMNS,
                                  want(P.oracle_distinct_wide)),
            "q4_all": rows(P.Q4_COLUMNS, want(P.oracle_q4_all),
                           in_order=True),
            "hot_join": rows(P.SELF_JOIN_COLUMNS, want(P.oracle_hot_join)),
            "q13_nation": rows(P.Q13_NATION_COLUMNS,
                               want(P.oracle_q13_nation))}
        return self._checks

    def query_runs(self):
        """Phase 4's runs: (name, ``CLI_PLANS`` key, MPLAN2VDL_FUSED_AGG,
        the engine kernels the run must launch); MPLAN2VDL_MXU_AGG is set
        for the Q1_MXU run only."""
        from mplan2vdl_tpu_torch.engine.lower import fused_agg_on

        if fused_agg_on(self.st, [("lineitem", "l_quantity")]):
            q1 = [("Q1 fused (auto gate)", "q1", None,
                   "compact multiagg group_ids")]
        else:
            q1 = [("Q1 (auto gate: unfused)", "q1", None, "compact"),
                  ("Q1 fused (forced)", "q1", "1",
                   "compact multiagg group_ids")]
        joins, ordered = "compact gather small_gather", " ".join(
            ORDERED_KERNELS)
        runs = [("Q6", "q6", None, "compact exprfold"), *q1,
                (Q1_MXU, "q1", "1",
                 "compact multiagg_mxu multiagg group_ids"),
                ("Q1 unfused (MPLAN2VDL_FUSED_AGG=0)", "q1", "0", "compact"),
                ("filter-project", "filter_project", None, ""),
                ("Q3", "q3", None, "compact gather scatter"),
                ("Q5", "q5", None, "compact gather scatter small_gather"),
                ("sparse group-by", "sparse_groupby", None, "compact gather"),
                ("Q9", "q9", None, joins + " scatter"),
                ("Q13", "q13", None, joins),
                ("Q17", "q17", None, "compact gather"),
                ("substring group-by", "substr_groupby", None,
                 "compact small_gather"),
                ("Q4", "q4", None, ordered),
                ("Q3 top 10", "q3_top10", None, ordered),
                ("Q16", "q16", None, ordered),
                (plans.DENSE_JOIN_RUN, "dense_join", None, joins),
                (plans.DISTINCT_DENSE_RUN, "distinct_dense", None, "compact"),
                (plans.DISTINCT_WIDE_RUN, "distinct_wide", None,
                 "compact gather"),
                (plans.Q4_ALL_RUN, "q4_all", None, joins)]
        return [(n, k, f, tuple(must.split())) for n, k, f, must in runs]

    def query_phase(self):
        """Phase 4: each run of ``query_runs`` (``query_run``), then the
        engine kernels each must have launched over them all and over the
        general-join runs, the ``{"gather_census": ...}`` line of every
        gather.cu launch by class, and the Semisort run."""
        counters = kernel_counters()
        chk = self.plan_checks()
        totals = {k: 0 for k in counters}, {k: 0 for k in counters}
        seen = FirstRuns()
        for name, key, fused, must in self.query_runs():
            env = {"MPLAN2VDL_FUSED_AGG": fused,
                   "MPLAN2VDL_MXU_AGG": "1" if name == Q1_MXU else None}
            with engine_seam(env=env):
                self.query_run(name, key, must, chk[key], counters, totals,
                               seen)
        total, join_total = totals
        self.launches = total
        self.gather_census(seen.census)
        self.records["engine_scatters"] = seen.scatters
        self.records["repeat_scatters"] = seen.repeats
        print(json.dumps({"engine_scatters": seen.scatters}), flush=True)
        if self.args.profile:
            dev = {k: [0, 0.0] for k in counters}
            for rec in self.records["queries"]:
                for k, (c, t) in rec["profile"]["kernels"].items():
                    dev[k][0] += c
                    dev[k][1] += t
            self.records["main_path_device_ms"] = dev
            print(json.dumps({"main_path_device_ms": dev}), flush=True)
        for k, v in total.items():
            if v == 0:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     "queries")
        idle = [k for k in JOIN_KERNELS if join_total[k] == 0]
        if idle:
            raise AssertionError(f"the general-join runs launched no {idle}")
        print(json.dumps({"main_path_launches": total,
                          "general_join_launches": join_total}), flush=True)
        self.semisort_run()

    def query_run(self, name, key, must, check, counters, totals, seen):
        """One run of phase 4: its first call watched (``seen``) and held to
        ``check``, its launches (added to ``totals``) and its path; then 5
        warm calls timed, and the run's ``{"query": ...}`` line."""
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery, \
            plan_to_vexps

        cq = CompiledQuery(self.cfg, plan_to_vexps(plans.CLI_PLANS[key],
                                                   self.cfg),
                           self.st, device=self.dev)
        (load_ms,) = self.warm_ms(cq.device_args, 1)
        reset_launches(counters)
        with engine_seam(wrap=seen.spies(name)):
            res = cq()
        launches = read_launches(counters)
        for k in counters:
            totals[0][k] += launches[k]
            if name in JOIN_RUNS:
                totals[1][k] += launches[k]
        # each equijoin of the first call: side, path, sizes, and the
        # counts it read to the host
        path = seen.paths[name]
        for j in cq.join_log:
            path["dense_joins" if j["path"] == "dense" else "merge_joins"] += 1
            print(json.dumps({"join": name, **j}), flush=True)
        repeats = seen.repeats.get(name, [])
        for r in repeats:
            print(json.dumps({"repeat_scatter": name, **r}), flush=True)
        check(res)
        self.check_path(name, path, cq.join_log, repeats)
        if name == "Q4" and (len(repeats) != 1 or repeats[0]["distinct"]
                             >= repeats[0]["valid"]):
            # the semijoin's marks: one scatter through repeated positions
            # (several late lineitems of one order)
            raise AssertionError(f"Q4: repeated-position scatters "
                                 f"{repeats}, not one with repeats")
        # exact counts: a fused family is one launch (on the tensor cores
        # only under MPLAN2VDL_MXU_AGG) and its group ids one more; Q6's
        # sum is computed in one pass, and Q1's folds take the fused family
        # or the grouped path
        fused = int("multiagg" in must)
        exact = {"multiagg_mxu": int(name == Q1_MXU),
                 **({"multiagg": 1} if fused else {}),
                 **{"q6": {"exprfold": 1, "group_ids": 0},
                    "q1": {"exprfold": 0, "group_ids": fused}}.get(key, {})}
        idle = [k for k in must if launches[k] == 0]
        wrong = {k: launches[k] for k, n in exact.items() if launches[k] != n}
        if idle or wrong:
            raise AssertionError(f"{name} launched no {idle} kernel, or not "
                                 f"{exact} launches: {wrong}")
        self.torch.cuda.reset_peak_memory_stats()
        times = self.warm_ms(cq.run, 5)
        med = statistics.median(times)
        # least time: each loaded column read once, each result written
        nbytes = (sum(a.numel() * a.element_size()
                      for a in cq.device_args())
                  + sum(c.nbytes for c in res.columns))
        # rows of the largest table the query reads
        rows_in = max(a.shape[0] for a in cq.device_args())
        rec = {"query": name, "plan": key, "sf": self.args.sf,
               "rows_in": rows_in, "rows_out": len(res.columns[0]),
               "median_ms": med, "ms": times,
               "rows_per_s": rows_in / (med / 1e3),
               "bound_ms": _bound_ms(nbytes), "load_ms": load_ms,
               "peak_gb": self.torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches, "host_syncs": cq.host_syncs,
               "joins": cq.join_log, "repeat_scatters": repeats,
               "paths": path, "card": self.smi}
        if self.args.profile:
            index = {k: i for i, k in enumerate(seen.census)}
            rec["profile"] = self.profile(
                name, cq, [(index[k], k) for k in seen.seq[name]])
            for i, (c, t) in rec["profile"]["gather_classes"].items():
                if i >= 0:
                    cls = seen.census[list(seen.census)[i]]
                    cls["device_ms"] = cls.get("device_ms", 0.0) + t
        self.records["queries"].append(rec)
        print(json.dumps(rec), flush=True)

    def semisort_run(self):
        """Phase 4's run of the one VIR node no plan emits: ``Semisort``
        over sum(l_quantity) per l_orderkey, a sparse fold whose buffer
        has rows past its valid count, built by hand as
        tests/test_torch_ordered.py builds it.  The fold's valid rows must
        be the per-order sums, and the permutation must equal the stable
        argsort of the whole buffer, padding included, on the host
        (``np.argsort(kind="stable")``); then 5 warm calls are timed.  One
        ``{"path": "Semisort", ...}`` line."""
        import numpy as np

        from mplan2vdl_tpu_torch import vir as V
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery

        cfg = self.cfg
        fold = V.complete(V.Fold(
            foldop=V.FSUM, fgroups=V.load_raw(cfg, ("lineitem", "l_orderkey")),
            fdata=V.load_raw(cfg, ("lineitem", "l_quantity"))))
        cq = CompiledQuery(cfg, [fold, V.complete(V.Semisort(sdata=fold))],
                           self.st, device=self.dev)
        cq.device_args()
        counters = kernel_counters()
        reset_launches(counters)
        self.sync()
        t0 = time.perf_counter()
        buf, perm = cq.run()
        self.sync()
        cold_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches(counters)
        valid, length = int(buf.valid), buf.length
        data = buf.data.cpu().numpy()
        got = perm.data.cpu().numpy()
        t0 = time.perf_counter()
        want = np.argsort(data, kind="stable")
        argsort_s = time.perf_counter() - t0
        c = lambda n: self.st.columns[("lineitem", n)]  # noqa: E731
        _, sums = plans._group([c("l_orderkey")], [(c("l_quantity"), np.add)])
        times = self.warm_ms(cq.run, 5)
        rec = {"path": SEMISORT_RUN, "sf": self.args.sf, "n": length,
               "valid": valid, "padding": length - valid,
               "dtype": str(perm.data.dtype), "cold_ms": cold_ms,
               "median_ms": statistics.median(times), "ms": times,
               "host_argsort_s": argsort_s, "launches": launches,
               "card": self.smi}
        self.records["semisort"] = rec
        print(json.dumps(rec), flush=True)
        if not (length - valid > 0 and np.array_equal(data[:valid], sums)):
            raise AssertionError(f"Semisort: the fold's buffer ({valid} of "
                                 f"{length} rows valid) is not the per-order"
                                 " sums with padding past them")
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError("Semisort: the permutation differs from the "
                                 "stable argsort of the whole buffer")

    def gather_census(self, census):
        """Prints the ``{"gather_census": ...}`` line: every class of
        gather.cu launches of the phase's first runs, largest byte total
        first, with the device ms the profiler gave each class (under
        ``--profile``) beside the gather kernels' device ms of the same
        profiles."""
        classes = sorted(census.values(), reverse=True,
                         key=lambda c: c["bound_ms"] * c["calls"])
        line = {"gather_census": classes,
                "calls": sum(c["calls"] for c in classes),
                "launches": sum(c["launches"] for c in classes)}
        if self.args.profile:
            line["device_ms"] = sum(c.get("device_ms", 0.0) for c in classes)
            line["profile_gather_ms"] = sum(
                q["profile"]["kernels"].get("gather", (0, 0.0))[1]
                for q in self.records["queries"])
            # the classes' ranges hold every gather kernel the profiles saw
            if abs(line["device_ms"] - line["profile_gather_ms"]) > 1e-6 * (
                    1 + line["profile_gather_ms"]):
                raise AssertionError(
                    f"the gather census's classes hold {line['device_ms']} "
                    f"device ms, the profiles' gather kernels "
                    f"{line['profile_gather_ms']}")
        self.records["gather_census"] = line
        print(json.dumps(line), flush=True)

    def check_path(self, name, rec, joins, repeats):
        """The run of a path no other plan reaches at SF10 must take it, as
        its first call showed (``query_run``): every equijoin of the join
        log dense; every count(DISTINCT) over at most segred.SMALL_DOMAIN
        ids; a pair sort past lower.PACK_LIMIT (two stable sorts); one
        repeated-position scatter with repeats, of more positions than half
        of lineitem.  The run's ``{"path": ...}`` line shows what was
        taken."""
        from mplan2vdl_tpu_torch.engine.kernels import segred

        if name == plans.DENSE_JOIN_RUN:
            ok = {j["path"] for j in joins} == {"dense"}
        elif name == plans.DISTINCT_DENSE_RUN:
            ok = (rec["distinct_domains"] != [] and max(
                rec["distinct_domains"]) <= segred.SMALL_DOMAIN)
        elif name == plans.DISTINCT_WIDE_RUN:
            ok = any(not p["packed"] for p in rec["pair_sorts"])
        elif name == plans.Q4_ALL_RUN:
            ok = (len(repeats) == 1 and repeats[0]["n"] > self.n // 2
                  and repeats[0]["distinct"] < repeats[0]["valid"])
        else:
            return
        print(json.dumps({"path": name, **rec, "joins": joins,
                          "repeat_scatters": repeats}), flush=True)
        if not ok:
            raise AssertionError(f"{name} did not take its path: {rec}, "
                                 f"joins {joins}, scatters {repeats}")

    def probe_phase(self):
        """Runs the two probe tools on the card with their launch counters
        reset around them; holds every pattern kernel, and the contraction
        kernels at the edges of their design (``probe_contract_cases``),
        exactly equal to its plain version; checks under torch.profiler
        that one call of each probe runs one device kernel; then records
        each probe's device and host microseconds beside its library
        expression's, and times the probes, their plain versions, their
        library expressions and an empty launch in interleaved turns
        (``tools/bench_probes.py``)."""
        from mplan2vdl_tpu_torch.engine.kernels import probes as P
        from mplan2vdl_tpu_torch.engine.kernels import radix_rank as rr
        from mplan2vdl_tpu_torch.tools import bench_probes as B
        from mplan2vdl_tpu_torch.tools import probe_kernels, probe_radix

        torch = self.torch
        counters = kernel_counters(probe=True)
        reset_launches(counters)
        rows = probe_kernels.run(self.dev)
        n = -(-self.n // rr.BLOCK) * rr.BLOCK
        sizes = list(probe_radix.DEFAULT_SIZES) + [n]
        self.records["probe_radix"] = probe_radix.run(sizes, dev=self.dev)
        self.probe_launches = read_launches(counters)
        print(json.dumps({"probe_launches": self.probe_launches}),
              flush=True)
        bad = [name for name, ok in rows if not ok]
        if bad:
            raise AssertionError(f"kernel probes wrong: {bad}")
        for k, v in self.probe_launches.items():
            if v == 0:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     "probe tools")

        probes = probe_kernels.make_probes(self.dev)
        for p in probes:
            self.equal(f"probes {p.name}", p.run(P), p.run(P.PLAIN))
            if not B.check_library(p):
                raise AssertionError(f"{p.name}: the library expression "
                                     f"{B.library(p)[0]} is wrong")
        for name, op, a, rhs, kw in plans.probe_contract_cases():
            a = torch.from_numpy(a).to(self.dev)
            rhs = torch.from_numpy(rhs).to(self.dev)
            if op == "fma":
                def run(ops):
                    return ops.fma_contract(a, rhs, kw["m"], kw["n"],
                                            kw["k"], kw["mode"], kw["key"],
                                            kw["batch"])
            else:
                def run(ops):
                    return ops.mma_contract(a, kw["nlimb"], rhs, kw["m"],
                                            kw["n"], kw["k"], kw["mode"],
                                            kw["key"], kw["batch"])
            self.equal(f"probes {name}", run(P), run(P.PLAIN))
            del a, rhs
        one = B.one_kernel_each(probes)
        print(json.dumps({"probe_kernels_per_call": {
            k: v["kernels"] for k, v in one.items()}}), flush=True)

        timed = B.turns(probes, self.dev, PROBE_TURNS, PROBE_REPS)
        tot = {"plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for p in probes:
            text, calls, lib = B.library(p)
            rec = {"probe": p.name, **timed["probes"][p.name],
                   "library": text, "library_calls": calls,
                   "bound_ms": _bound_ms(p.nbytes(p.run(P))),
                   "device": B.device(lambda: p.run(P)),
                   "host_us": B.host_us(lambda: p.run(P), PROBE_HOST_CALLS),
                   "library_device": B.device(lib),
                   "library_host_us": B.host_us(lib, PROBE_HOST_CALLS),
                   "card": self.smi}
            for k in tot:
                tot[k] += rec[k]
            self.records.setdefault("probe_times", []).append(rec)
            print(json.dumps(rec), flush=True)
        # the probes are launch-bound: their bound is the larger of their
        # bytes at the memory rate and their launches, one pass of the 15
        # runs, at the time of an empty launch through the same path
        per_pass, noop_ms = timed["launches"], timed["noop_ms"]
        slower = [p.name for p in probes
                  if timed["probes"][p.name]["ms"]
                  > timed["probes"][p.name]["library_ms"]]
        self.probe_bound = {"bytes_ms": tot["bound_ms"], "noop_ms": noop_ms,
                            "launches": per_pass,
                            "launches_ms": per_pass * noop_ms,
                            "turns": timed["turns"],
                            "min_share": timed["min_share"],
                            "slower_than_library": slower,
                            "noop_host_us": B.host_us(
                                lambda: P.noop(self.dev), PROBE_HOST_CALLS)}
        print(json.dumps({"probe_bound": self.probe_bound}), flush=True)
        self.kernel_time("probes", "the 15 probe runs (12 probes and 3 "
                         "tensor-core variants), summed; the median of "
                         f"{PROBE_TURNS} interleaved turns", timed["ms"],
                         tot["plain_ms"], tot["library_ms"],
                         max(tot["bound_ms"], per_pass * noop_ms), per_pass)

    def cli(self, argv, timeout):
        """``python -m mplan2vdl_tpu_torch ARGV`` from the repo's root, run
        to its end; the finished process, with its wall ``seconds``.  Fails
        with the end of its stderr when it exits nonzero."""
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "mplan2vdl_tpu_torch",
                            *argv], cwd=REPO, capture_output=True,
                           text=True, timeout=timeout)
        p.seconds = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"{' '.join(argv[:2])} exited "
                                 f"{p.returncode}: {p.stderr[-3000:]}")
        return p

    def cli_phase(self):
        """Phase 6: the command line, each command in its own process.
        ``genplans``, ``compile``, ``compile --dot`` and ``explain`` of every
        in-code plan against metadata files of the store (no device); Q5
        through ``run`` on the card with ``--roofline`` and ``--profile``,
        row-exact, its trace naming its four kernels' launches; Q1 and Q16
        through ``run --tbl`` of .tbl files written from a TBL_SF store,
        equal to ``run`` of the generated store as decoded rows."""
        import re
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        from mplan2vdl_tpu_torch.engine import datagen, tblingest

        t_phase = time.perf_counter()
        self.torch.cuda.empty_cache()  # the children share the card
        seed = str(self.args.seed)
        with tempfile.TemporaryDirectory(prefix="m2v_cli_") as tmp:
            meta, plan_dir = (os.path.join(tmp, "meta"),
                              os.path.join(tmp, "plans"))
            plans.write_metadata(self.st, meta)
            os.makedirs(plan_dir)
            path = {}
            for name, text in plans.CLI_PLANS.items():
                path[name] = os.path.join(plan_dir, f"{name}.mplan")
                with open(path[name], "w") as f:
                    f.write(text)
            out = self.cli(["genplans", meta, plan_dir], 600).stdout
            n = len(plans.CLI_PLANS)
            total = f"SUCCESS/TOTAL: {n}/{n}"
            print(json.dumps({"genplans": out.strip().splitlines()[-1]}),
                  flush=True)
            if total not in out:
                raise AssertionError(f"genplans: {out}")
            flags = ["-b", os.path.join(meta, "bounds.csv"),
                     "-t", os.path.join(meta, "storage.csv"),
                     "-s", os.path.join(meta, "schema.msqldump"),
                     "--dictionary", os.path.join(meta, "dictionary.csv")]
            kinds = {"vdl": ["compile"], "dot": ["compile", "--dot"],
                     "explain": ["explain"]}
            with ThreadPoolExecutor(8) as pool:
                futs = {(name, kind): pool.submit(
                    self.cli, [cmd[0], path[name], *flags, *cmd[1:]], 600)
                    for name in plans.CLI_PLANS for kind, cmd in kinds.items()}
                done = {k: f.result().stdout for k, f in futs.items()}
            for name in plans.CLI_PLANS:
                vdl = done[(name, "vdl")].strip().splitlines()
                if ("MaterializeCompact" not in vdl[-1]
                        or not done[(name, "dot")].startswith("digraph")
                        or "-- output 0:" not in done[(name, "explain")]):
                    raise AssertionError(f"{name}: compile, --dot or "
                                         "explain printed no program")
                print(json.dumps({
                    "cli_compile": name, "statements": len(vdl),
                    "dot_lines": done[(name, "dot")].count("\n"),
                    "explain_lines": done[(name, "explain")].count("\n")}),
                    flush=True)

            # Q5 on the card, with the roofline and a profile of the call
            prof = os.path.join(tmp, "q5_profile")
            p = self.cli(["run", path["q5"], "--sf", f"{self.args.sf:g}",
                          "--seed", seed, "--roofline", "--hbm-gbps",
                          f"{HBM_BYTES_PER_S / 1e9:g}", "--profile", prof],
                         900)
            head, rows = plans.csv_rows(p.stdout)
            got = [np.array([int(r[i]) for r in rows], np.int64)
                   for i in range(len(head))]
            if head != plans.Q5_COLUMNS or not plans.same_rows(
                    got, plans.oracle_q5(self.st)):
                raise AssertionError("run Q5: rows differ from the oracle")
            roof = dict(re.findall(r"^# (\w+): (\S+)$", p.stderr, re.M))
            scan, amp = int(roof["scan_bytes"]), float(roof["amplification"])
            if not (scan > 0 and amp >= 1):
                raise AssertionError(f"run Q5 --roofline: {roof}")
            with open(os.path.join(prof, "trace.json")) as f:
                trace = f.read()
            missing = [f"m2v_{k}" for k in Q5_KERNELS
                       if f'"m2v_{k}"' not in trace or not any(
                           fn in trace for fn in KERNELS[k]["functions"])]
            if missing:
                raise AssertionError(f"run Q5 --profile: the trace lacks "
                                     f"{missing} or their kernels")
            rec = {"query": "Q5", "sf": self.args.sf, "wall_s": p.seconds,
                   "scan_bytes": scan,
                   "bytes_accessed": int(roof["bytes_accessed"]),
                   "amplification": amp,
                   "roofline_floor_s": float(roof["roofline_floor_s"]),
                   "traffic_time_s": float(roof["traffic_time_s"]),
                   "card": self.smi}
            self.records["cli_run"] = rec
            print(json.dumps({"cli_run": rec}), flush=True)

            # run --devices 2 on fewer cards than that, without --cpu: an
            # error naming the card count, and no rows
            p = subprocess.run([sys.executable, "-m", "mplan2vdl_tpu_torch",
                                "run", path["q6"], "--sf", "0.01",
                                "--devices", "2"], cwd=REPO,
                               capture_output=True, text=True, timeout=300)
            n_cards = self.torch.cuda.device_count()
            if n_cards < 2 and (p.returncode == 0 or p.stdout
                                or f"only {n_cards} device(s)"
                                not in p.stderr):
                raise AssertionError(f"run --devices 2 on {n_cards} card(s)"
                                     f": exit {p.returncode}, {p.stderr}")
            print(json.dumps({"cli_devices": 2, "cards": n_cards,
                              "exit": p.returncode,
                              "stderr": p.stderr.strip()[-200:]}), flush=True)

            # --tbl: Q1 and Q16 of an ingested store against the generated
            # one (decoded: the ingest's dictionary codes follow the sorted
            # strings, the generator's do not)
            tbl = os.path.join(tmp, "tbl")
            t0 = time.perf_counter()
            tblingest.to_tbl(datagen.generate(sf=TBL_SF, seed=self.args.seed),
                             tbl)
            to_tbl_s = time.perf_counter() - t0
            with ThreadPoolExecutor(4) as pool:
                futs = {(name, src): pool.submit(self.cli, [
                    "run", path[name], *arg, "--decode"], 900)
                    for name in ("q1", "q16") for src, arg in (
                        ("tbl", ["--tbl", tbl]),
                        ("gen", ["--sf", f"{TBL_SF:g}", "--seed", seed]))}
                runs = {k: f.result() for k, f in futs.items()}
            for name in ("q1", "q16"):
                (h, got), (wh, want) = (plans.csv_rows(runs[(name, s)].stdout)
                                        for s in ("tbl", "gen"))
                if h != wh or len(got) < 2 or sorted(got) != sorted(want):
                    raise AssertionError(f"run --tbl {name}: decoded rows "
                                         "differ from the generated store's")
                if name == "q16" and not plans.q16_sql_order(got):
                    raise AssertionError("run --tbl q16: rows out of order")
                print(json.dumps({
                    "cli_tbl": name, "sf": TBL_SF, "rows": len(got),
                    "to_tbl_s": to_tbl_s,
                    "tbl_run_s": runs[(name, "tbl")].seconds,
                    "generated_run_s": runs[(name, "gen")].seconds}),
                    flush=True)
        self.records["cli_phase_s"] = time.perf_counter() - t_phase
        print(json.dumps({"cli_phase_s": self.records["cli_phase_s"]}),
              flush=True)

    def dist_phase(self, coordinator=None, phases=("dist",)):
        """Phase 7 (``"dist"`` in ``phases``): the distribution primitives
        (``parallel/``) at world size 1 over NCCL on this card, over the
        phase-3 store: DistQuery Q6 and the Q1 group-by, ShuffleGroupBy
        over ``l_orderkey``, and ShuffleJoin of ``l_orderkey`` against
        ``o_orderkey``, each exact against its oracle, then timed (median
        of 5 warm calls).  Then phase 8 (``"auto"``, ``auto_phase``) in the
        same world.  The one rank meets itself at ``coordinator`` (default:
        a free localhost port)."""
        import socket

        import torch.distributed as tdist

        from mplan2vdl_tpu_torch.parallel import multihost

        dev = self.dev
        counters = kernel_counters()
        reset_launches(counters)
        t_phase = time.perf_counter()
        # one rank on this machine: NCCL's bootstrap over the loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if coordinator is None:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                coordinator = f"localhost:{sock.getsockname()[1]}"
        multihost.initialize(coordinator, 1, 0, device=dev)
        try:
            mesh = multihost.data_mesh(device=dev)
            if "dist" in phases:
                self.primitives(mesh, counters, t_phase)
            if "auto" in phases:
                self.auto_phase(mesh)
        finally:
            tdist.destroy_process_group()

    def primitives(self, mesh, counters, t_phase):
        """Phase 7's four cells over ``mesh``; the engine kernels'
        counters (``counters``, zeroed by the caller) are read after
        them."""
        import numpy as np
        import torch.distributed as tdist

        from mplan2vdl_tpu_torch.parallel import dist
        from mplan2vdl_tpu_torch.parallel.shuffle_agg import (
            _SENT, ShuffleGroupBy, shard_shuffle_combine)
        from mplan2vdl_tpu_torch.parallel.shuffle_join import ShuffleJoin

        torch, st, dev = self.torch, self.st, self.dev
        backend = str(tdist.get_backend(mesh.group))

        def cell(name, call, check, caps, nbytes, step=None):
            self.sync()
            t0 = time.perf_counter()
            res = call()
            self.sync()
            cold = (time.perf_counter() - t0) * 1e3
            check(res)
            del res

            torch.cuda.reset_peak_memory_stats()
            times = self.warm_ms(call, 5)
            rec = {"dist": name, "world_size": mesh.size,
                   "backend": backend, "device": str(mesh.device),
                   "sf": self.args.sf,
                   "median_ms": statistics.median(times), "ms": times,
                   "cold_ms": cold, "bound_ms": _bound_ms(nbytes),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   **caps(), "card": self.smi}
            if step is not None:  # device work alone, no host gather
                rec["step_ms"] = self.warm_ms(step, 5)
                rec["step_median_ms"] = statistics.median(rec["step_ms"])
            self.records["dist"].append(rec)
            print(json.dumps(rec), flush=True)

        line = {c: st.columns[("lineitem", c)] for c in set(
            plans.DIST_Q6_COLUMNS + plans.DIST_Q1_COLUMNS + ["l_orderkey"])}
        n = len(line["l_orderkey"])

        # -- DistQuery: Q6, and the Q1 group-by
        def check_q6(res):
            want = self.tpch_want("q6")
            assert res["revenue"].tolist() == want["revenue"].tolist(), (
                res, want)

        def check_q1(res):
            nls = int(line["l_linestatus"].max()) + 1
            got = sorted(zip((res["__group_id"] // nls).tolist(),
                             (res["__group_id"] % nls).tolist(),
                             res["sum_qty"].tolist(),
                             res["sum_base_price"].tolist(),
                             res["__count"].tolist()))
            want = self.tpch_want("q1")
            exp = sorted(zip(*[np.asarray(want[k]).tolist() for k in (
                "l_returnflag", "l_linestatus", "sum_qty",
                "sum_base_price", "count_order")]))
            assert got == exp, (got, exp)

        for name, cols, spec_of, check in (
                ("DistQuery Q6", plans.DIST_Q6_COLUMNS,
                 lambda c: plans.dist_q6_query(), check_q6),
                ("DistQuery Q1 group-by", plans.DIST_Q1_COLUMNS,
                 plans.dist_q1_query, check_q1)):
            sub = {c: line[c] for c in cols}
            t0 = time.perf_counter()
            table = dist.ShardedTable.put(mesh, sub)
            self.sync()
            load_ms = (time.perf_counter() - t0) * 1e3
            q = dist.DistQuery(table=table, **spec_of(sub))
            cell(name, q, check,
                 lambda: {"domain": q.domain, "shard_rows":
                          table.shard_rows, "load_ms": load_ms},
                 sum(line[c].nbytes for c in cols))
            del q, table

        # -- ShuffleGroupBy over l_orderkey, l_shipdate >= 1995-01-01
        want = self.oracle(plans.oracle_shuffle_groupby, st)
        sparse = self.oracle(plans.oracle_sparse_groupby, st)
        for g, w in zip(want[:5], sparse, strict=True):
            assert np.array_equal(g, w), "oracles disagree"

        def i64(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        ship = self.col("l_shipdate")
        live = ship >= plans._day(1995, 1, 1)
        keys = torch.where(live, i64(line["l_orderkey"]), _SENT)
        qty, price = i64(line["l_quantity"]), self.col("l_extendedprice")
        price = price.to(torch.int64)
        vals = [qty, ship.to(torch.int64), qty,
                torch.ones(n, dtype=torch.int64, device=dev),
                price, price, price]
        ops = ["sum", "min", "max", "sum", "sum", "min", "max"]
        key_hi = int(line["l_orderkey"].max()) + 1
        gb = ShuffleGroupBy(mesh=mesh, shard_rows=n, key_hi=key_hi,
                            ops=ops)

        def check_gb(res):
            gk, gv = res
            got = [gk] + gv
            assert len(got) == len(want)
            for i, (g, w) in enumerate(zip(got, want)):
                assert np.array_equal(np.asarray(g, np.int64),
                                      np.asarray(w, np.int64)), \
                    f"ShuffleGroupBy column {i} differs"

        cell("ShuffleGroupBy", lambda: gb(keys, vals), check_gb,
             lambda: {"cap": gb.cap, "groups": len(want[0]),
                      "shard_rows": n},
             (1 + len(vals)) * n * 8 + len(want[0]) * 8 * len(want),
             step=lambda: shard_shuffle_combine(
                 keys, vals, ops, n, mesh.size, gb.per_owner, gb.cap,
                 mesh))
        del keys, vals, qty, price, ship, live

        # -- ShuffleJoin: every lineitem row against the orders keys
        okey = st.columns[("orders", "o_orderkey")]
        row, found = self.oracle(plans._pk_lookup, okey, line["l_orderkey"])
        assert found.all()
        lk = self.col("l_orderkey")
        rk = torch.from_numpy(np.ascontiguousarray(okey)).to(dev)
        rpos = torch.arange(len(okey), dtype=torch.int64, device=dev)
        sj = ShuffleJoin(mesh=mesh, shard_rows_l=n,
                         shard_rows_r=len(okey),
                         key_bounds=(0, int(okey.max()) + 1))

        def check_join(res):
            lidx, ok, cnt, (pay,) = res
            assert (cnt == 1).all(), "a lineitem row without one match"
            li, pj = lidx[ok], pay[ok]
            assert len(li) == n and (np.bincount(li, minlength=n)
                                     == 1).all(), "pairs differ"
            by_row = np.empty(n, np.int64)
            by_row[li] = pj
            assert np.array_equal(by_row, row), "payloads differ"

        cell("ShuffleJoin", lambda: sj(lk, rk, [rpos]), check_join,
             lambda: {"caps": list(sj._caps),
                      "cap_scale": sj.cap_scale,
                      "heavy_keys": (len(sj._heavy_plan[0])
                                     if sj._heavy_plan else 0),
                      "probe_rows": n, "build_rows": len(okey)},
             lk.numel() * 4 + rk.numel() * 4 + rpos.numel() * 8
             + n * (8 + 8 + 1 + 8),
             step=lambda: sj._build()(lk, rk, [rpos]))
        del lk, rk, rpos, sj
        launches = read_launches(counters)
        self.records["dist_phase_s"] = time.perf_counter() - t_phase
        print(json.dumps({"dist_phase_s": self.records["dist_phase_s"],
                          "dist_launches": launches}), flush=True)

    def auto_phase(self, mesh):
        """Phase 8: the plan distributor (``parallel/auto.py``) over
        ``mesh`` on the phase-3 store: each of ``AUTO_PLANS`` through
        ``auto.distribute`` (its set-up timed: the partitioned joins'
        counting rounds), one cold call checked row-exact against the
        plan's oracle (``plan_checks``), then 3 warm calls; one ``{"auto":
        ...}`` line each with the distribution plan, the medians beside
        the plan's phase-4 single-device median, the peak GB and the
        engine kernels' launches over the calls.  The phase must launch
        the compaction and the gather kernels."""
        import types

        from mplan2vdl_tpu_torch.engine.lower import plan_to_vexps
        from mplan2vdl_tpu_torch.parallel import auto

        torch, st, cfg = self.torch, self.st, self.cfg
        counters = kernel_counters()
        checks = self.plan_checks()
        single = {}  # each plan's first phase-4 run (Q1's: the auto gate)
        for rec in self.records["queries"]:
            single.setdefault(rec["plan"], rec["median_ms"])
        total = {k: 0 for k in counters}
        t_phase = time.perf_counter()
        self.records["auto"] = []
        for name, text in plans.AUTO_PLANS.items():
            vexps = plan_to_vexps(text, cfg)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(counters)
            self.sync()
            t0 = time.perf_counter()
            rec = {"auto": name, "world_size": mesh.size,
                   "device": str(mesh.device), "sf": self.args.sf}
            try:
                dq = auto.distribute(cfg, st, vexps, mesh)
            except auto.NotDistributable as e:
                rec["not_distributable"] = str(e)
                print(json.dumps(rec), flush=True)
                self.records["auto"].append(rec)
                if str(e) != plans.EXPECTED_NOT_DISTRIBUTABLE.get(name):
                    raise AssertionError(f"{name} is not distributable: "
                                         f"{e}") from e
                continue
            if (name in plans.EXPECTED_NOT_DISTRIBUTABLE
                    and self.args.sf == plans.CARD_SF):
                raise AssertionError(
                    f"{name} distributes at SF{plans.CARD_SF:g}, but "
                    f"EXPECTED_NOT_DISTRIBUTABLE says: "
                    f"{plans.EXPECTED_NOT_DISTRIBUTABLE[name]}")
            self.sync()
            rec["setup_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            res = dq.result()
            self.sync()
            rec["cold_ms"] = (time.perf_counter() - t0) * 1e3
            checks[name](res)
            rows_out = len(res.columns[0]) if res.columns else 0
            del res
            times = self.warm_ms(dq, 3)
            launches = read_launches(counters)
            for k in total:
                total[k] += launches[k]
            rec.update(
                describe=dq.describe().splitlines(), rows_out=rows_out,
                part_joins=part_joins(dq), warm_ms=times,
                median_ms=statistics.median(times),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches, card=self.smi)
            self.check_auto_path(name, rec)
            if name in plans.CLI_PLANS:
                rec["single_device_median_ms"] = single.get(name)
            else:  # no phase-4 run: the single-device engine here, checked
                rec["single_device_median_ms"] = self.single_device_ms(
                    vexps, checks[name])
            if self.args.profile:  # one more warm call, traced
                rec["profile"] = self.profile(f"auto {name}",
                                              types.SimpleNamespace(run=dq))
            print(json.dumps(rec), flush=True)
            self.records["auto"].append(rec)
            del dq
        idle = [k for k in ("compact", "gather") if total[k] == 0]
        if idle:
            raise AssertionError(f"the distributed plans launched no "
                                 f"{idle} kernel")
        self.records["auto_phase_s"] = time.perf_counter() - t_phase
        print(json.dumps({"auto_phase_s": self.records["auto_phase_s"],
                          "auto_launches": total}), flush=True)

    def check_auto_path(self, name, rec):
        """A plan of ``AUTO_PATHS`` must run a partitioned shuffle join
        whose ``describe()`` line names its right frame as the map says;
        the hot join's must have both heavy keys and light keys (keys
        with pairs that stay in the exchange), which ``rec`` gets."""
        if name not in plans.AUTO_PATHS:
            return
        lines = [ln for ln in rec["describe"]
                 if ln.startswith("partitioned shuffle join ")]
        if not any(plans.AUTO_PATHS[name] in ln for ln in lines):
            raise AssertionError(f"{name}: no partitioned shuffle join with "
                                 f"{plans.AUTO_PATHS[name]}: "
                                 f"{rec['describe']}")
        if name != "hot_join":
            return
        (pj,) = rec["part_joins"]
        sides = plans.hot_join_sides(self.st)
        paired = sides["keys"][(sides["lc"].sum(0) * sides["rc"]) > 0]
        pj["light_keys"] = [int(k) for k in paired
                            if k not in pj["heavy_keys"]]
        pj["oracle_pairs"] = int(sides["lc"].sum(0) @ sides["rc"])
        if not (pj["n_heavy"] > 0 and pj["light_keys"]
                and set(pj["heavy_keys"]) <= set(paired.tolist())
                and pj["pairs"] == pj["oracle_pairs"]):
            raise AssertionError(f"hot_join: {pj}, keys with pairs "
                                 f"{paired.tolist()}")

    def single_device_ms(self, vexps, check):
        """The median of 3 warm calls of the single-device engine on
        ``vexps`` over the phase-3 store, after one call held to
        ``check``."""
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery

        cq = CompiledQuery(self.cfg, vexps, self.st, device=self.dev)
        check(cq())
        return statistics.median(self.warm_ms(cq, 3))

    def census_phase(self, sf=CENSUS_SF, workers=CENSUS_WORKERS):
        """Phase 9: the JAX package's CPU plan census
        (tests/torch_census_cases.py: 40 fuzz, 40 ordered fuzz, 7
        null-semantics, 5 join-corner, 2 semi/anti and 2 count(DISTINCT)
        plans) and the plans of phase 8 (AUTO_PLANS) but CENSUS_SKIP's,
        through ``vir.vexps_from_mplan`` + ``passes.engine_passes`` +
        ``CompiledQuery`` on the card over a store of scale ``sf``, each
        result held against the port's relational oracle as rows (the
        ordered family in order), the null plans against SQLite and the
        count(DISTINCT) plans also against a numpy distinct count; the fuzz
        plans run three times: with the default gate, with
        MPLAN2VDL_FUSED_AGG=1 and with MPLAN2VDL_MXU_AGG=1 besides.  The
        oracles run once a plan, in ``workers`` spawned processes, each
        with its own copy of the store, while the card runs.  One
        ``{"census": ...}`` line per family; the engine kernels' counters
        are read around the phase, and each of them must have launched."""
        import concurrent.futures as cf
        import multiprocessing

        import numpy as np

        import mplan2vdl_tpu_torch
        from mplan2vdl_tpu_torch import passes, vir
        from mplan2vdl_tpu_torch.engine import datagen
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery

        import torch_census_cases as census

        def passes_of(family):
            return FUZZ_PASSES if family == "fuzz" else ((family, None, None),)

        counters = kernel_counters()
        t_phase = time.perf_counter()
        st = datagen.generate(sf=sf, seed=self.args.seed)
        cfg = st.make_catalog()
        n_li = st.table_count(("lineitem",))
        datagen_s = time.perf_counter() - t_phase
        cases = census.case_names()
        # the oracle of every plan the port's oracle checks, computed once
        pool = cf.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=census.oracle_worker_init,
            initargs=(sf, self.args.seed))
        futures = {c: pool.submit(census.oracle_columns, *c)
                   for c in cases if c[0] != "null"}
        tp = np.asarray(st.columns[("orders", "o_totalprice")])
        from mplan2vdl_tpu_torch.engine.kernels import exprfold as kx

        def held(line, name):
            """``engine_seam``'s wrapper holding each group-id pass of plan
            ``name`` in pass ``line`` to the plain version."""
            def ids(fn, *a):
                got = fn(*a)
                self.equal(f"group_ids census {line} {name}", got,
                           kx.group_ids_plain(*a))
                return got
            return {"group_ids": ids}

        reset_launches(counters)
        try:
            # every run on the card first: (family line, name) -> columns
            got, joins, stats = {}, {}, {}
            for family, name in cases:
                plan = census.build(mplan2vdl_tpu_torch, family, name, st,
                                    cfg)
                for line, fused, mxu in passes_of(family):
                    rec = stats.setdefault(line, {
                        "plans": 0, "rows_out": 0, "engine_s": 0.0,
                        "launches": {k: 0 for k in counters}})
                    before = read_launches(counters)
                    t0 = time.perf_counter()
                    with engine_seam(env={"MPLAN2VDL_FUSED_AGG": fused,
                                          "MPLAN2VDL_MXU_AGG": mxu},
                                     wrap=held(line, name)):
                        cq = CompiledQuery(cfg, passes.engine_passes(
                            vir.vexps_from_mplan(plan, cfg)), st,
                            device=self.dev)
                        res = cq()
                    rec["engine_s"] += time.perf_counter() - t0
                    for k, n in read_launches(counters).items():
                        rec["launches"][k] += n - before[k]
                    rec["plans"] += 1
                    rec["rows_out"] += (len(res.columns[0])
                                        if res.columns else 0)
                    got[line, name] = census.int_columns(res.columns)
                    joins[line, name] = {j["side"] for j in cq.join_log}
                    del cq
            launched = read_launches(counters)
            # then every check: the oracle's rows (in order for the ordered
            # family), SQLite's for the null plans
            db = None
            for family, name in cases:
                t0 = time.perf_counter()
                if family == "null":
                    if db is None:
                        db = census.null_db(st)
                    ref = census.sql_rows(db, census.null_sql(name, tp))
                    oracle_s = time.perf_counter() - t0
                else:
                    cols, oracle_s = futures[family, name].result()
                for line, _, _ in passes_of(family):
                    rec = stats[line]
                    rec["oracle_s"] = rec.get("oracle_s", 0.0) + (
                        oracle_s if line == family else 0.0)
                    g = got[line, name]
                    if family == "null":
                        ok = census.rows(g) == ref
                    elif family == "ordered":
                        ok = len(g) == len(cols) and all(
                            np.array_equal(a, b) for a, b in zip(g, cols))
                    else:
                        ok = census.rows(g) == census.rows(cols)
                    if ok and family == "distinct":
                        key = census.DISTINCT[name][1]
                        ok = dict(zip(g[0].tolist(), g[1].tolist())) == \
                            census.numpy_distinct(st, key, "l_suppkey")
                    if ok and family == "corners":
                        ok = joins[line, name] == census.CORNERS[name]
                    if not ok:
                        raise AssertionError(
                            f"census {line} {name}: the card's rows differ "
                            f"from the {CENSUS_REFERENCE[family]}")
                    rec["checked"] = rec.get("checked", 0) + 1
        finally:
            pool.shutdown(cancel_futures=True)
        wall = time.perf_counter() - t_phase
        for line, rec in stats.items():
            family = line.split("_")[0] if line.startswith("fuzz") else line
            out = {"census": line, **rec,
                   "reference": CENSUS_REFERENCE[family], "sf": sf,
                   "lineitem_rows": n_li, "cut": CENSUS_CUT,
                   "card": self.smi}
            self.records.setdefault("census", []).append(out)
            print(json.dumps(out), flush=True)
        idle = [k for k, v in launched.items() if v == 0]
        end = {"census_phase_s": wall, "datagen_s": datagen_s,
               "oracle_workers": workers, "census_launches": launched,
               "plans": len(cases),
               "runs": sum(r["plans"] for r in stats.values())}
        self.records["census_phase"] = end
        print(json.dumps(end), flush=True)
        if idle:
            raise AssertionError(f"the census launched no {idle} kernel")

    def profile(self, name, cq, gather_calls=None):
        """One warm call under torch.profiler: device (kernel) time beside
        the host wall time, and the ops that own the most device time.
        The engine kernels' launch counters and launch ranges (``m2v_*``)
        are read around the same call, and a launch the profiler holds no
        kernel record of is printed as a ``profile_lost`` line.  Given
        ``gather_calls``, [(index, class)] of the first run's gather.cu
        calls, the i-th call runs in a range named after the index of
        ``gather_calls[i]`` and must have that class's shape, the warm call
        must make as many, and each class's device time is returned."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        from mplan2vdl_tpu_torch.engine.kernels import _lib

        counters = kernel_counters()
        reset_launches(counters)
        tagged, call = [], _lib.call

        def named(gather_many, srcs, pos, valid, small=False):
            if small:
                return gather_many(srcs, pos, valid, small=small)
            i = len(tagged)
            if i >= len(gather_calls) or gather_calls[i][1][:5] != \
                    gather_shape(srcs, pos):
                raise AssertionError(
                    f"{name}: the profiled call's gather {i} "
                    f"{gather_shape(srcs, pos)} is not the first run's")
            tagged.append(i)
            tag = f"gather_class {gather_calls[i][0]}"

            def in_range(entry, *a):  # the launch's range, named by class
                with record_function(tag):
                    return getattr(_lib.lib(), entry)(*a)
            _lib.call = in_range
            try:
                return gather_many(srcs, pos, valid, small=small)
            finally:
                _lib.call = call

        act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        wrap = {"gather_many": named} if gather_calls is not None else None
        with engine_seam(wrap=wrap), profile(activities=act) as prof:
            (wall,) = self.warm_ms(cq.run, 1)
        if gather_calls is not None and len(tagged) != len(gather_calls):
            raise AssertionError(f"{name}: the profiled call made "
                                 f"{len(tagged)} gathers, the first run "
                                 f"{len(gather_calls)}")
        avg = prof.key_averages()

        # kernels are the CUDA-type entries other than the device-side
        # spans of the launch ranges (m2v_*, gather_class *), which repeat
        # their kernels' time; the CPU-side ops that launched them carry
        # the same device time, so they name the top spenders
        def span(e):
            return getattr(e, "is_user_annotation", False) or e.key.startswith(
                ("m2v_", "gather_class "))

        cuda = [e for e in avg
                if e.device_type == DeviceType.CUDA and not span(e)]
        spans = [e for e in avg
                 if e.device_type == DeviceType.CUDA and span(e)]
        device = sum(_dev_us(e) for e in cuda) / 1e3
        ops = [e for e in avg if e.device_type == DeviceType.CPU]
        top = sorted(ops, key=_dev_us, reverse=True)[:8]
        # the engine kernels' own entries: [launches, device ms]
        kernels = {}
        for e in cuda:
            k = _engine_kernel(e.key)
            if k is not None:
                c, t = kernels.get(k, (0, 0.0))
                kernels[k] = (c + e.count, t + _dev_us(e) / 1e3)
        launched = {k: n for k, n in read_launches(counters).items() if n}
        ranges = {e.key: e.count for e in ops if e.key.startswith("m2v_")}
        # each census class's launches: [count, device ms of the range's
        # device-side span]
        per_class = {int(e.key.split()[1]): (e.count, _dev_us(e) / 1e3)
                     for e in spans if e.key.startswith("gather_class ")}
        lost = {k: n - kernels.get(k, (0, 0.0))[0]
                for k, n in launched.items()
                if kernels.get(k, (0, 0.0))[0] < n}
        if lost:
            print(json.dumps({"profile_lost": name, "lost": lost,
                              "launched": launched, "ranges": ranges}),
                  flush=True)
        os.makedirs(self.args.profile, exist_ok=True)
        stem = "".join(c if c.isalnum() else "_" for c in name)
        with open(os.path.join(self.args.profile, stem + ".txt"), "w") as f:
            f.write(avg.table(sort_by="self_device_time_total", row_limit=-1,
                              max_name_column_width=100))
        return {"wall_ms": wall, "device_ms": device,
                "busy_share": device / wall,
                "kernels": {k: list(v) for k, v in kernels.items()},
                "launched": launched, "ranges": ranges, "lost": lost,
                "gather_classes": per_class,
                "top": [[e.key, e.count, _dev_us(e) / 1e3] for e in top]}

    def summary(self):
        out = []
        checks = self.records["kernel_checks"]
        launches = {**self.launches, **self.probe_launches}
        # what sets a kernel's bound: its bytes, or for the probes, when
        # their launches take longer, the operations (launches at the empty
        # kernel's rate)
        pb = self.probe_bound
        ops = pb["launches_ms"] > pb["bytes_ms"]
        for name, meta in KERNELS.items():
            t = self.timed[name]
            out.append({"name": name, "route": "cuda",
                        "source": KERNEL_SOURCE.format(
                            meta.get("source", name)),
                        "replaces": meta["replaces"],
                        "launches": launches[name],
                        "max_abs_err": max(
                            (c["max_abs_err"] for c in checks
                             if c["check"].split()[0] == name), default=0),
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"],
                        "bound_by": ("operations" if name == "probes"
                                     and ops else "bytes"),
                        "library_ms": t["library_ms"]})
        return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=plans.CARD_SF,
                    help="TPC-H scale factor of the generated store")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None,
                    help="also write every record as JSON to this file")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="profile one warm call of each query (phase 4) "
                         "and distributed plan (phase 8) with "
                         "torch.profiler; tables go to DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mplan2vdl_tpu_torch  # noqa: F401  (fails outside the repo)

    t0 = time.perf_counter()
    s = Smoke(args)
    s.records["phase_s"] = {}
    for name, phase in (("card", s.card), ("build", s.build),
                        ("store", s.store), ("kernels", s.kernel_phase),
                        ("queries", s.query_phase), ("probes", s.probe_phase),
                        ("cli", s.cli_phase),
                        ("dist and auto", lambda: s.dist_phase(
                            phases=("dist", "auto"))),
                        ("census", s.census_phase)):
        t = time.perf_counter()
        phase()
        s.records["phase_s"][name] = time.perf_counter() - t
        print(json.dumps({"phase_s": name, "s": s.records["phase_s"][name]}),
              flush=True)
    summary = s.summary()
    s.records["summary"] = summary
    s.records["wall_s"] = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(s.records, f, indent=1)
    print(json.dumps({"wall_s": s.records["wall_s"]}), flush=True)
    print(json.dumps(summary), flush=True)
    # the run uses one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
