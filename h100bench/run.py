"""Runs one cell of the benchmark of mplan2vdl_tpu_torch on this machine.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix.  A
run makes the configuration's TPC-H tables on the card from the seed,
hands them to the engine (a ``ColumnStore``, its catalog, one prepared
``CompiledQuery`` per query of the mix), uploads the columns and warms up
each query: that is set-up.  Then one stream sends the mix's queries back
to back, each call waiting for its rows on the host, for ``--seconds``
(whole cycles of the mix).  Once the window has closed, the tables are made
again from the seed, a sample of the returned rows drawn from the seed is
compared with the plain references, and the last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``, and a
``breakdown``) and ``checks``, each compared number with its limit.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs the
window under torch.profiler for at most the mix's ``trace_cycles`` cycles
and reports its per-layer metrics.  Without a CUDA device, or with fewer
than the cell asks for, the run prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # the checkout's root, not this folder
    sys.path[0] = ROOT

import torch  # noqa: E402

from h100bench import cells, check, gen, spans, sut  # noqa: E402

# top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "mplan2vdl_tpu")


@dataclass
class Run:
    """What a window gave, as the metric readers see it."""

    attempted: int
    failed: int
    window_s: float
    latencies_s: List[float]
    host_syncs: int
    peak_bytes: int
    setup_s: float
    hbm_bytes_per_s: Optional[float]
    trace: Optional[spans.Trace] = None
    per_query: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def n(self) -> int:
        """Queries completed: their rows reached the host."""
        return self.attempted - self.failed


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def closed_loop(cqs, order, seconds: float, rng: random.Random, keep: int,
                max_cycles: Optional[int] = None, traced: bool = False):
    """One stream: each query of ``order`` in turn, the next sent when the
    last one's rows are on the host, in whole cycles until ``seconds`` have
    passed (or ``max_cycles``).  Returns (calls, window seconds, host
    syncs, kept results): each call as (query, seconds, failed), and per
    query up to ``keep`` results drawn by ``rng`` plus its last."""
    from torch.profiler import record_function

    calls, syncs = [], 0
    sample = {q: [] for q in cqs}
    seen = {q: 0 for q in cqs}
    last = {}
    cycles = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        for q in order:
            span = (record_function(spans.QUERY_SPAN + q) if traced
                    else contextlib.nullcontext())
            t0 = time.perf_counter()
            try:
                with span:
                    res = cqs[q]()
            except Exception as e:  # a failed query counts, the loop goes on
                print(json.dumps({"query_failed": q, "error": repr(e)}),
                      file=sys.stderr, flush=True)
                res = None
            calls.append((q, time.perf_counter() - t0, res is None))
            if res is None:
                continue
            syncs += cqs[q].host_syncs
            seen[q] += 1
            if len(sample[q]) < keep:
                sample[q].append(res)
            else:
                j = rng.randrange(seen[q])
                if j < keep:
                    sample[q][j] = res
            last[q] = res
        cycles += 1
        if time.perf_counter() >= deadline or cycles == max_cycles:
            break
    window = time.perf_counter() - start
    kept = {q: sample[q] + ([last[q]] if q in last else []) for q in cqs}
    return calls, window, syncs, kept


def hbm_rate(device) -> Optional[float]:
    if device.type != "cuda":
        return None
    peak = cells.peaks().get(torch.cuda.get_device_name(device))
    return peak["hbm_bytes_per_s"] if peak else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", sf: Optional[float] = None,
             bench: Optional[dict] = None):
    """One run of cell ``name``: (result line as a dict, compared numbers,
    set-up parts).  ``sf`` overrides the configuration's scale factor and
    ``bench`` the manifest (the CPU tests run the harness at a tiny size,
    and over the mixes and configurations that no cell uses yet)."""
    from mplan2vdl_tpu_torch.engine import lower

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    c = cells.cell(name, bench)
    sf = c.config["scale_factor"] if sf is None else sf
    mix = c.mix

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    parts: Dict[str, float] = {}
    t = time.perf_counter()
    tables = gen.generate(sf, seed, dev)
    sync()
    parts["tables_s"] = time.perf_counter() - t
    store, cqs = sut.prepare(tables, c, dev, parts)
    del tables  # the reference makes them again after the window
    t = time.perf_counter()
    for cq in cqs.values():
        cq.device_args()
    sync()
    parts["upload_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(mix["warmup_calls"]):
        for q in mix["order"]:
            cqs[q]()
    sync()
    parts["warmup_s"] = time.perf_counter() - t
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    rng = random.Random(seed)
    gc.freeze()  # no collection pauses inside the window
    gc.disable()
    setup_s = time.perf_counter() - T0

    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        before = spans.launch_counts()
        with profile(activities=acts) as prof:
            with spans.KernelLayer(lower) as layer:
                with record_function(spans.WINDOW_SPAN):
                    calls, window_s, syncs, kept = closed_loop(
                        cqs, mix["order"], seconds, rng,
                        mix["results_kept"], mix["trace_cycles"], True)
        tr = spans.reduce_trace(prof, layer, window_s)
        print(json.dumps({"trace": {
            "layer_calls": tr.layer_calls, "layer_s": tr.layer_s,
            "engine_kernels_s": tr.engine_kernels_s,
            "kernels_s": tr.kernels_s, "copies_s": tr.copies_s,
            "unlinked": tr.unlinked, "own_s": tr.own_s}}),
              file=sys.stderr, flush=True)
        launched = {k: v - before[k] for k, v in spans.launch_counts().items()}
        lost = {k: n - tr.records.get(k, 0) for k, n in launched.items()
                if tr.records.get(k, 0) < n}
        if cuda and lost:
            print(json.dumps({"profile_lost": lost, "launched": launched}),
                  file=sys.stderr, flush=True)
        del prof
    else:
        calls, window_s, syncs, kept = closed_loop(
            cqs, mix["order"], seconds, rng, mix["results_kept"])
    gc.enable()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    run = Run(attempted=len(calls), failed=sum(f for _, _, f in calls),
              window_s=window_s,
              latencies_s=[s for _, s, f in calls if not f],
              host_syncs=syncs, peak_bytes=peak, setup_s=setup_s,
              hbm_bytes_per_s=hbm_rate(dev), trace=tr)
    for q, s, f in calls:
        if not f:
            run.per_query.setdefault(q, []).append(s)

    # the program's state goes before the reference runs
    del cqs, store
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.compare(kept, gen.generate(sf, seed, dev), c)
    parts["check_s"] = time.perf_counter() - t
    del kept

    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = cells.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": run.failed == 0 and check.passed(numbers),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {
            "device_ops": [list(x) for x in tr.device_ops],
            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in numbers.items()}
    parts["per_query_median_ms"] = {
        q: sorted(v)[len(v) // 2] * 1e3 for q, v in run.per_query.items()}
    return result, numbers, parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    need = cells.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: the cell needs {need} CUDA device(s), "
              f"{have} available", file=sys.stderr)
        return 2
    result, numbers, parts = run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace))
    print(json.dumps({"setup": parts}), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"h100bench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in numbers.items():
        print(f"check {k} {v['value']} limit {v['limit']} "
              f"(results {v['results']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
