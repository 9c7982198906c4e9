"""The traced run: spans around the engine's calls into its kernel layer,
their bytes, and the reduction of a torch.profiler trace to the numbers
the per-layer metrics read.

The engine calls its kernel layer by five names in ``engine/lower.py``.
``KernelLayer`` replaces each by a wrapper that opens a ``record_function``
range ``h100bench.kernel.<name>`` and counts the call's bytes by the
formulas below (each input read once, each output written once), so a
later change that reimplements a call is read the same way.  Counts that
sit on the device (a gather's valid rows, a scatter's rows in range) are
kept as 0-d tensors and read once the window has closed; the small
reductions that make them run in a range of their own,
``h100bench.count``, whose device work and host time the reduction leaves
out of the program's.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

LAYER_CALLS = ("compact_positions", "gather_many", "monotone_scatter",
               "fused_group_aggregate", "fused_group_aggregate_mxu")
KERNEL_SPAN = "h100bench.kernel."
COUNT_SPAN = "h100bench.count"
QUERY_SPAN = "h100bench.query."
WINDOW_SPAN = "h100bench.window"

# the engine's CUDA functions as the profiler names them, and the launch
# counters of their wrappers (module, attribute)
KERNEL_FUNCTIONS = {"compact": ("compact_kernel",),
                    "gather": ("gather_kernel",),
                    "small_gather": ("small_gather_kernel",),
                    "scatter": ("scatter_kernel",),
                    "multiagg": ("lane_kernel", "shared_kernel"),
                    "multiagg_mxu": ("mxu_kernel", "fast_kernel")}
COUNTERS = {"compact": ("compact", "launches"),
            "gather": ("sorted_gather", "launches"),
            "small_gather": ("sorted_gather", "small_launches"),
            "scatter": ("scatter", "launches"),
            "multiagg": ("multiagg", "launches"),
            "multiagg_mxu": ("multiagg_mxu", "launches")}


def _spec_columns(specs) -> int:
    used = set()
    for s in specs:
        if s.base is not None:
            used.add(s.base)
        used.update(f[2] for f in s.factors)
    return len(used)


def call_bytes(name: str, args, kwargs, out):
    """(bytes known now, [(0-d count tensor, bytes per count)]) of one
    call into the kernel layer."""
    a = list(args) + list(kwargs.values())
    if name == "compact_positions":
        mask = a[0]
        return mask.numel() * mask.element_size() + out.numel() * 4, []
    if name == "gather_many":
        srcs, pos, valid = a[0], a[1], a[2]
        small = kwargs.get("small", a[3] if len(a) > 3 else False)
        m, n = pos.shape[0], srcs[0].shape[0]
        per_row = pos.element_size() + sum(s.element_size() for s in srcs)
        writes = m * sum(s.element_size() for s in srcs)
        if small:  # every position is read; the table has n rows
            return (writes + m * pos.element_size()
                    + min(m, n) * sum(s.element_size() for s in srcs)), []
        if isinstance(valid, torch.Tensor):
            v = valid.reshape(()).to(torch.int64).clamp(0, min(m, n))
            return writes, [(v, per_row)]
        return writes + min(max(int(valid), 0), m, n) * per_row, []
    if name == "monotone_scatter":
        pos, src, L = a[0], a[1], int(a[2])
        fixed = pos.numel() * pos.element_size() + L * src.element_size()
        inside = ((pos >= 0) & (pos < L)).sum()
        return fixed, [(inside, src.element_size())]
    if name in ("fused_group_aggregate", "fused_group_aggregate_mxu"):
        cols, gid, specs, n_groups = a[0], a[1], a[2], int(a[3])
        n = gid.shape[0]
        return (n * 4 * (_spec_columns(specs) + 1)
                + n_groups * len(specs) * 8), []
    raise KeyError(name)


class KernelLayer:
    """Wraps the engine's kernel-layer names in ``lower`` while installed;
    ``calls`` lists (name, bytes, lazy counts) in call order."""

    def __init__(self, lower):
        self.lower = lower
        self.calls: List[Tuple[str, int, list]] = []
        self._saved: Dict[str, object] = {}

    def __enter__(self):
        from torch.profiler import record_function

        for name in LAYER_CALLS:
            fn = getattr(self.lower, name)
            self._saved[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                with record_function(KERNEL_SPAN + _name):
                    out = _fn(*args, **kwargs)
                with record_function(COUNT_SPAN):
                    fixed, lazy = call_bytes(_name, args, kwargs, out)
                self.calls.append((_name, fixed, lazy))
                return out

            setattr(self.lower, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.lower, name, fn)

    def total_bytes(self) -> int:
        return sum(fixed + sum(int(t) * k for t, k in lazy)
                   for _, fixed, lazy in self.calls)


def launch_counts() -> Dict[str, int]:
    """The engine kernels' launch counters, by kernel."""
    import importlib

    out = {}
    for k, (mod, attr) in COUNTERS.items():
        m = importlib.import_module(
            f"mplan2vdl_tpu_torch.engine.kernels.{mod}")
        out[k] = getattr(m, attr)
    return out


def engine_kernel(name: str) -> Optional[str]:
    """The engine kernel whose CUDA function a device event names."""
    for k, fns in KERNEL_FUNCTIONS.items():
        if any(re.search(rf"(?<![A-Za-z0-9_]){f}\b", name) for f in fns):
            return k
    return None


@dataclass
class Trace:
    """What one traced window holds, in seconds."""

    window_s: float
    busy_s: float  # union of device activity (kernels, copies, memsets)
    kernels_s: float  # device kernels and memsets, summed
    copies_s: float
    layer_s: float  # kernels and memsets inside the kernel layer's calls
    layer_calls: int
    layer_bytes: int
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    records: Dict[str, int] = field(default_factory=dict)
    engine_kernels_s: float = 0.0  # the engine's own CUDA kernels, by name
    unlinked: int = 0  # device events with no launch found for them
    own_s: float = 0.0  # host time in the benchmark's own count ranges

    @property
    def program_s(self) -> float:
        """The window less the benchmark's own count ranges."""
        return self.window_s - self.own_s


def _kind(e) -> str:
    """``device`` (a kernel, memset or copy on the card), ``launch`` (a
    CUDA runtime or driver call), ``annotation`` (a range's device-side
    span) or ``host`` (any other host event)."""
    from torch.autograd import DeviceType

    name = e.name()
    if e.device_type() != DeviceType.CPU:
        if (getattr(e, "is_user_annotation", lambda: False)()
                or name.startswith(("h100bench.", "m2v_"))):
            return "annotation"
        return "device"
    if name.startswith(("cuda", "cu")) and e.correlation_id() > 0:
        return "launch"
    return "host"


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _inside(t: int, spans_, starts) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and spans_[i][1] >= t


def reduce_trace(prof, layer: KernelLayer, window_s: float) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` over one window (its
    ``WINDOW_SPAN`` range) to a ``Trace``.

    Device work is attributed to the kernel layer by where it was
    launched: each kernel, copy or memset carries the CUPTI correlation id
    of the runtime call that launched it, and that call's host time lies
    inside one of the layer's spans or not.  Device work launched inside a
    ``COUNT_SPAN`` is the benchmark's own and is left out."""
    raw = prof.profiler.kineto_results.events()
    kind = [_kind(e) for e in raw]
    win = next(e for e in raw if e.name() == WINDOW_SPAN)
    w0, w1, main = win.start_ns(), win.end_ns(), win.start_thread_id()
    launch = {e.correlation_id(): e.start_ns()
              for e, k in zip(raw, kind) if k == "launch"}

    def host_spans(prefix):
        return sorted((e.start_ns(), e.end_ns()) for e, k in zip(raw, kind)
                      if k == "host" and e.name().startswith(prefix))

    calls, counts = host_spans(KERNEL_SPAN), host_spans(COUNT_SPAN)
    starts, count_starts = [c[0] for c in calls], [c[0] for c in counts]
    busy_iv, ops, records = [], {}, {}
    kernels_ns = copies_ns = layer_ns = engine_ns = 0
    unlinked = 0
    for e, k in zip(raw, kind):
        if k != "device":
            continue
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        at = launch.get(e.correlation_id())
        if at is not None and _inside(at, counts, count_starts):
            continue
        busy_iv.append((max(s, w0), min(t, w1)))
        d = t - s
        name = e.name()
        ops[name[:120]] = ops.get(name[:120], 0.0) + d / 1e9
        ek = engine_kernel(name)
        if ek is not None:
            records[ek] = records.get(ek, 0) + 1
            engine_ns += d
        if name.startswith("Memcpy"):
            copies_ns += d
            continue
        kernels_ns += d
        if at is None:
            unlinked += 1
        elif _inside(at, calls, starts):
            layer_ns += d
    busy = _union(busy_iv)
    return Trace(
        window_s=window_s, busy_s=sum(e - s for s, e in busy) / 1e9,
        kernels_s=kernels_ns / 1e9, copies_s=copies_ns / 1e9,
        layer_s=layer_ns / 1e9, layer_calls=len(calls),
        layer_bytes=layer.total_bytes(),
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=_idle_gaps(raw, kind, main, busy, w0, w1),
        records=records, engine_kernels_s=engine_ns / 1e9,
        unlinked=unlinked,
        own_s=sum(min(t, w1) - max(s, w0) for s, t in counts
                  if t > w0 and s < w1) / 1e9)


def _idle_gaps(raw, kind, main, busy, w0: int, w1: int, top: int = 10):
    """Idle time of the device inside the window, summed by what the host
    was doing at each gap's middle: the query span and the innermost host
    op there on the thread that ran the window."""
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [(e.start_ns(), e.end_ns(), e.name()) for e, k in zip(raw, kind)
            if k in ("host", "launch") and e.start_thread_id() == main]
    queries = sorted((s, t, n[len(QUERY_SPAN):]) for s, t, n in host
                     if n.startswith(QUERY_SPAN))
    ops = sorted(r for r in host if not r[2].startswith("h100bench."))
    starts = [r[0] for r in ops]
    qstarts = [q[0] for q in queries]
    by: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        qi = bisect.bisect_right(qstarts, mid) - 1
        q = (queries[qi][2] if qi >= 0 and queries[qi][1] >= mid
             else "between queries")
        i = bisect.bisect_right(starts, mid) - 1
        what = "python"
        for j in range(i, max(i - 400, -1), -1):
            if ops[j][1] >= mid:
                what = ops[j][2]
                break
        label = f"{q}: {what}"[:120]
        by[label] = by.get(label, 0.0) + (e - s) / 1e9
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]
