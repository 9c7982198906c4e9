"""Program spans: host ranges at the layer boundaries of the query path.

The gate is torch.profiler's own: spans are recorded only while a profiler
session records (``recording()``).  Then ``span(name)`` opens a profiler
range ``name`` on the host, so the span lies on one timeline with the
session's host and device events, and keeps a ``Span`` in memory;
``records()`` returns the kept spans and ``clear()`` drops them.  Outside a
session ``span`` returns one shared no-op context and keeps nothing.  The
range is torch's C++ ``_RecordFunctionFast``, not ``record_function``: on
the host of an H100 machine 1.0-1.9 us a range against 9.1-11.2 us, and a
query opens dozens, many of them while the device waits for the host.

Kept spans outlive their session, so a reader can take them after it ends;
at most the last ``KEEP`` are kept, the oldest dropped first.  A reader
takes the spans of the calls it asks for, by call id, and never assumes
that the store begins at its own session.

A span's times are ``time.time_ns()``, Unix-epoch nanoseconds: the clock
of the profiler's event times (``start_ns`` / ``end_ns``).  A span opened
while no span is open starts a call, and every span inside it carries that
call's id (the id of its outermost span).

The spans of one ``CompiledQuery.__call__`` (``engine/lower.py``):

- ``m2v_query``: the call;
- ``m2v_node.<kind>``: each VIR node the compiler evaluates (memo misses
  only), nested as the evaluation recurses;
- ``m2v_sync.<site>``: each blocking transfer, one for each of the call's
  ``host_syncs``: the counts read at ``select``, ``join_total`` and
  ``unmatched``, each host value copied to the device (``upload``: on the
  GPU a copy from pageable memory, which waits for the stream), and in
  ``m2v_result`` (the result transfer) ``result_valid`` and
  ``result_copy``;
- ``m2v_kernel.<name>``: each call of a kernel-layer entry function
  (``kernel``), around its launches' ``m2v_<entry>`` ranges
  (``engine/kernels/_lib.py``).

Every name starts with ``m2v_``, as the launch ranges' do, so a trace
reader can tell the program's ranges from torch's ops, and a range's
device-side annotation from device work.  ``span_table`` reduces a
finished session to one row per span name (``cli run --profile``'s
``spans.txt``).
"""

from __future__ import annotations

import bisect
import collections
import functools
import itertools
import threading
import time
from typing import Deque, Dict, List

import torch

PREFIX = "m2v_"

recording = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

# the kept spans: a traced window of a few hundred calls, of some dozens of
# spans each, fits many times over
KEEP = 1 << 17
_records: Deque["Span"] = collections.deque(maxlen=KEEP)
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One kept span; as a context, it opens and closes its range."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns",
                 "_range")

    def __init__(self, name: str):
        self.name = name
        self.id = self.parent = self.call = None  # set when opened
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = sid = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.call = top.id, top.call
        else:  # the outermost span starts a call
            self.call = sid
        self._range = _Range(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        stack.append(self)
        _records.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _local.stack.pop()
        self._range.__exit__(*exc)
        return False


class _Null:
    """The context ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """A context that records span ``name`` while the profiler records,
    else a no-op."""
    return Span(name) if recording() else _NULL


def kernel(fn):
    """``fn`` (a kernel-layer entry function) in span
    ``m2v_kernel.<its name>``."""
    name = f"{PREFIX}kernel.{fn.__name__}"

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not recording():
            return fn(*args, **kwargs)
        with Span(name):
            return fn(*args, **kwargs)

    return wrapped


def records() -> List[Span]:
    """The kept spans (at most ``KEEP``), in the order they were
    opened."""
    return list(_records)


def clear() -> None:
    _records.clear()


# ------------------------------------------------------------ the exporter
def _is_annotation(e, name: str) -> bool:
    """A range's device-side span, not device work."""
    return (getattr(e, "is_user_annotation", lambda: False)()
            or name.startswith(PREFIX))


def span_table(prof) -> str:
    """One row per program span name of a finished ``torch.profiler``
    session: calls, host ms, host self ms (less the direct child spans),
    and with device activity the device ms of the kernels, copies and
    memsets launched inside the span (the innermost span around the
    runtime call that launched them, by correlation id) and the device's
    idle ms while the span was the host's innermost span.  Device work
    launched outside every span is the row ``(no span)``; the last row
    sums each column over the program's own time (the outermost spans)."""
    from torch.autograd import DeviceType

    names = {r.name for r in _records}
    spans, launch, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        nm = e.name()
        if e.device_type() != DeviceType.CPU:
            if not _is_annotation(e, nm):
                device.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif nm in names:
            spans.append((e.start_ns(), e.end_ns(), nm))
        elif e.correlation_id() > 0 and nm.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    spans.sort(key=lambda s: (s[0], -s[1]))

    # nesting: each span's time in its direct children, the time in the
    # outermost spans, and the innermost span as a step function of time
    # (``owners[k]`` from ``marks[k]`` on; -1: no span open)
    child_ns = [0] * len(spans)
    top_ns = 0
    marks: List[int] = []
    owners: List[int] = []
    stack: List[int] = []

    def pop_until(t):
        while stack and spans[stack[-1]][1] <= t:
            j = stack.pop()
            marks.append(spans[j][1])
            owners.append(stack[-1] if stack else -1)

    for i, (s, e, _) in enumerate(spans):
        pop_until(s)
        if stack:
            child_ns[stack[-1]] += e - s
        else:
            top_ns += e - s
        stack.append(i)
        marks.append(s)
        owners.append(i)
    pop_until(float("inf"))

    rows: Dict[str, List[int]] = {}

    def row(i):
        return rows.setdefault(spans[i][2] if i >= 0 else "(no span)",
                               [0, 0, 0, 0, 0])

    for i, (s, e, _) in enumerate(spans):
        r = row(i)
        r[0] += 1
        r[1] += e - s
        r[2] += e - s - child_ns[i]
    for s, e, corr in device:
        at = launch.get(corr)
        k = bisect.bisect_right(marks, at) - 1 if at is not None else -1
        row(owners[k] if k >= 0 else -1)[3] += e - s
    if spans and device:  # idle gaps inside the program's time
        t, w1 = spans[0][0], max(e for _, e, _ in spans)
        for s, e in sorted((s, e) for s, e, _ in device) + [(w1, w1)]:
            s = min(s, w1)
            k = bisect.bisect_right(marks, t) - 1
            while t < s:  # the gap [t, s), split where the owner changes
                end = min(s, marks[k + 1]) if k + 1 < len(marks) else s
                row(owners[k] if k >= 0 else -1)[4] += end - t
                t, k = end, k + 1
            t = max(t, e)
    total = [sum(r[0] for r in rows.values()), top_ns, top_ns,
             sum(r[3] for r in rows.values()),
             sum(r[4] for r in rows.values())]
    width = max([len(n) for n in rows] + [24])
    head = (f"{'span':<{width}} {'calls':>7} {'host_ms':>11} "
            f"{'self_ms':>11} {'device_ms':>11} {'idle_ms':>11}")
    lines = [head, "-" * len(head)]
    order = sorted(rows.items(), key=lambda kv: (-kv[1][3], -kv[1][2]))
    for nm, r in order + [("total", total)]:
        dev = (f"{r[3] / 1e6:11.3f} {r[4] / 1e6:11.3f}" if device
               else f"{'-':>11} {'-':>11}")
        lines.append(f"{nm:<{width}} {r[0]:7d} {r[1] / 1e6:11.3f} "
                     f"{r[2] / 1e6:11.3f} {dev}")
    return "\n".join(lines) + "\n"
