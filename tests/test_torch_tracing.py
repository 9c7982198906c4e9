"""The port's program spans (``mplan2vdl_tpu_torch/tracing.py``) on the
CPU: Q1, Q6 and Q3 of ``h100bench/queries`` under a CPU
``torch.profiler`` session, with the fused-aggregate gate forced on and
off.  Each call is one ``m2v_query`` tree, the ``m2v_sync.*`` spans are
the calls' ``host_syncs`` (reads and uploads), every kept span is a range
the profiler saw,
and a call with the profiler off records nothing and evaluates with plain
``Compiler``; results are those of an untraced call.  ``span_table``'s
attribution of device work and idle time is checked on synthetic events,
and the benchmark's ``issue_ms`` / ``sync_wait_ms`` readers on kept
spans."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import cells
from mplan2vdl_tpu_torch import tracing
from mplan2vdl_tpu_torch.engine import datagen, lower

SF, SEED = 0.01, 7
QUERIES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100bench", "queries")


@pytest.fixture(scope="module")
def store():
    s = datagen.generate(sf=SF, seed=SEED)
    return s, s.make_catalog()


def _compile(store, q, fused, monkeypatch):
    monkeypatch.setenv("MPLAN2VDL_FUSED_AGG", fused)
    st, cfg = store
    with open(os.path.join(QUERIES, f"{q}.mplan")) as f:
        return lower.compile_plan_text(f.read(), cfg, st, device="cpu")


def _same(a, b):
    assert a.names == b.names and a.dtypes == b.dtypes
    for x, y in zip(a.columns, b.columns, strict=True):
        np.testing.assert_array_equal(x, y)


def _traced(cq, calls=2):
    """``calls`` calls under a CPU profiler session: (results, each
    call's host_syncs, kept spans, the profiler's host event names)."""
    tracing.clear()
    res, syncs = [], []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            res.append(cq())
            syncs.append(cq.host_syncs)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return res, syncs, tracing.records(), names


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("q", ["q1", "q6", "q3"])
def test_call_is_one_span_tree(store, q, fused, monkeypatch):
    cq = _compile(store, q, fused, monkeypatch)
    plain = cq()
    res, syncs, recs, names = _traced(cq)
    for r in res:
        _same(r, plain)
    queries = [r for r in recs if r.name == "m2v_query"]
    assert len(queries) == 2
    by_id = {r.id: r for r in recs}
    for r in recs:  # each chain of parents reaches its call's m2v_query
        top = r
        while top.parent is not None:
            assert top.start_ns >= by_id[top.parent].start_ns
            assert top.end_ns <= by_id[top.parent].end_ns
            top = by_id[top.parent]
        assert top.name == "m2v_query" and top.id == r.call
        assert r.name.startswith(tracing.PREFIX) and r.end_ns >= r.start_ns
        assert r.name in names  # a range the profiler recorded
    ncols = len(plain.columns)
    for qs, n in zip(queries, syncs, strict=True):
        mine = [r for r in recs if r.call == qs.call]
        sync = [r for r in mine if r.name.startswith("m2v_sync.")]
        assert len(sync) == n
        result = [r for r in mine if r.name == "m2v_result"]
        assert len(result) == 1
        inside = [r for r in sync if r.parent == result[0].id]
        assert sorted(r.name for r in inside) == sorted(
            ["m2v_sync.result_valid", "m2v_sync.result_copy"] * ncols)
        # while evaluating: Q3's selections read their counts; no plan
        # uploads a host value (a group-by's sentinel is a scalar operand)
        sites = {r.name for r in sync if r not in inside}
        assert sites == {"q1": set(), "q6": set(),
                         "q3": {"m2v_sync.select"}}[q]
    if q == "q1":
        assert ncols == 10
    if q == "q6":
        assert ncols == 1
    kernels = {r.name for r in recs if r.name.startswith("m2v_kernel.")}
    assert "m2v_kernel.compact_positions" in kernels
    if q == "q1" and fused == "1":
        assert "m2v_kernel.fused_group_aggregate" in kernels


@pytest.mark.parametrize("q", ["q1", "q6", "q3"])
def test_untraced_call_records_nothing(store, q, monkeypatch):
    cq = _compile(store, q, "1", monkeypatch)
    before = cq()
    tracing.clear()

    def refuse(self, v):
        raise AssertionError("an untraced call used the traced compiler")

    monkeypatch.setattr(lower.TracedCompiler, "eval", refuse)
    after = cq()
    assert tracing.records() == []
    _same(before, after)


def test_host_syncs_count_every_read(store, monkeypatch):
    """Without the profiler too: the evaluation's reads and uploads, then
    a count and a copy per result column; ``run`` leaves the rows on the
    device.  The first call also uploads the loaded columns."""
    cq = _compile(store, "q3", "0", monkeypatch)
    first = cq.run()
    with_columns = cq.host_syncs
    vals = cq.run()
    reads = cq.host_syncs
    assert reads > 0 and with_columns == reads + len(cq.loads)
    assert len(first) == len(vals)
    res = cq()
    valid_on_device = sum(isinstance(v.valid, torch.Tensor) for v in vals)
    assert cq.host_syncs == reads + valid_on_device + len(res.columns)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("q", ["q1", "q6", "q3", "q17"])
def test_host_syncs_count_every_upload(store, q, fused, monkeypatch):
    """Every host value that ``lower`` hands to ``torch.as_tensor`` is a
    counted upload, an ``m2v_sync.upload`` span (on the GPU each is a copy
    from pageable memory that waits for the stream).  A warm call of Q1,
    Q6 or Q3 uploads nothing (the group-by's sentinels and zeros are
    scalar operands); Q17's gathers and its ``_vmin`` upload three
    counts."""
    cq = _compile(store, q, fused, monkeypatch)
    cq()
    seen = []
    as_tensor = torch.as_tensor

    def witness(data, *args, **kwargs):
        if (sys._getframe(1).f_code.co_filename == lower.__file__
                and not isinstance(data, torch.Tensor)):
            seen.append(data)
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", witness)
    cq()
    untraced = len(seen)
    seen.clear()
    _, _, recs, _ = _traced(cq, calls=1)
    uploads = [r for r in recs if r.name == "m2v_sync.upload"]
    assert untraced == len(seen) == len(uploads)
    assert len(uploads) == {"q1": 0, "q6": 0, "q3": 0, "q17": 3}[q]


class _Event:
    """A profiler event as ``span_table`` reads it."""

    def __init__(self, name, start, end, device=False, corr=0):
        from torch.autograd import DeviceType

        self._n, self._s, self._e, self._c = name, start, end, corr
        self._d = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _rows(text):
    """{span name: the line's five numbers, or "-"}."""
    out = {}
    for ln in text.splitlines()[2:]:
        parts = ln.split()
        out[" ".join(parts[:-5])] = [int(parts[-5])] + [
            x if x == "-" else float(x) for x in parts[-4:]]
    return out


def test_span_table_attributes_device_work_and_idle_time():
    """Kernels go to the innermost span around their launch, idle time to
    the host's innermost span during the gap; annotations are not work."""
    ms = 1_000_000
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("m2v_query"):
            with tracing.span("m2v_node.A"):
                pass
            with tracing.span("m2v_sync.x"):
                pass
    events = [
        _Event("m2v_query", 0, 100 * ms),
        _Event("m2v_node.A", 10 * ms, 40 * ms),
        _Event("m2v_sync.x", 50 * ms, 90 * ms),
        _Event("cudaLaunchKernel", 15 * ms, 16 * ms, corr=1),
        _Event("cudaMemcpyAsync", 55 * ms, 56 * ms, corr=2),
        _Event("cudaLaunchKernel", 95 * ms, 96 * ms, corr=3),
        _Event("kernel_a", 20 * ms, 45 * ms, device=True, corr=1),
        _Event("m2v_node.A", 20 * ms, 45 * ms, device=True, corr=1),
        _Event("Memcpy DtoH", 60 * ms, 70 * ms, device=True, corr=2),
        _Event("kernel_b", 97 * ms, 99 * ms, device=True, corr=3),
        _Event("kernel_c", 98 * ms, 99 * ms, device=True, corr=9)]
    rows = _rows(tracing.span_table(_prof(events)))
    # calls, host ms, self ms, device ms, idle ms
    assert rows["m2v_query"] == [1, 100, 30, 2, 10 + 5 + 7 + 1]
    assert rows["m2v_node.A"] == [1, 30, 30, 25, 10]
    assert rows["m2v_sync.x"] == [1, 40, 40, 10, 10 + 20]
    assert rows["(no span)"] == [0, 0, 0, 1, 0]
    assert rows["total"] == [3, 100, 100, 38, 63]


def test_span_table_of_a_cpu_call(store, monkeypatch):
    cq = _compile(store, "q1", "1", monkeypatch)
    cq()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cq()
    recs = tracing.records()
    rows = _rows(tracing.span_table(prof))
    assert list(rows)[-1] == "total"
    assert set(rows) - {"total"} == {r.name for r in recs}
    assert all(r[-2:] == ["-", "-"] for r in rows.values())  # no device
    assert rows["total"][0] == len(recs)
    assert rows["m2v_query"][0] == 1
    assert rows["total"][1] == rows["m2v_query"][1] == pytest.approx(
        sum(r[2] for n, r in rows.items() if n != "total"), abs=0.01)


def _run(busy_s, attempted, failed=0):
    return SimpleNamespace(trace=SimpleNamespace(busy_s=busy_s),
                           attempted=attempted, n=attempted - failed)


def test_window_readers(store, monkeypatch):
    """``issue_ms`` + ``sync_wait_ms`` is the time inside the window's
    ``m2v_query`` spans per completed query, and spans of an earlier
    session never count."""
    issue, wait = cells.reader("issue_ms"), cells.reader("sync_wait_ms")
    cq = _compile(store, "q3", "0", monkeypatch)
    cq()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):  # an earlier session
            cq()
    with profile(activities=[ProfilerActivity.CPU]):
        cq()
        cq()
    recs = tracing.records()
    window = [r for r in recs if r.name == "m2v_query"][-2:]
    calls = {r.call for r in window}
    q_ns = sum(r.end_ns - r.start_ns for r in window)
    s_ns = sum(r.end_ns - r.start_ns for r in recs
               if r.call in calls and r.name.startswith("m2v_sync."))
    run = _run(1.0, 2)
    assert wait(run) == pytest.approx(s_ns / 1e6 / 2)
    assert issue(run) == pytest.approx((q_ns - s_ns) / 1e6 / 2)
    assert 0 < wait(run) < issue(run) + wait(run)
    assert issue(_run(0.0, 2)) is None and wait(_run(0.0, 2)) is None
    assert issue(_run(1.0, 9)) is None  # fewer calls than attempted
    half = _run(1.0, 2, failed=1)
    assert issue(half) == pytest.approx((q_ns - s_ns) / 1e6)
