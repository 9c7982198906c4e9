"""sync_wait_ms: per completed query, the host time inside the program's
``m2v_sync.*`` spans (its blocking transfers: counts and rows read to the
host, host values copied to the device) of the window's ``m2v_query``
calls, from ``mplan2vdl_tpu_torch.tracing``'s kept spans.  The window's
spans, and when there are none, are ``issue_ms.window_spans``'s."""

import os

from h100bench import cells

window_spans = cells.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "issue_ms.py"),
    "h100bench_metric_issue_ms").window_spans


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    return sum(s.end_ns - s.start_ns for s in got[1]) / 1e6 / run.n
