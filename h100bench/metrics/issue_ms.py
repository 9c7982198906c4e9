"""issue_ms: per completed query, the host time inside the program's
``m2v_query`` spans less the time inside their ``m2v_sync.*`` spans (its
blocking transfers), which leaves the engine's own Python and launches,
from ``mplan2vdl_tpu_torch.tracing``'s kept spans of the window's calls.
``sync_wait_ms`` reads the same spans through ``window_spans``."""


def window_spans(run):
    """(the window's ``m2v_query`` spans, their ``m2v_sync.*`` spans): the
    last ``run.attempted`` calls, so spans of an earlier profiler session
    never count.  None without device activity in the traced window
    (waiting on a device and issuing to one mean nothing on a CPU run),
    or without the program's spans of every call (a program without
    ``tracing``)."""
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.n:
        return None
    try:
        from mplan2vdl_tpu_torch import tracing
    except ImportError:
        return None
    recs = tracing.records()
    queries = [r for r in recs if r.name == "m2v_query"][-run.attempted:]
    if len(queries) != run.attempted:
        return None
    calls = {q.call for q in queries}
    syncs = [r for r in recs
             if r.call in calls and r.name.startswith("m2v_sync.")]
    return queries, syncs


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    queries, syncs = got
    ns = (sum(q.end_ns - q.start_ns for q in queries)
          - sum(s.end_ns - s.start_ns for s in syncs))
    return ns / 1e6 / run.n
