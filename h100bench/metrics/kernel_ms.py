"""kernel_ms: per completed query, the device time inside the engine's
calls into its kernel layer (compaction, gathers, monotone scatter, fused
aggregates)."""


def read(run):
    t = run.trace
    if t is None or not run.n or t.layer_s <= 0:
        return None
    return t.layer_s / run.n * 1e3
