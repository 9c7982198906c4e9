"""torch_ops_ms: per completed query, the device time of kernels and
memsets outside the engine's calls into its kernel layer (plain torch ops:
segred, scans, sorts, elementwise glue)."""


def read(run):
    t = run.trace
    if t is None or not run.n or t.kernels_s <= 0:
        return None
    return (t.kernels_s - t.layer_s) / run.n * 1e3
