"""engine_host_ms: per completed query, the traced window's wall time in
which no kernel and no copy ran on the device (the engine's host path),
less the benchmark's own count ranges."""


def read(run):
    t = run.trace
    if t is None or not run.n:
        return None
    return (t.program_s - t.busy_s) / run.n * 1e3
