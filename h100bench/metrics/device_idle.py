"""device_idle: the share of the traced window (less the benchmark's own
count ranges), in %, in which no kernel, copy or memset ran on the
device."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return (1 - t.busy_s / t.program_s) * 100
