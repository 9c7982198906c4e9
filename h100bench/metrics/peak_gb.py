"""peak_gb: torch.cuda.max_memory_allocated over the window (reset when it
opens), in GB: the resident columns of every prepared query and the
queries' transients."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
