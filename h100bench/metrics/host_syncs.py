"""host_syncs: counts read back to the host per completed query, from the
engine's own counter (CompiledQuery.host_syncs after each call)."""


def read(run):
    return run.host_syncs / run.n if run.n else None
