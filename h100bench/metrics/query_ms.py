"""query_ms: the window's length over the queries completed in it (a query
completes when its rows are on the host)."""


def read(run):
    return run.window_s / run.n * 1e3 if run.n else None
