"""query_p95_ms: the 95th percentile (nearest rank) of every completed
query's time from its send to its rows on the host."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
