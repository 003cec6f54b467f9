"""The 95th percentile of every request's latency in the window, host batch
in to masks in host memory (``statistics.quantiles``, exclusive method)."""

import statistics


def read(run):
    if run.kind != "serve" or len(run.latencies_s) < 20:
        return None
    return statistics.quantiles(run.latencies_s, n=20)[18] * 1e3
