"""loader_wait_ms: the host's wait for the next batch, the benchmark's
clock around each ``next()`` of the program's loader, mean over the
window's steps outside the profiled stretch."""

import statistics


def read(ctx):
    waits = ctx["timing"]["loader_s"]
    return statistics.fmean(waits) * 1e3 if waits else None
