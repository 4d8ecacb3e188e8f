"""step_ms_p50: the benchmark's clock around each ``train_step`` call and
its ``float(loss)`` (the host copy, the step, the host's wait for the
loss), the median over the window's steps outside the profiled
stretch."""

import statistics


def read(ctx):
    steps = ctx["timing"]["step_s"]
    return statistics.median(steps) * 1e3 if steps else None
