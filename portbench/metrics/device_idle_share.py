"""device_idle_share: the share of the profiled stretch in which no
operation ran on the card, 100 x (1 - the union of the device's
activities / the stretch's wall time)."""

from portbench import trace


def read(ctx):
    t = ctx["traced"]
    return 100.0 * (1.0 - trace.busy_s(t) / trace.window_s(t))
