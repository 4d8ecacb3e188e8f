"""mfu: the model FLOPs of the window's steps outside the profiled
stretch (``flops.step_flops``: forward and backward of every trained
layer over live boxes and unpadded tokens) over that part's wall time
times the card's bf16 dense peak, in percent."""

from portbench import flops


def read(ctx):
    stats = ctx["timing"]["stats"]
    wall = ctx["window_s"] - ctx["profiled_s"]
    if not stats or wall <= 0:
        return None
    total = sum(flops.step_flops(ctx["task"], ctx["config"], s)
                for s in stats)
    return 100.0 * total / (wall * flops.MFU_PEAK)
