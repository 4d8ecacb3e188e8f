"""elementwise_ms: device milliseconds a step in PyTorch's elementwise
kernels (every kernel whose name holds ``elementwise_kernel``: the frozen
BN's affine, ReLU, adds, masks, casts and their backward), over the
profiled steps."""


def read(ctx):
    steps = len(ctx["timing"]["profiled"])
    us = sum(b - a for name, a, b in ctx["traced"]["device"]
             if "elementwise_kernel" in name)
    return us / 1e3 / steps if steps and us else None
