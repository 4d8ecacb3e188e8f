"""k1b_roofline: K1b, ROIAlign's backward into the C4 map
(``csrc/roi_align_bwd.cu``), as a share of its roofline: the bound of
each profiled step's launch over its live box slots and its map
(``flops.k1b_bound_s``) over the kernel's device time."""

from portbench import flops

KERNEL = "roi_align_bwd_kernel"


def c4_size(n):
    """A side of the stride-16 map over a canvas side ``n``."""
    n = flops.conv_out(n, 7, 2)
    n = flops.conv_out(n, 3, 2)
    return flops.conv_out(flops.conv_out(n, 1, 2), 1, 2)


def read(ctx):
    us = sum(b - a for name, a, b in ctx["traced"]["device"]
             if KERNEL in name)
    if not us:
        return None
    bound = 0.0
    for s in ctx["timing"]["profiled"]:
        h, w = s["canvas"]
        bound += flops.k1b_bound_s(sum(s["boxes"]), len(s["boxes"]),
                                   c4_size(h), c4_size(w), 1024)
    return 100.0 * bound / (us / 1e6)
