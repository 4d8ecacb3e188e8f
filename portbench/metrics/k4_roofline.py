"""k4_roofline: K4, the attention backward with prob dropout
(``csrc/attention_dropout_mma.cu``: its rows and keys kernels), as a
share of its roofline: the bound of every profiled launch over the
sequences' live lengths (``flops.attention_bwd_bound_s``) over the two
kernels' device time. The per-head bias sum that follows in PyTorch is
not K4's kernel and is left out of both."""

from portbench import flops

KERNELS = ("attn_drop_bwd_rows_mma", "attn_drop_bwd_keys_mma")


def read(ctx):
    vl = ctx["config"]["NETWORK"]["VLBERT"]
    heads = vl["num_attention_heads"]
    us = sum(b - a for name, a, b in ctx["traced"]["device"]
             if any(k in name for k in KERNELS))
    if not us:
        return None
    bound = sum(vl["num_hidden_layers"] * flops.attention_bwd_bound_s(
        s["seq_lengths"], heads, vl["hidden_size"] // heads)
        for s in ctx["timing"]["profiled"])
    return 100.0 * bound / (us / 1e6)
