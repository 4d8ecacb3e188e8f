"""The yardstick's arithmetic: the card's peaks, a kernel's roofline
bound from the operations and bytes its inputs need, and the model FLOPs
of a training step.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at the full 700 W
power limit). A bound is the larger of bytes over the memory rate and
operations over the peak rate of the type the operations run in; each
input byte counts read once and each output byte written once, and only
the work the inputs need counts: live box slots and unpadded lengths.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
                  "tf32": 494.7e12}
# the rate a whole step's model FLOPs are held to (bf16 dense)
MFU_PEAK = PEAK_OPS_PER_S["bfloat16"]


def roofline_s(bytes_moved, ops, dtype):
    """The least seconds a kernel can take."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])


def attention_bwd_bound_s(lengths, heads, head_dim, elem_bytes=2,
                          dtype="bfloat16"):
    """K4 over sequences of live lengths ``lengths``: reads q, k, v, the
    output gradient and the fp32 key bias, writes dq, dk, dv and the fp32
    bias gradient; five products of 2 L^2 D a head (S again, dP, dV, dQ,
    dK)."""
    tokens = sum(lengths)
    nbytes = 7 * tokens * heads * head_dim * elem_bytes + 2 * tokens * 4
    ops = 10 * heads * head_dim * sum(n * n for n in lengths)
    return roofline_s(nbytes, ops, dtype)


def k1b_bound_s(live, images, map_h, map_w, channels, elem_bytes=2,
                slots=108, pooled=14):
    """K1b: the live slots' gradient read once, the boxes and the mask
    (17 bytes a slot), the map's gradient written once; 2 fp32
    operations a sample tap, channel and bin (4 taps a bin at one sample
    a bin)."""
    nbytes = (live * pooled * pooled * channels * elem_bytes
              + images * slots * 17
              + images * map_h * map_w * channels * elem_bytes)
    return roofline_s(nbytes, 2 * 4 * live * pooled * pooled * channels,
                      "float32")


# ---------------------------------------------------------- model FLOPs

def conv_out(size, k, stride, dilation=1):
    pad = dilation * (k - 1) // 2
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def _conv(cin, cout, k, h, w, stride=1, dilation=1):
    """(FLOPs of one forward, output h, output w)."""
    ho, wo = conv_out(h, k, stride, dilation), conv_out(w, k, stride,
                                                       dilation)
    return 2 * cin * cout * k * k * ho * wo, ho, wo


def _bottleneck(cin, planes, h, w, stride, dilation, stride_in_1x1,
                downsample):
    """(FLOPs of each conv in order [conv1, conv2, conv3, downsample?],
    output h, w)."""
    s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
    f1, h1, w1 = _conv(cin, planes, 1, h, w, s1)
    f2, h2, w2 = _conv(planes, planes, 3, h1, w1, s3, dilation)
    f3, _, _ = _conv(planes, planes * 4, 1, h2, w2)
    convs = [f1, f2, f3]
    if downsample:
        convs.append(_conv(cin, planes * 4, 1, h, w, stride)[0])
    return convs, h2, w2


def backbone_flops(h, w, blocks=(3, 4, 23), stride_in_1x1=True):
    """Forward FLOPs of ResNet C4 over an h x w image: (stem and stage 1,
    which train nothing and take no gradient; the first block's input
    convs of stage 2, whose input takes no gradient; the rest of stages 2
    and 3)."""
    f, h, w = _conv(3, 64, 7, h, w, 2)
    h, w = conv_out(h, 3, 2), conv_out(w, 3, 2)
    frozen, first, rest = f, 0, 0
    cin = 64
    for stage, (planes, n, stride) in enumerate(((64, blocks[0], 1),
                                                 (128, blocks[1], 2),
                                                 (256, blocks[2], 2))):
        for i in range(n):
            convs, h, w = _bottleneck(cin, planes, h, w,
                                      stride if i == 0 else 1, 1,
                                      stride_in_1x1 and stage > 0, i == 0)
            cin = planes * 4
            if stage == 0:
                frozen += sum(convs)
            elif stage == 1 and i == 0:
                # conv1 and the downsample read stage 1's output
                first += convs[0] + convs[3]
                rest += convs[1] + convs[2]
            else:
                rest += sum(convs)
    return frozen, first, rest


def roi_head_flops(pooled=14, dilated=True):
    """Forward FLOPs of the conv5 head over one RoI."""
    stride, dilation = (1, 2) if dilated else (2, 1)
    total, h, w, cin = 0, pooled, pooled, 1024
    for i in range(3):
        convs, h, w = _bottleneck(cin, 512, h, w, stride if i == 0 else 1,
                                  dilation, True, i == 0)
        cin = 2048
        total += sum(convs)
    return total


def encoder_flops(length, hidden, inter, layers):
    """Forward FLOPs of the encoder over one sequence of ``length`` live
    tokens: q, k, v and the output projection, the FFN, the scores and
    the weighted sum."""
    per_layer = (8 * length * hidden * hidden + 4 * length * hidden * inter
                 + 4 * length * length * hidden)
    return layers * per_layer


def step_flops(task, cfg, stats):
    """Model FLOPs of one training step, forward and backward: the trained
    layers three times their forward (the data and the weight gradient),
    layers whose input takes no gradient twice, frozen layers nothing
    besides their forward. ``stats``: the step's batch (``batch_stats``)."""
    net, vl = cfg["NETWORK"], cfg["NETWORK"]["VLBERT"]
    H, I, n = vl["hidden_size"], vl["intermediate_size"], \
        vl["num_hidden_layers"]
    total = 0
    for length in stats["seq_lengths"]:
        total += 3 * encoder_flops(length, H, I, n)
    boxes = sum(stats["boxes"])
    feat_in = 4 * 2 * 256 + 2048
    total += 3 * 2 * feat_in * net["IMAGE_FINAL_DIM"] * boxes
    if task != "vcr":
        raise ValueError(f"no FLOP count for task {task!r}")
    per_seq = 2 * H * H + 2 * H
    total += 3 * per_seq * len(stats["seq_lengths"])
    choices = len(stats["seq_lengths"]) // len(stats["boxes"])
    total += 3 * (2 * H * H + 2 * H * 81) * boxes * choices
    for h, w in stats["image_hw"]:
        frozen, first, rest = backbone_flops(h, w)
        total += frozen + 2 * first + 3 * rest
    total += 3 * roi_head_flops(dilated=net["IMAGE_C5_DILATED"]) * boxes
    return total
