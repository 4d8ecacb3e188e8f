"""The operation and byte counters against hand-counted small cases."""

import pytest

from portbench import flops


def test_conv_and_output_sizes():
    # 3x3, 2 -> 4 channels, 5x5 input, stride 1, pad 1: 5x5 out,
    # 2 * 2 * 4 * 9 * 25 = 3600
    assert flops._conv(2, 4, 3, 5, 5) == (3600, 5, 5)
    # stride 2: 3x3 out; dilation 2 (pad 2) keeps 5x5
    assert flops._conv(2, 4, 3, 5, 5, 2)[1:] == (3, 3)
    assert flops._conv(2, 4, 3, 5, 5, 1, 2)[1:] == (5, 5)
    # the stem of a 600 x 1200 canvas, then the pool and two stride-2
    # stages: the 38 x 75 C4 map
    from portbench import harness

    k1b = harness.load("metrics/k1b_roofline.py")
    assert (k1b.c4_size(600), k1b.c4_size(1200)) == (38, 75)


def test_encoder_flops_by_hand():
    # one layer, L=3, H=4, I=8: q, k, v, out 4 * 2*3*4*4 = 384, FFN
    # 2 * 2*3*4*8 = 384, scores and sum 2 * 2*3*3*4 = 144
    assert flops.encoder_flops(3, 4, 8, 1) == 384 + 384 + 144
    assert flops.encoder_flops(3, 4, 8, 2) == 2 * 912


def test_attention_bwd_bound_by_hand():
    # lengths 2 and 3, 1 head of 4, bf16: bytes 7*5*4*2 + 2*5*4 = 320,
    # ops 10*4*(4 + 9) = 520: bytes bound
    assert flops.attention_bwd_bound_s([2, 3], 1, 4) == pytest.approx(
        320 / flops.HBM_BYTES_PER_S)
    # one long sequence: operations bound
    n = 4096
    ops = 10 * 12 * 64 * n * n
    assert flops.attention_bwd_bound_s([n], 12, 64) == pytest.approx(
        ops / flops.PEAK_OPS_PER_S["bfloat16"])


def test_k1b_bound_by_hand():
    # 2 live of 1 image's 3 slots, a 2x2 map of 8 channels, pooled 2:
    # g 2*2*2*8*2 = 128, boxes and mask 3*17 = 51, dF 2*2*8*2 = 64 bytes;
    # 2*4*2*4*8 = 512 fp32 operations
    got = flops.k1b_bound_s(2, 1, 2, 2, 8, slots=3, pooled=2)
    assert got == pytest.approx(max(243 / flops.HBM_BYTES_PER_S,
                                    512 / flops.PEAK_OPS_PER_S["float32"]))


def test_vcr_step_flops_by_hand():
    cfg = {"NETWORK": {"IMAGE_FINAL_DIM": 4, "IMAGE_C5_DILATED": True,
                       "VLBERT": {"hidden_size": 4, "intermediate_size": 8,
                                  "num_hidden_layers": 1}}}
    # one image (no pixels counted here), 2 live boxes, two choices of 3
    # live tokens
    stats = {"seq_lengths": [3, 3], "boxes": [2], "image_hw": []}
    want = 2 * 3 * 912                               # the encoder
    want += 3 * 2 * (4 * 2 * 256 + 2048) * 4 * 2     # obj_downsample
    want += 3 * (2 * 4 * 4 + 2 * 4) * 2              # pooler, classifier
    want += 3 * (2 * 4 * 4 + 2 * 4 * 81) * 2 * 2     # the 81-way head
    want += 3 * flops.roi_head_flops(dilated=True) * 2
    assert flops.step_flops("vcr", cfg, stats) == want
    with pytest.raises(ValueError):
        flops.step_flops("vqa", cfg, stats)


def test_backbone_split_by_gradient():
    frozen, first, rest = flops.backbone_flops(64, 64, blocks=(1, 1, 1))
    # the stem over 64x64 -> 32x32: 2*3*64*49*32*32
    stem = 2 * 3 * 64 * 49 * 32 * 32
    # stage 1 at 16x16, cin 64 -> 256: conv1 64->64 1x1, conv2 3x3, conv3
    # 64->256, downsample 64->256
    hw = 16 * 16
    stage1 = 2 * hw * (64 * 64 + 64 * 64 * 9 + 64 * 256 + 64 * 256)
    assert frozen == stem + stage1
    # stage 2's first block: conv1 (256->128, stride 2 on the 1x1) and the
    # downsample read stage 1's output; at 8x8 out
    assert first == 2 * 64 * (256 * 128 + 256 * 512)
    assert rest > 0
