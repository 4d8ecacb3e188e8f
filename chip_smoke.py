#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (vlbert_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (built and checked for an NVIDIA H100) and the CUDA
toolkit (``nvcc``); exits non-zero without a card. Phases, each printing
its own line:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the kernels from vlbert_tpu_torch/csrc at first use;
  3. kernel parity: ROIAlign (K1; fp32 and bf16 maps, fp32 and bf16
     output, sampling ratio 1, 0 and 2) at the serve shape, at B=2 with 37
     slots, on the portrait map of a 640x480 query and at an odd C, and
     attention (K2; bf16 on the tensor cores, fp32 on the CUDA cores) at
     L = 1, 41, 63, 64, 65, 128 (B=16) and 173 against their plain PyTorch
     versions, with device times (profiler) and per-call CUDA-event times
     for both; K1 also timed by kernel name with its kernels per call, and
     the three ops the main path ran before K1 stored the compute dtype
     (the mask's conversion, the fp32-out K1, the cast);
  4. serve: ResNetVLBERTForRefCOCO from cfgs/refcoco/base_gt_boxes_4x16G.yaml
     at full width (ResNet-101, VL-BERT 768 x 12 layers x 12 heads, vocab
     30522), random weights from a fixed seed, bf16 compute, behind the
     port's RefCOCOServer; answers 8 distinct queries and checks that each
     launched K1 once and K2 twelve times;
  5. end-to-end agreement: the same weights in fp32, one query, with the
     kernels and with their plain versions;
  6. training-kernel parity at the VQA training shapes, fp32 and bf16:
     dropout (K5) forward and backward, also at odd sizes and on views
     that start off a 16-byte boundary, attention with prob dropout
     forward (K3) and backward (K4; bf16 on the tensor cores, fp32 on the
     CUDA cores) at L = 128, 41 and 173, and K2's backward, each against
     its plain version in explicit-bits and Philox mode; the kernels' keep
     masks are read back exactly in both dtypes and must equal the plain
     Philox's bit for bit, the backward must replay the forward's mask, the
     keep fraction must lie within 5 sigma of 1 - rate and two seeds must
     differ; a bf16 K4 repeated on the same inputs must give bit-identical
     gradients. Then the yardsticks: one PyTorch library call per kernel
     that computes the same function (scaled_dot_product_attention,
     dropout), timed and never used by the port, and the SASS instructions
     of one Philox evaluation, for each kernel's Philox floor;
  7. train: train_net (python -m vlbert_tpu_torch.engine.train) on a
     synthetic VQA set in the dataset's on-disk format, from
     cfgs/vqa/base_v5e_bf16.yaml at full width (VL-BERT 768 x 12 x 12,
     3129 answers, batch 16, L = 32 + 95 + 1 = 128, bf16), random weights
     from seed 0, with the printed overrides; the loss must fall, every
     step must launch K3 12, K4 12, K5 27 (forward) and 26 (backward)
     times, and validation must run K2; then a profiler window over a few
     steps;
  8. fp32 train-step agreement: one step from the same weights and seed
     with the kernels and with the plain versions (plain Philox, so the
     same masks): loss, gradient norm, every gradient leaf and the updated
     weights; and a repeat of the kernel step that must give
     bit-identical parameters.

Any failure raises. On every exit it stops the processes it started (the
loader's forkserver, multiprocessing's resource tracker, any leftover
child). The last three lines are the kernels' JSON record, the
nvidia-smi line, and {"ok": true, "device": {...}}. Kernel launches made
to compare a kernel with its plain version are not counted: each path's
counts are set to 0 just before it runs. Each kernel's record carries its
device time, its plain version's and its library call's (null for K1: no
single PyTorch call computes ROIAlign, torchvision is not installed), and
bound_ms: the larger of the bytes it must move over 3.35 TB/s and its
operations over the H100's peak for its dtype (bound_by says which; K1's
for its main-path route, bf16 in and out, with the fp32-out route beside
it);
K3, K4 and K5 also carry philox_floor_ms, their Philox evaluations times
the instructions of one over the card's integer issue rate.
"""

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "cfgs", "refcoco", "base_gt_boxes_4x16G.yaml")
SEED = 0

# tolerances: fp32 kernels do the plain versions' arithmetic in another
# order; bf16 attention output is rounded once more (one bf16 step at
# |out| ~ 1 is 2**-7 ~ 8e-3). K1's bf16 output is held to the plain fp32
# result rounded to bf16 within one bf16 step (2**-7 |b|: where the two
# fp32 sums straddle a rounding boundary) plus K1_ATOL
K1_ATOL = 1e-4
K1_BF16_RTOL = 2.0 ** -7
K2_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
E2E_ATOL = 1e-3
# training kernels. K5 does one IEEE multiply per kept element, the same
# one the plain version does: exact. K3 as K2. K4 and K2's backward: fp32
# sums in another order (fp32), plus one bf16 rounding of each gradient
# (2**-8 relative), relative to max(1, max |reference|)
DROP_RATE = 0.1
K5_ATOL = 0.0
K3_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
VQA_CFG = os.path.join(REPO, "cfgs", "vqa", "base_v5e_bf16.yaml")
# fp32 step agreement: loss and gradient norm to rounding of sums over
# ~110M parameters. Each leaf's gradient, relative to that leaf's largest
# element: fp32 sums in another order through 12 layers of backward (the
# worst leaf read 2e-6). The key biases get a gradient that is zero in
# exact arithmetic (softmax ignores a per-row shift): both steps give
# them only rounding noise, ~1e-10 of the largest gradient element, so a
# leaf's scale is floored at LEAF_FLOOR times that element (every other
# leaf's largest element read above 2e-4 of it). An AdamW first step
# moves each weight by lr * g / (|g| + 1e-6), about lr * sign(g): a wrong
# gradient sign moves a weight 2 * lr away, while rounding moves only
# elements with |g| near 1e-6; the updated weights must agree to lr / 10
# (the reading was 1.2e-7 at lr 1e-4)
STEP_RTOL = {"loss": 1e-4, "grad_norm": 1e-3, "leaf_grad": 1e-4,
             "param_per_lr": 0.1}
LEAF_FLOOR = 1e-5


# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at the full
# 700 W power limit): the roofline that bound_ms is reckoned against. Each
# input byte is counted read once and each output byte written once.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# int32 ALU lanes per SM and clock on Hopper: the integer issue rate that
# a Philox evaluation's instructions are reckoned against
INT_LANES_PER_SM = 64


def roofline(bytes_moved, ops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(B, L, H, D, dtype, backward=False):
    """Roofline of attention over [B, L, H, D] q, k, v and a [B,1,1,L] fp32
    bias. Forward: reads q, k, v, bias, writes out; 2 products of 2·L²·D
    per (b, h). Backward: reads q, k, v, g, bias, writes dq, dk, dv and
    dbias; 5 products (S again, dP, dV, dQ, dK)."""
    es = 2 if dtype == "bfloat16" else 4
    t = B * L * H * D * es
    if backward:
        return roofline(7 * t + 2 * B * L * 4, 10 * B * H * L * L * D, dtype)
    return roofline(4 * t + B * L * 4, 4 * B * H * L * L * D, dtype)


# Philox4x32-10 evaluations per call of each kernel that draws a mask, at
# bf16 (the tensor-core kernels): K5 one per four elements; K3 one per
# four (query, key) elements of each (b, h), over L padded to its 64-row
# tiles; K4 three times K3's, its rows pass sweeping the keys twice and its
# keys pass once
PHILOX_PER_CALL = {"K5": lambda n: -(-n // 4),
                   "K3": lambda B, H, L: B * H * (-(-L // 64) * 64) ** 2 // 4,
                   "K4": lambda B, H, L: 3 * B * H * (-(-L // 64) * 64) ** 2
                   // 4}


class HashTokenizer:
    """Deterministic hash tokenizer for random-weight runs (no vocab)."""

    cls_id, sep_id, mask_id = 101, 102, 103

    def tokenize(self, text):
        return text.lower().split()

    def convert_tokens_to_ids(self, toks):
        return [zlib.crc32(t.encode()) % 29000 + 1000 for t in toks]


def cuda_ms(fn, iters=50, warmup=5):
    """(device ms, call ms) per call of ``fn``: the route_ms and call_ms
    of ``time_calls``."""
    t = time_calls(fn, iters=iters, warmup=warmup)
    return t["route_ms"], t["call_ms"]


def time_calls(fn, kernel=None, iters=50, warmup=5):
    """Per call of ``fn``: {"route_ms": the summed device time of every
    kernel and copy it runs, from a torch.profiler trace of ``iters`` calls;
    "ms": that of the kernels whose name holds ``kernel``; "call_ms": the
    CUDA-event time of back-to-back calls, which includes the host's launch
    overhead wherever the host is slower than the device;
    "kernels_per_call"; "by_kernel": {name: device ms}}. Warm: what one
    call reads stays in L2 for the next."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    by_name = device_by_name(fn, iters)
    return {"ms": sum(us for k, (us, _) in by_name.items()
                      if kernel is not None and kernel in k) / 1e3 / iters,
            "route_ms": sum(us for us, _ in by_name.values()) / 1e3 / iters,
            "call_ms": start.elapsed_time(end) / iters,
            "kernels_per_call": sum(n for _, n in by_name.values()) / iters,
            "by_kernel": {k[:60]: us / 1e3 / iters
                          for k, (us, _) in by_name.items()}}


def device_by_name(fn, iters):
    """{kernel name: (summed device µs, launches)} over ``iters`` calls of
    ``fn`` in a torch.profiler window. The profiler now and then returns a
    window without device events; such a window is measured again, up to
    three times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.device_time, n + 1)
        if sum(us for us, _ in by_name.values()) > 0:
            return by_name
    raise AssertionError("the profiler recorded no device time in three "
                         "windows")


def device_us_by_name(fn, iters):
    """{kernel name: summed device µs} over ``iters`` calls of ``fn``."""
    return {k: us for k, (us, _) in device_by_name(fn, iters).items()}


# K1's kernel, by the name the profiler reports
K1_KERNEL = "roi_align_fwd_kernel"


# The serve shape's 16 box slots on a 1000x600 canvas (body4 [1,38,63,C]
# at stride 16), 14 live: edge cases first, then ordinary boxes
K1_SERVE_BOXES = (
    (0, 0, 999, 599),          # the whole canvas
    (10, 20, 300, 400),
    (900, 500, 1100, 700),     # crosses the right and bottom edges
    (-50, -50, -20, -10),      # entirely outside
    (30, 40, 30.5, 40.2),      # smaller than 1x1 on the map
    (990, 590, 1000, 600),     # on the map's far corner
    (0, 0, 8, 8),
    (500, 100, 700, 599),
    (-10, -10, 1010, 610),     # exceeds the map on every side
    (100, 100, 101, 130),
    (1000, 600, 1040, 640),    # starts at the map's far edge
    (5, 5, 995, 15),
    (200, 200, 600, 500),
    (0, 580, 999, 599),        # a strip along the bottom edge
    (0, 0, 0, 0), (0, 0, 0, 0))
K1_SERVE_LIVE = 14


def k1_serve_inputs(dev, C=1024):
    """The serve shape: fp32 body4 [1,38,63,C] from a seeded generator, the
    16 slots of K1_SERVE_BOXES and their bool mask (2 padded)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    feat = torch.randn(1, 38, 63, C, generator=g, device=dev)
    boxes = torch.tensor([K1_SERVE_BOXES], dtype=torch.float32, device=dev)
    mask = torch.zeros(1, len(K1_SERVE_BOXES), dtype=torch.bool, device=dev)
    mask[0, :K1_SERVE_LIVE] = True
    return feat, boxes, mask


def k1_cases(dev):
    """(name, fp32 map, boxes, bool mask, sampling ratios) of K1's parity:
    the serve shape; B=2 with 37 slots, the edge boxes and random ones,
    different in each image, padded slots at other places in each; the
    portrait canvas a 480x640 query is padded to (1000 tall, 600 wide: map
    [1,63,38,1024]) with the serve boxes transposed; and an odd C (1032:
    129 bf16 or 258 fp32 chunks a pixel, more than a block's threads)."""
    import numpy as np
    import torch

    feat, boxes, mask = k1_serve_inputs(dev)
    yield "serve", feat, boxes, mask, (1, 0, 2)
    rng = np.random.default_rng(SEED)
    O = 37
    b2 = np.zeros((2, O, 4), np.float32)
    m2 = np.zeros((2, O), bool)
    for b in range(2):
        xy = rng.uniform([-60, -60], [1040, 640], (O, 2))
        wh = rng.uniform(0.2, 1.0, (O, 1)) * rng.choice(
            [2.0, 30.0, 300.0, 1100.0], (O, 1)) * rng.uniform(0.5, 1.5, (O, 2))
        b2[b] = np.concatenate([xy, xy + wh], 1)
        m2[b] = rng.uniform(size=O) > 0.2
    b2[0, :K1_SERVE_LIVE] = K1_SERVE_BOXES[:K1_SERVE_LIVE]
    m2[0, :K1_SERVE_LIVE] = True
    m2[1, -1] = True
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    yield ("B2_O37", torch.randn(2, 38, 63, 1024, generator=g, device=dev),
           torch.from_numpy(b2).to(dev), torch.from_numpy(m2).to(dev),
           (1, 0, 2))
    portrait = boxes[..., [1, 0, 3, 2]].contiguous()
    yield ("portrait", feat.transpose(1, 2).contiguous(), portrait, mask,
           (1, 0))
    yield ("C1032", k1_serve_inputs(dev, C=1032)[0], boxes, mask, (1,))


def k1_parity(dev):
    """ROIAlign kernel vs plain over k1_cases: fp32 and bf16 maps, each to
    fp32 and bf16 output. fp32 out within K1_ATOL; bf16 out within one
    bf16 step of the plain fp32 result rounded to bf16 (|a - b| <=
    K1_BF16_RTOL |b| + K1_ATOL); padded slots exactly 0. Then timings at
    the serve shape, bf16 map, sampling ratio 1: the main path's route
    (bf16 out), the fp32-out route, the route the main path ran before K1
    stored the compute dtype (the bool mask converted to uint8, the fp32-out
    K1, the cast to bf16; three launches), and the plain version."""
    import torch
    from vlbert_tpu_torch.ops.roi_align import roi_align, roi_align_plain

    errs = {}
    for name, feat, boxes, mask, ratios in k1_cases(dev):
        for dtype in (torch.float32, torch.bfloat16):
            f = feat.to(dtype)
            for out_dtype in (torch.float32, torch.bfloat16):
                for sr in ratios:
                    kw = dict(sampling_ratio=sr, out_dtype=out_dtype)
                    a = roi_align(f, boxes, mask, **kw)
                    b = roi_align_plain(f, boxes, mask, **kw)
                    torch.cuda.synchronize()
                    key = (f"{name}/{str(dtype)[6:]}->"
                           f"{str(out_dtype)[6:]}/sr{sr}")
                    diff = (a.float() - b.float()).abs()
                    err = diff.max().item()
                    bf16 = out_dtype == torch.bfloat16
                    excess = (diff - (K1_BF16_RTOL * b.float().abs()
                                      + K1_ATOL) if bf16
                              else diff - K1_ATOL).max().item()
                    if not (a.dtype == out_dtype and a.shape == b.shape
                            and excess <= 0 and torch.all(a[~mask] == 0)):
                        raise AssertionError(
                            f"K1 {key}: max abs err {err}, excess over the "
                            f"tolerance {excess}, padded slots zero "
                            f"{bool(torch.all(a[~mask] == 0))}")
                    errs[key] = err
    feat, boxes, mask = k1_serve_inputs(dev)
    f = feat.to(torch.bfloat16)    # the serve path's body4 is bf16

    def old_route():
        m = mask.to(torch.uint8)
        return roi_align(f, boxes, m, sampling_ratio=1).to(torch.bfloat16)

    times = {
        "bf16_out": time_calls(lambda: roi_align(
            f, boxes, mask, sampling_ratio=1, out_dtype=torch.bfloat16),
            K1_KERNEL),
        "fp32_out": time_calls(lambda: roi_align(f, boxes, mask,
                                                 sampling_ratio=1),
                               K1_KERNEL),
        "old_route": time_calls(old_route, K1_KERNEL),
        "plain": cuda_ms(lambda: roi_align_plain(
            f, boxes, mask, sampling_ratio=1, out_dtype=torch.bfloat16))}
    return errs, times


def k1_bound(B, H, W, C, O, in_bytes, out_bytes, P=14, Q=14, taps=4):
    """K1's roofline: the map read once, the boxes and the mask, the output
    written once; 2 fp32 operations a tap and output element."""
    return roofline(B * H * W * C * in_bytes + B * O * (16 + 1)
                    + B * O * P * Q * C * out_bytes,
                    2 * taps * B * O * P * Q * C, "float32")


K2_LENGTHS = (1, 41, 63, 64, 65, 128, 173)
K2_TIMED = (41, 128, 173)


def k2_parity(dev):
    """Attention kernel vs plain, bf16 (tensor cores) and fp32 (CUDA
    cores), H=12, D=64: L = 41 is the serve shape (24 text + 16 boxes +
    END), 128 at B=16 the VQA validation shape, 173 the largest shipped
    bucket, and 1, 63, 64, 65 the ragged edges of one 64-row tile; B=1
    but at L=128. 5 keys masked (at L=1 the only key, a fully masked
    row); q, k, v are strided views of one fused projection. Device times
    in bf16 at the lengths of K2_TIMED."""
    import torch
    from vlbert_tpu_torch.ops.attention import fused_attention, plain_attention

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    errs, timing = {}, {}
    for L in K2_LENGTHS:
        B = 16 if L == 128 else 1
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, L, 3 * 768, generator=g, device=dev)
            q, k, v = (t.view(B, L, 12, 64) for t in qkv.to(dtype).split(
                768, dim=-1))
            m = torch.ones(B, L, device=dev)
            m[:, -5:] = 0
            bias = ((1.0 - m) * -10000.0)[:, None, None, :].contiguous()
            a = fused_attention(q, k, v, bias)
            b = plain_attention(q, k, v, bias)
            torch.cuda.synchronize()
            err = (a.float() - b.float()).abs().max().item()
            tol = K2_ATOL[str(dtype)[6:]]
            if not err <= tol:
                raise AssertionError(f"K2 B={B} L={L} {dtype}: max abs err "
                                     f"{err} > {tol}")
            errs[f"L{L}/{str(dtype)[6:]}"] = err
            if dtype == torch.bfloat16 and L in K2_TIMED:
                timing[L] = (cuda_ms(lambda: fused_attention(q, k, v, bias)),
                             cuda_ms(lambda: plain_attention(q, k, v, bias)))
    return errs, timing


def _maxerr(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel_err(a, b):
    """max |a - b| / max(1, max |b|)."""
    return _maxerr(a, b) / max(1.0, b.float().abs().max().item())


# K5's parity cases: (shape, elements skipped before the view starts). The
# training shapes; an odd size; views that start 1, 2 or 3 elements past a
# 16-byte boundary (2, 4 or 6 bytes in bf16, 4, 8 or 12 in fp32), whose
# 16-byte chunks begin at every phase of K5's groups of four; and a view
# no longer than its head in bf16 (the 7 elements before its first 16-byte
# boundary).
K5_CASES = (((16, 128, 768), 0), ((16, 95, 4096), 0), ((16, 768), 0),
            ((5, 41, 77), 0), ((5, 41, 77), 1), ((5, 41, 77), 2),
            ((5, 41, 77), 3), ((16, 128, 768), 1), ((7,), 1))


def k5_parity(dev):
    """Dropout kernel vs plain over K5_CASES, fp32 and bf16, both modes,
    forward and backward (the cotangent and the explicit bits start as far
    off a 16-byte boundary as x); Philox masks bit for bit; timing at
    [16,128,768] bf16."""
    import torch
    from vlbert_tpu_torch.ops.dropout import (flat_index_bits, hw_dropout,
                                              keep_mask, plain_dropout)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {}
    for shape, skip in K5_CASES:
        n = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            def view(t):
                return t.to(dtype)[skip:].view(shape)

            x = view(torch.randn(n + skip, generator=g, device=dev)) \
                .requires_grad_()
            gy = view(torch.randn(n + skip, generator=g, device=dev))
            bits = torch.randint(0, 65536, (n + skip,), generator=g,
                                 device=dev, dtype=torch.int32)[skip:] \
                .view(shape)
            for mode, kw in (("bits", dict(bits=bits)),
                             ("philox", dict(seed=SEED + 11))):
                a = hw_dropout(x, DROP_RATE, **kw)
                (da,) = torch.autograd.grad(a, x, gy)
                b = plain_dropout(x, DROP_RATE, **kw)
                (db,) = torch.autograd.grad(b, x, gy)
                err = max(_maxerr(a, b), _maxerr(da, db))
                key = (f"{'x'.join(map(str, shape))}+{skip}/"
                       f"{str(dtype)[6:]}/{mode}")
                if not err <= K5_ATOL:
                    raise AssertionError(f"K5 {key}: max abs err {err} > "
                                         f"{K5_ATOL}")
                errs[key] = err
    shape = (16, 128, 768)
    ones = torch.ones(shape, device=dev, requires_grad=True)
    masks = []
    for seed in (SEED + 21, SEED + 22):
        out = hw_dropout(ones, DROP_RATE, seed=seed)
        (dx,) = torch.autograd.grad(out, ones, torch.ones_like(out))
        keep = out != 0
        want = keep_mask(flat_index_bits(shape, seed, dev), DROP_RATE, False)
        if not (torch.equal(keep, want) and torch.equal(dx != 0, keep)):
            raise AssertionError(f"K5 seed {seed}: kernel mask != plain "
                                 f"Philox mask, or backward did not replay")
        masks.append(keep)
    frac, n = masks[0].float().mean().item(), masks[0].numel()
    sigma = (DROP_RATE * (1 - DROP_RATE) / n) ** 0.5
    if not abs(frac - (1 - DROP_RATE)) <= 5 * sigma:
        raise AssertionError(f"K5 keep fraction {frac} not within 5 sigma "
                             f"({sigma:.2e}) of {1 - DROP_RATE}")
    if torch.equal(masks[0], masks[1]):
        raise AssertionError("K5: two seeds gave the same mask")
    xb = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    timing = (cuda_ms(lambda: hw_dropout(xb, DROP_RATE, seed=SEED)),
              cuda_ms(lambda: plain_dropout(xb, DROP_RATE, seed=SEED)))
    return errs, {"keep_fraction": frac, "sigma": sigma}, timing


def _train_qkv(g, dev, dtype, B=16, L=128):
    """q, k, v as strided views of one fused [B, L, 3*768] leaf, and a
    [B,1,1,L] bias leaf: 7 padded keys per row, and batch row 1 with every
    key masked.

    q and k lie on a 2**-6 grid in (-4, 4): every q.k then sums exactly in
    fp32 (22 bits), in any order. On the all-masked row a score is about
    -10000, where an fp32 step is 2**-10, and two fp32 sums in different
    orders land on different steps, which moves that row's gradients by
    about the fp32 tolerance itself (tests/test_torch_train_attention.py::
    test_exact_score_inputs_make_fp32_sums_order_free). With exact sums
    both sides round to the same score, and what is left to compare is the
    kernels' arithmetic."""
    import torch

    qkv = torch.randn(B, L, 3 * 768, generator=g, device=dev)
    qk = torch.round(qkv[..., :2 * 768] * 64).clamp(-255, 255) / 64
    qkv = torch.cat([qk, qkv[..., 2 * 768:]], -1).to(dtype).requires_grad_()
    q, k, v = qkv.view(B, L, 3, 12, 64).unbind(2)
    m = torch.ones(B, L, device=dev)
    m[:, -7:] = 0
    m[1] = 0
    bias = ((1.0 - m) * -10000.0)[:, None, None, :].contiguous() \
        .requires_grad_()
    return qkv, (q, k, v), bias


def _attention_masks(dev, seed, dtype, B=16, H=12, L=128, D=64):
    """K3's and K4's keep masks [B, H, L, L], read back exactly: with
    q = k = 0 and bias 0 every prob is 1/L; v (and for K4 the cotangent g)
    encodes key (query) j as 2**(j % n) in dim j // n, so each output (dv)
    element is drop_scale / L times an n-bit word of the mask. n is 16 in
    fp32 and 4 in bf16, where a word of up to 15 survives the one bf16
    rounding of the output (and of the bf16 P operand in K4)."""
    import torch
    from vlbert_tpu_torch.ops.attention import fused_attention_dropout

    n = 16 if dtype == torch.float32 else 4
    j = torch.arange(L, device=dev)
    enc = torch.zeros(L, D, device=dev)
    enc[j, j // n] = (2.0 ** (j % n)).float()
    enc = enc[None, :, None, :].expand(B, L, H, D).contiguous().to(dtype)
    z = torch.zeros(B, L, H, D, device=dev, dtype=dtype)
    v = enc.clone().requires_grad_()
    out = fused_attention_dropout(z, z, v, torch.zeros(B, 1, 1, L,
                                                       device=dev),
                                  DROP_RATE, seed=seed)
    (dv,) = torch.autograd.grad(out, v, enc)
    f = L * (1.0 - DROP_RATE)
    shifts = torch.arange(n, device=dev)

    def unpack(words):            # [B, X, H, D] -> [B, H, X, L]
        w = torch.round(words.double() * f).long()[..., :L // n]
        bits = (w.permute(0, 2, 1, 3)[..., None] >> shifts) & 1
        return bits.reshape(B, H, L, L).bool()

    return unpack(out), unpack(dv).transpose(2, 3)


def k34_parity(dev):
    """K3/K4 vs plain at B=16 H=12 L=128 D=64 and at B=4 with L = 41 and
    173 (7 padded keys, one all-masked batch row), explicit bits and
    Philox, fp32 (CUDA cores) and bf16 (tensor cores); masks read back bit
    for bit in both dtypes; a bf16 backward repeated bit for bit; K2's
    backward; timings in bf16."""
    import torch
    from vlbert_tpu_torch.ops.attention import (
        attention_bits, fused_attention, fused_attention_dropout,
        plain_attention, plain_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import keep_mask

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = {"K3": {}, "K4": {}, "K2_bwd": {}}
    for B, L in ((16, 128), (4, 41), (4, 173)):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype)[6:]
            qkv, (q, k, v), bias = _train_qkv(g, dev, dtype, B=B, L=L)
            gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
            bits = torch.randint(0, 65536, (B, 12, L, L), generator=g,
                                 device=dev, dtype=torch.int32)
            for mode, kw in (("bits", dict(bits=bits)),
                             ("philox", dict(seed=SEED + 12))):
                a = fused_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
                ga = torch.autograd.grad(a, (qkv, bias), gy)
                b = plain_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
                gb = torch.autograd.grad(b, (qkv, bias), gy)
                e3 = _maxerr(a, b)
                e4 = max(_rel_err(x, y) for x, y in zip(ga, gb))
                key = f"L{L}/{dn}/{mode}"
                if not (e3 <= K3_ATOL[dn] and e4 <= BWD_RTOL[dn]):
                    raise AssertionError(
                        f"K3/K4 {key}: out err {e3} (atol {K3_ATOL[dn]}), "
                        f"grad rel err {e4} (rtol {BWD_RTOL[dn]})")
                errs["K3"][key] = e3
                errs["K4"][key] = e4
            if L != 128:
                continue
            if dtype == torch.bfloat16:
                a = fused_attention_dropout(q, k, v, bias, DROP_RATE,
                                            seed=SEED + 13)
                g1, g2 = (torch.autograd.grad(a, (qkv, bias), gy,
                                              retain_graph=True)
                          for _ in range(2))
                if not all(map(torch.equal, g1, g2)):
                    raise AssertionError("K4 bf16: two calls on the same "
                                         "inputs gave different gradients")
            a = fused_attention(q, k, v, bias)
            ga = torch.autograd.grad(a, (qkv, bias), gy)
            gb = torch.autograd.grad(plain_attention(q, k, v, bias),
                                     (qkv, bias), gy)
            e2 = max(_rel_err(x, y) for x, y in zip(ga, gb))
            if not e2 <= BWD_RTOL[dn]:
                raise AssertionError(f"K2 backward {dn}: rel err {e2}")
            errs["K2_bwd"][dn] = e2

    fwd_masks = []
    for dtype in (torch.float32, torch.bfloat16):
        for seed in (SEED + 31, SEED + 32):
            fwd, bwd = _attention_masks(dev, seed, dtype)
            want = keep_mask(attention_bits(16, 12, 128, seed, dev),
                             DROP_RATE, False)
            if not (torch.equal(fwd, want) and torch.equal(bwd, want)):
                raise AssertionError(
                    f"K3/K4 {dtype} seed {seed}: mismatched keep bits fwd "
                    f"{(fwd != want).sum().item()}, bwd "
                    f"{(bwd != want).sum().item()} of {want.numel()}")
            fwd_masks.append(fwd)
    frac, n = fwd_masks[0].float().mean().item(), fwd_masks[0].numel()
    sigma = (DROP_RATE * (1 - DROP_RATE) / n) ** 0.5
    if not abs(frac - (1 - DROP_RATE)) <= 5 * sigma:
        raise AssertionError(f"K3 keep fraction {frac} not within 5 sigma "
                             f"({sigma:.2e}) of {1 - DROP_RATE}")
    if torch.equal(fwd_masks[0], fwd_masks[1]):
        raise AssertionError("K3: two seeds gave the same mask")

    # timings, bf16, Philox: K3 on the fused-projection views; K4 as the
    # backward of one forward (separate leaves)
    with torch.no_grad():
        _, (q, k, v), bias = _train_qkv(g, dev, torch.bfloat16)
        bias = bias.detach()
        k3 = (cuda_ms(lambda: fused_attention_dropout(
                  q, k, v, bias, DROP_RATE, seed=SEED)),
              cuda_ms(lambda: plain_attention_dropout(
                  q, k, v, bias, DROP_RATE, seed=SEED)))
    leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    gy = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    outs = (fused_attention_dropout(*leaves, bias, DROP_RATE, seed=SEED),
            plain_attention_dropout(*leaves, bias, DROP_RATE, seed=SEED))
    k4 = tuple(cuda_ms(lambda o=o: torch.autograd.grad(
        o, leaves, gy, retain_graph=True)) for o in outs)
    # K4's device time by kernel: its two passes and the sum over heads
    k4_split = {name: us / 1e3 / 50 for name, us in device_us_by_name(
        lambda: torch.autograd.grad(outs[0], leaves, gy, retain_graph=True),
        50).items()}
    return errs, {"keep_fraction": frac, "sigma": sigma}, k3, k4, k4_split


def library_ms(fn, iters=50, warmup=5):
    """(device ms per call, sorted kernel names) of a PyTorch library call
    timed as a yardstick; the port never calls it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by_name = device_us_by_name(fn, iters)
    return sum(by_name.values()) / 1e3 / iters, sorted(by_name)


def _sdpa_args(q, k, v, bias):
    """SDPA's [B, H, L, D] views of the port's [B, L, H, D] q, k, v, and the
    bias as an additive mask in q's dtype."""
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            bias.to(q.dtype))


def library_yardsticks(dev):
    """One PyTorch call per kernel that computes the same function, at the
    main path's shapes, bf16: scaled_dot_product_attention for K2 (B=1
    L=41 and B=16 L=128), with dropout_p=rate for K3 (its masks are its
    own; the work is the same), autograd through that call for K4, and
    torch.nn.functional.dropout for K5. Returns {name: (ms, kernel
    names)}."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = {}
    qkv = torch.randn(1, 41, 3 * 768, generator=g, device=dev) \
        .to(torch.bfloat16)
    q, k, v = (t.view(1, 41, 12, 64) for t in qkv.split(768, dim=-1))
    m = torch.ones(1, 41, device=dev)
    m[0, -5:] = 0
    bias = ((1.0 - m) * -10000.0)[:, None, None, :].contiguous()
    a = _sdpa_args(q, k, v, bias)
    out["K2_L41"] = library_ms(
        lambda: F.scaled_dot_product_attention(*a[:3], attn_mask=a[3]))
    with torch.no_grad():
        _, (q, k, v), bias = _train_qkv(g, dev, torch.bfloat16)
        bias = bias.detach()
        a = _sdpa_args(q, k, v, bias)
        out["K2_L128"] = library_ms(
            lambda: F.scaled_dot_product_attention(*a[:3], attn_mask=a[3]))
        out["K3"] = library_ms(lambda: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], dropout_p=DROP_RATE))
    leaves = [t.detach().transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=a[3],
                                       dropout_p=DROP_RATE)
    gy = torch.randn(o.shape, generator=g, device=dev).to(torch.bfloat16)
    out["K4"] = library_ms(lambda: torch.autograd.grad(o, leaves, gy,
                                                       retain_graph=True))
    x = torch.randn(16, 128, 768, generator=g, device=dev).to(torch.bfloat16)
    out["K5"] = library_ms(lambda: F.dropout(x, DROP_RATE, training=True))
    return out


PHILOX_PROBE = r"""
#include "common.cuh"
extern "C" __global__ void probe_words4(const unsigned* c, uint4* o,
                                        unsigned long long seed) {
  const int i = threadIdx.x;
  o[i] = philox4(c[i], c[i + 32], c[i + 64], c[i + 96], seed);
}
extern "C" __global__ void probe_none4(const unsigned* c, uint4* o,
                                       unsigned long long seed) {
  const int i = threadIdx.x;
  const unsigned s = (unsigned)seed ^ (unsigned)(seed >> 32);
  o[i] = make_uint4(c[i] ^ s, c[i + 32] ^ s, c[i + 64] ^ s, c[i + 96] ^ s);
}
"""


def philox_sass_instructions():
    """SASS instructions of one Philox4x32-10 evaluation of all four words
    (csrc/common.cuh), as K3, K4 and K5 use it, counted with cuobjdump: a
    probe kernel that evaluates it once per thread, minus one that reads
    and writes the same words without it; nvcc for sm_90a at -O3, as the
    kernels are built. Returns (the count, the raw counts)."""
    import re

    from vlbert_tpu_torch.kernels import build

    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    d = tempfile.mkdtemp(prefix="philox_probe_")
    try:
        src = os.path.join(d, "probe.cu")
        with open(src, "w") as f:
            f.write(PHILOX_PROBE)
        cubin = os.path.join(d, "probe.cubin")
        subprocess.run([nvcc, "-cubin", *build.NVCC_FLAGS[:2], "-O3",
                        "-I", str(build.CSRC_DIR), "-o", cubin, src],
                       check=True, capture_output=True, text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    finally:
        shutil.rmtree(d, ignore_errors=True)
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)[@A-Z]",
                               line):
            counts[name] += 1
    return counts["probe_words4"] - counts["probe_none4"], counts


def int_issue_per_s():
    """int32 operations per second the card can issue: SMs x int lanes x
    the maximum SM clock nvidia-smi reports."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_LANES_PER_SM * mhz * 1e6, sms, mhz


def make_queries(n=8):
    import numpy as np

    rng = np.random.default_rng(SEED)
    exprs = ["the man on the left", "red car parked near the tree",
             "woman holding an umbrella", "the smaller dog",
             "second chair from the right", "blue shirt guy in the back",
             "plate with the sandwich", "bus behind the taxi"]
    counts = [2, 5, 9, 15, 3, 12, 7, 15]
    queries = []
    for i in range(n):
        h, w = (480, 640) if i % 2 == 0 else (640, 480)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = counts[i]
        x1 = rng.uniform(0, w * 0.7, k)
        y1 = rng.uniform(0, h * 0.7, k)
        x2 = np.minimum(x1 + rng.uniform(8, w * 0.5, k), w - 1)
        y2 = np.minimum(y1 + rng.uniform(8, h * 0.5, k), h - 1)
        boxes = np.stack([x1, y1, x2, y2], 1).astype(np.float32)
        boxes[0] = (0, h * 0.5, w - 1, h - 1)    # touches three edges
        queries.append((img, boxes, exprs[i]))
    return queries


@contextlib.contextmanager
def plain_versions():
    """Route the model's ROIAlign and attention calls to the plain PyTorch
    versions, explicitly, for the end-to-end comparison."""
    import vlbert_tpu_torch.models.bert as bert
    import vlbert_tpu_torch.models.fast_rcnn as fast_rcnn
    from vlbert_tpu_torch.ops.attention import plain_attention
    from vlbert_tpu_torch.ops.roi_align import roi_align_plain

    saved = fast_rcnn.roi_align, bert.fused_attention
    fast_rcnn.roi_align, bert.fused_attention = roi_align_plain, plain_attention
    try:
        yield
    finally:
        fast_rcnn.roi_align, bert.fused_attention = saved


FIXTURE_WORDS = ["what", "is", "the", "color", "of", "man", "holding", "how",
                 "many", "are", "there", "in", "picture", "left", "right",
                 "dog", "cat", "on", "table", "people", "yes", "no", "red",
                 "blue", "two", "three", "?"]
FIXTURE_ANSWERS = ["yes", "no", "red", "blue", "two", "three"]


def write_vocab(path, size=30522):
    """[PAD] 0, [unused*] 1-99, [UNK] 100, [CLS] 101, [SEP] 102, [MASK]
    103 (bert-base-uncased's ids), the question words, then fillers."""
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + FIXTURE_WORDS)
    vocab += [f"tok{i}" for i in range(size - len(vocab))]
    with open(path, "w") as f:
        f.write("\n".join(vocab) + "\n")


def write_vqa_fixture(root, n_train=64, n_val=32, feat_dim=2048,
                      n_answers=3129, min_boxes=10, max_boxes=100, seed=0):
    """A synthetic VQA set in the VQA dataset's own on-disk format under
    ``root`` (the real data and vocabulary are not in the repo): jsonl rows
    ``train.jsonl`` and ``val.jsonl``, one json per image with base64
    float32 ``boxes`` and ``features``, a generated BERT ``vocab.txt`` and
    an answer vocabulary. Each question's dominant answer is visible in its
    image's features, so the loss can fall. Returns (data_dir, vocab_dir,
    answer_file)."""
    import base64

    import numpy as np

    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "vqa")
    vocab_dir = os.path.join(root, "bert")
    os.makedirs(os.path.join(data_dir, "boxes"), exist_ok=True)
    os.makedirs(vocab_dir, exist_ok=True)
    write_vocab(os.path.join(vocab_dir, "vocab.txt"))
    answers = ["<unk>"] + FIXTURE_ANSWERS
    answers += [f"answer{i}" for i in range(n_answers - len(answers))]
    answer_file = os.path.join(data_dir, "answers.txt")
    with open(answer_file, "w") as f:
        f.write("\n".join(answers) + "\n")

    rows = []
    for i in range(n_train + n_val):
        w, h = int(rng.integers(400, 641)), int(rng.integers(300, 481))
        nb = int(rng.integers(min_boxes, max_boxes + 1))
        xy = rng.uniform(0, [w * 0.7, h * 0.7], (nb, 2))
        wh = rng.uniform(8, [w * 0.3, h * 0.3], (nb, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        feats = np.maximum(rng.normal(size=(nb, feat_dim)), 0) \
            .astype(np.float32)
        label = i % len(FIXTURE_ANSWERS)
        feats[:, label] += 3.0          # the answer is visible in the image
        with open(os.path.join(data_dir, "boxes", f"{i}.json"), "w") as f:
            json.dump({"num_boxes": nb,
                       "boxes": base64.b64encode(boxes.tobytes()).decode(),
                       "features": base64.b64encode(feats.tobytes()).decode()},
                      f)
        n_words = int(rng.integers(4, 12))
        question = " ".join(rng.choice(FIXTURE_WORDS[:-1], n_words)) + " ?"
        rows.append({"question_id": i, "image_id": i, "question": question,
                     "image_fn": f"img/{i}.jpg", "box_fn": f"boxes/{i}.json",
                     "width": w, "height": h,
                     "answers": [FIXTURE_ANSWERS[label]] * 7
                     + [FIXTURE_ANSWERS[(label + 1) % len(FIXTURE_ANSWERS)]]
                     * 3})
    for name, part in (("train.jsonl", rows[:n_train]),
                       ("val.jsonl", rows[n_train:])):
        with open(os.path.join(data_dir, name), "w") as f:
            f.write("\n".join(json.dumps(r) for r in part) + "\n")
    return data_dir, vocab_dir, answer_file


def vqa_train_config(root):
    """cfgs/vqa/base_v5e_bf16.yaml pointed at a synthetic VQA set under
    ``root``, with the overrides printed."""
    from vlbert_tpu_torch.utils.config import load_config

    data_dir, vocab_dir, answer_file = write_vqa_fixture(
        root, n_train=64, n_val=32, seed=SEED)
    cfg = load_config("vqa", VQA_CFG)
    overrides = {
        # no VL-BERT checkpoint or BERT weights are in the repo
        "NETWORK.PARTIAL_PRETRAIN": "",
        "NETWORK.BERT_MODEL_NAME": vocab_dir,
        "DATASET.DATASET_PATH": data_dir,
        "DATASET.ROOT_PATH": data_dir,
        "DATASET.TRAIN_ANNOTATION_FILE": "train.jsonl",
        "DATASET.VAL_ANNOTATION_FILE": "val.jsonl",
        "DATASET.ANSWER_VOCAB_FILE": answer_file,
        "OUTPUT_PATH": os.path.join(root, "out"),
        "RNG_SEED": SEED,
        # 64 samples / batch 16 = 4 steps per epoch, 8 epochs
        "TRAIN.END_EPOCH": 8,
        "LOG_FREQUENT": 4,
        # no warm-up and base LR 16 x 6.25e-6 = 1e-4, so that the loss
        # visibly falls within 32 steps on a small repeated set
        "TRAIN.WARMUP": False,
        "TRAIN.LR": 6.25e-6,
    }
    for path, value in overrides.items():
        node = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg, overrides


@contextlib.contextmanager
def plain_training():
    """Route the training path's attention and dropout calls to the plain
    PyTorch versions (plain Philox, so the masks are the kernels')."""
    import vlbert_tpu_torch.models.bert as bert
    import vlbert_tpu_torch.ops.dropout as dropout
    from vlbert_tpu_torch.ops.attention import (plain_attention,
                                                plain_attention_dropout)

    saved = (bert.fused_attention, bert.fused_attention_dropout,
             dropout.hw_dropout)
    bert.fused_attention = plain_attention
    bert.fused_attention_dropout = plain_attention_dropout
    dropout.hw_dropout = dropout.plain_dropout
    try:
        yield
    finally:
        (bert.fused_attention, bert.fused_attention_dropout,
         dropout.hw_dropout) = saved


def _launch_counts():
    from vlbert_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import hw_dropout

    return {"K2": fused_attention.launches,
            "K3": fused_attention_dropout.launches,
            "K4": fused_attention_dropout.bwd_launches,
            "K5_fwd": hw_dropout.launches,
            "K5_bwd": hw_dropout.bwd_launches}


def _zero_counts():
    from vlbert_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import hw_dropout

    fused_attention.launches = 0
    fused_attention_dropout.launches = fused_attention_dropout.bwd_launches = 0
    hw_dropout.launches = hw_dropout.bwd_launches = 0


def train_phase(cfg, device="cuda"):
    """train_net at full width; returns (model, history, launches)."""
    import types

    import torch
    from vlbert_tpu_torch.engine.train import train_net

    args = types.SimpleNamespace(model_dir=cfg.OUTPUT_PATH, device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    model, history = train_net(args, cfg, "vqa")
    launches = _launch_counts()
    steps = len(history["loss"])
    n_val = -(-32 // cfg.VAL.BATCH_IMAGES) * len(history["val"])
    want = {"K2": 12 * n_val, "K3": 12 * steps, "K4": 12 * steps,
            "K5_fwd": 27 * steps, "K5_bwd": 26 * steps}
    if launches != want or n_val == 0:
        raise AssertionError(f"train launches {launches}, expected {want}")
    loss = history["loss"]
    if not (all(map(math.isfinite, loss))
            and sum(loss[-4:]) < sum(loss[:4])):
        raise AssertionError(f"train loss did not fall: {loss}")
    return model, history, launches


def profile_steps(model, cfg, n=4):
    """Device busy time and top kernels over ``n`` train steps of
    ``model`` (a fresh optimizer, the phase's first batch)."""
    import torch
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.training.loop import make_train_step, to_device
    from vlbert_tpu_torch.training.optim import Optimizer

    loader = make_dataloader(cfg, "vqa", "train")
    try:
        batch = to_device(next(iter(loader)), "cuda")
    finally:
        loader.shutdown()
    step = make_train_step(model, Optimizer(cfg, model, 4), "vqa", cfg)
    step(batch, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(batch, SEED + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name = device_us_by_name(lambda: step(batch, SEED), n)
    busy_ms = sum(by_name.values()) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall_ms, busy_ms, [(k[:60], v / 1e3 / n) for k, v in top]


def step_agreement(cfg, dev):
    """One fp32 step from the same weights and seed with the kernels and
    with the plain versions."""
    import copy

    import torch
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import make_train_step, to_device
    from vlbert_tpu_torch.training.optim import (Optimizer,
                                                 apply_trainable_mask)

    loader = make_dataloader(cfg, "vqa", "train")
    try:
        batch = to_device(next(iter(loader)), dev)
    finally:
        loader.shutdown()
    model = build_module(cfg, "vqa", dtype=torch.float32, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    apply_trainable_mask(model, cfg)
    twin, again = copy.deepcopy(model), copy.deepcopy(model)
    results, leaf_grads = [], []
    for m, ctx in ((model, contextlib.nullcontext()),
                   (twin, plain_training()),
                   (again, contextlib.nullcontext())):
        opt = Optimizer(cfg, m, 4)
        lr = opt.lr()
        kept, opt_step = {}, opt.step

        def step_and_keep(grads, opt=opt, kept=kept, opt_step=opt_step):
            kept.update((n, g.detach().clone())
                        for n, g in zip(opt.names, grads))
            return opt_step(grads)

        opt.step = step_and_keep
        _zero_counts()
        with ctx:
            loss, dm = make_train_step(m, opt, "vqa", cfg)(batch, SEED + 5)
        results.append((float(loss), float(dm["grad_total_norm"][0]),
                        _launch_counts()))
        leaf_grads.append(kept)
    (l1, n1, c1), (l2, n2, c2), _ = results
    g1, g2 = leaf_grads[:2]
    if g1.keys() != g2.keys() or not g1:
        raise AssertionError("fp32 step: the two steps updated different "
                             "parameters")
    leaf_max = {k: g.abs().max().item() for k, g in g2.items()}
    floor = LEAF_FLOOR * max(leaf_max.values())
    leaf_gap = {k: _maxerr(g1[k], g2[k]) / max(leaf_max[k], floor)
                for k in g2}
    worst_leaf = max(leaf_gap, key=leaf_gap.get)
    # the same seed and batch give a bit-identical step
    p3 = dict(again.named_parameters())
    repeat_equal = all(torch.equal(p, p3[k])
                       for k, p in model.named_parameters())
    if not repeat_equal:
        raise AssertionError("fp32 step: a repeat from the same weights and "
                             "seed gave different parameters")
    # the kernel step ran the kernels, the plain step none of them
    if c1 != {"K2": 0, "K3": 12, "K4": 12, "K5_fwd": 27, "K5_bwd": 26} \
            or any(c2.values()):
        raise AssertionError(f"fp32 step launches: kernels {c1}, plain {c2}")
    p2 = dict(twin.named_parameters())
    dparam = max((p - p2[k]).abs().max().item()
                 for k, p in model.named_parameters())
    checks = {"loss": (abs(l1 - l2) / abs(l2), STEP_RTOL["loss"]),
              "grad_norm": (abs(n1 - n2) / n2, STEP_RTOL["grad_norm"]),
              "leaf_grad": (leaf_gap[worst_leaf], STEP_RTOL["leaf_grad"]),
              "param_per_lr": (dparam / lr, STEP_RTOL["param_per_lr"])}
    bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"fp32 step: (err, tol) {checks}; worst leaf "
                             f"gradient {worst_leaf}")
    return {"loss": (l1, l2), "grad_norm": (n1, n2), "checks": checks,
            "launches": (c1, c2), "n_leaves": len(g2),
            "worst_leaf": worst_leaf, "max_param_diff": dparam, "lr": lr}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vlbert_tpu_torch.data.transforms import build_transforms
    from vlbert_tpu_torch.engine.serve import RefCOCOServer
    from vlbert_tpu_torch.kernels import build
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.ops.attention import fused_attention
    from vlbert_tpu_torch.ops.roi_align import roi_align
    from vlbert_tpu_torch.utils.config import load_config

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit " \
           f"{smi.split(',')[-1].strip()}"
    print(f"[1 device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)",
          flush=True)

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    print(f"[2 build] {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}",
          flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1_errs, k1_t = k1_parity(dev)
    k1_fp32_err = max(v for k, v in k1_errs.items() if "->float32" in k)
    k1_bf16_err = max(v for k, v in k1_errs.items() if "->bfloat16" in k)
    print(f"[3 parity K1 roi_align] {len(k1_errs)} cases "
          f"(case/map->out/sampling ratio) {sorted(k1_errs)}: max abs err "
          f"fp32 out {k1_fp32_err:.3e} (atol {K1_ATOL}), bf16 out "
          f"{k1_bf16_err:.3e} (within {K1_BF16_RTOL} |plain| + {K1_ATOL}), "
          f"padded slots 0; bf16 body4 [1,38,63,1024], 16 slots, sampling "
          f"1, warm, device ms by kernel (route, call ms, kernels a call): "
          + "; ".join(f"{k} {t['ms']:.4f} ({t['route_ms']:.4f}, "
                      f"{t['call_ms']:.4f}, {t['kernels_per_call']:g})"
                      for k, t in k1_t.items() if k != "plain")
          + f"; old route by kernel {k1_t['old_route']['by_kernel']}; plain "
          f"{k1_t['plain'][0]:.4f} ({k1_t['plain'][1]:.4f}) ({card})",
          flush=True)
    k2_errs, k2_ms = k2_parity(dev)
    print(f"[3 parity K2 attention] max abs err {k2_errs} (atol "
          f"{K2_ATOL}); bf16 on the tensor cores, H=12 D=64, device ms (call "
          f"ms): " +
          ", ".join(f"B={16 if L == 128 else 1} L={L} kernel {a[0]:.4f} "
                    f"({a[1]:.4f}), plain {b[0]:.4f} ({b[1]:.4f})"
                    for L, (a, b) in k2_ms.items()) + f" ({card})",
          flush=True)

    # --- serve: full width, bf16 ---
    cfg = load_config("refcoco", CFG)
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False
    # a trained checkpoint has non-zero visual LN scales; the config's 0.0
    # init would make random-weight logits blind to the image
    cfg.NETWORK.VLBERT.visual_scale_text_init = 1.0
    cfg.NETWORK.VLBERT.visual_scale_object_init = 1.0
    model = build_module(cfg, "refcoco", dtype=torch.bfloat16, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    srv = RefCOCOServer(model, HashTokenizer(), build_transforms(cfg, "test"),
                        max_text=24, max_boxes=16)
    queries = make_queries()
    srv.query(*queries[0])                                   # warm-up
    torch.cuda.synchronize()

    roi_align.launches = fused_attention.launches = 0
    for i, (img, cand, expr) in enumerate(queries):
        before = roi_align.launches, fused_attention.launches
        r = srv.query(img, cand, expr)
        delta = (roi_align.launches - before[0],
                 fused_attention.launches - before[1])
        scores = r["candidate_scores"]
        if delta != (1, 12):
            raise AssertionError(f"query {i}: launches (K1, K2) {delta}, "
                                 f"expected (1, 12)")
        if not (scores.shape == (len(cand),) and np.isfinite(scores).all()
                and np.isfinite(r["image_box_score"])):
            raise AssertionError(f"query {i}: non-finite or misshapen "
                                 f"scores {scores}")
        if not 0 <= r["best_index"] < len(cand):
            raise AssertionError(f"query {i}: best_index {r['best_index']} "
                                 f"outside {len(cand)} candidates")
        if not np.array_equal(r["box"], cand[r["best_index"]]):
            raise AssertionError(f"query {i}: box {r['box']} != candidate "
                                 f"{cand[r['best_index']]}")
    launches = {"roi_align": roi_align.launches,
                "fused_attention": fused_attention.launches}
    if launches != {"roi_align": 8, "fused_attention": 96}:
        raise AssertionError(f"main-path launches {launches}, expected 8 "
                             f"and 96")
    torch.cuda.reset_peak_memory_stats()
    lat = srv.measure_latency(queries * 3, warmup=3)
    print(f"[4 serve] RefCOCO+ base, ResNet-101 + VL-BERT 768x12x12, "
          f"{n_params / 1e6:.1f}M params, bf16, 8 distinct queries ok "
          f"(launches {launches}); latency p50 {lat['p50_ms']:.2f} ms, "
          f"p90 {lat['p90_ms']:.2f} ms over n={lat['n']}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({card})", flush=True)

    # --- end-to-end agreement, fp32: kernels vs plain versions ---
    model32 = build_module(cfg, "refcoco", dtype=torch.float32, device=dev)
    model32.load_state_dict(model.state_dict())
    srv32 = RefCOCOServer(model32, HashTokenizer(),
                          build_transforms(cfg, "test"), max_text=24,
                          max_boxes=16)
    batch = srv32.preprocess(*queries[3])
    with_kernels = srv32.infer(batch)["label_logits"][0]
    with plain_versions():
        plain = srv32.infer(batch)["label_logits"][0]
    n_live = int(batch[2].sum())
    e2e_err = float(np.abs(with_kernels - plain).max())
    top2 = np.sort(plain[:n_live])[-2:]
    if not (np.isfinite(with_kernels).all() and e2e_err <= E2E_ATOL
            and with_kernels.argmax() == plain.argmax()):
        raise AssertionError(f"fp32 end to end: max abs err {e2e_err} "
                             f"(atol {E2E_ATOL}), argmax "
                             f"{with_kernels.argmax()} vs {plain.argmax()}")
    print(f"[5 e2e fp32] kernels vs plain versions on one query with "
          f"{n_live} live boxes: max abs logit err {e2e_err:.3e} (atol "
          f"{E2E_ATOL}), argmax {int(plain.argmax())} on both, top-2 margin "
          f"{top2[1] - top2[0]:.3e}, logit spread "
          f"{plain[:n_live].std():.3e}", flush=True)

    # --- 6: training kernels at the VQA training shapes ---
    k5_errs, k5_mask, k5_ms = k5_parity(dev)
    print(f"[6 parity K5 dropout] max abs err {max(k5_errs.values())} over "
          f"{len(k5_errs)} cases ((shape, elements skipped before the "
          f"view) {list(K5_CASES)}; fp32, bf16; bits and Philox; forward "
          f"and backward; atol {K5_ATOL}); Philox keep masks equal the "
          f"plain Philox's bit for bit, backward replays them, keep fraction "
          f"{k5_mask['keep_fraction']:.6f} (1 - rate {1 - DROP_RATE}, sigma "
          f"{k5_mask['sigma']:.1e}), two seeds differ; bf16 [16,128,768] "
          f"device ms (call ms): kernel {k5_ms[0][0]:.4f} "
          f"({k5_ms[0][1]:.4f}), plain {k5_ms[1][0]:.4f} ({k5_ms[1][1]:.4f}) "
          f"({card})", flush=True)
    k34_errs, k3_mask, k3_ms, k4_ms, k4_split = k34_parity(dev)
    print(f"[6 parity K3/K4 attention dropout] H=12 D=64, q/k/v views of "
          f"one fused projection, 7 padded keys, one all-masked batch row, "
          f"B=16 L=128 and B=4 L=41, 173; fp32 on the CUDA cores, bf16 on "
          f"the tensor cores: K3 max abs err {k34_errs['K3']} (atol "
          f"{K3_ATOL}); K4 (dq, dk, dv, dbias) rel err {k34_errs['K4']} "
          f"(rtol {BWD_RTOL}); a bf16 K4 repeat is bit-identical; K2 "
          f"backward rel err {k34_errs['K2_bwd']}; K3 and K4 keep masks "
          f"read back in fp32 and bf16 equal the plain Philox's bit for bit "
          f"for two seeds, keep fraction {k3_mask['keep_fraction']:.6f} "
          f"(sigma {k3_mask['sigma']:.1e}); B=16 L=128 bf16 device ms (call "
          f"ms): K3 {k3_ms[0][0]:.4f} ({k3_ms[0][1]:.4f}) vs plain "
          f"{k3_ms[1][0]:.4f} ({k3_ms[1][1]:.4f}); K4 {k4_ms[0][0]:.4f} "
          f"({k4_ms[0][1]:.4f}) vs plain autograd {k4_ms[1][0]:.4f} "
          f"({k4_ms[1][1]:.4f}); K4 by kernel "
          f"{ {k[:48]: round(v, 5) for k, v in k4_split.items()} } "
          f"({card})", flush=True)

    lib = library_yardsticks(dev)
    philox4_instr, _ = philox_sass_instructions()
    int_rate, n_sm, sm_mhz = int_issue_per_s()
    print(f"[6 yardsticks] library calls, bf16, device ms (kernels): " +
          "; ".join(f"{k} {v[0]:.4f} ({', '.join(n[:48] for n in v[1])})"
                    for k, v in lib.items()) +
          f"; Philox4x32-10: {philox4_instr} SASS instructions per "
          f"evaluation of all four words (K3, K4, K5), integer issue "
          f"{int_rate / 1e12:.2f} T/s ({n_sm} SMs x "
          f"{INT_LANES_PER_SM} lanes x {sm_mhz:.0f} MHz) ({card})",
          flush=True)

    # --- 7: VQA fine-tuning at full width; 8: fp32 step agreement ---
    root = tempfile.mkdtemp(prefix="vqa_fixture_")
    try:
        cfg7, overrides = vqa_train_config(root)
        print(f"[7 train] {VQA_CFG} with overrides "
              f"{json.dumps(overrides)}", flush=True)
        model7, hist, train_launches = train_phase(cfg7)
        steps = len(hist["loss"])
        step_ms = sorted(hist["step_ms"][2:])
        p50 = step_ms[len(step_ms) // 2]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall_ms, busy_ms, top = profile_steps(model7, cfg7)
        print(f"[7 train] {steps} steps of batch 16, loss "
              f"{hist['loss'][0]:.2f} -> {hist['loss'][-1]:.2f} (first 4 "
              f"{sum(hist['loss'][:4]) / 4:.2f}, last 4 "
              f"{sum(hist['loss'][-4:]) / 4:.2f}); val SoftAcc "
              f"{[round(v['SoftAcc'], 4) for v in hist['val']]}; launches "
              f"{train_launches} = per step K3 12, K4 12, K5 27 fwd / 26 "
              f"bwd, K2 12 per val batch; step p50 {p50:.2f} ms (CUDA "
              f"events, steps 3..{steps}), {16e3 / p50:.1f} samples/s; peak "
              f"device memory {peak:.2f} GiB; profiled window: wall "
              f"{wall_ms:.2f} ms/step unprofiled, device busy "
              f"{busy_ms:.2f} ms/step, idle share "
              f"{1 - busy_ms / wall_ms:.3f}; top device time ms/step "
              f"{[(k, round(v, 3)) for k, v in top]} ({card})", flush=True)
        del model7
        torch.cuda.empty_cache()
        agree = step_agreement(cfg7, dev)
        print(f"[8 step fp32] kernels vs plain versions, one step from the "
              f"same weights and seed: loss {agree['loss'][0]:.6f} vs "
              f"{agree['loss'][1]:.6f}, grad norm {agree['grad_norm'][0]:.6f} "
              f"vs {agree['grad_norm'][1]:.6f}, (rel err, rtol) "
              f"{agree['checks']}, worst of {agree['n_leaves']} gradient "
              f"leaves {agree['worst_leaf']}; launches kernels "
              f"{agree['launches'][0]}, plain {agree['launches'][1]}; max "
              f"abs param diff {agree['max_param_diff']:.3e} at lr "
              f"{agree['lr']:.3e}; a repeat of the kernel step is "
              f"bit-identical", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def philox_floor_ms(evaluations, instructions):
        return evaluations * instructions / int_rate * 1e3

    B, L, H, D = 16, 128, 12, 64
    n_drop = 16 * 128 * 768            # K5's timed [16,128,768] tensor
    k1_bf16 = k1_bound(1, 38, 63, 1024, 16, 2, 2)
    k1_fp32 = k1_bound(1, 38, 63, 1024, 16, 2, 4)
    k1_note = "no single PyTorch call: torchvision is not installed"
    k1_main, k1_f32, k1_old = (k1_t[k] for k in ("bf16_out", "fp32_out",
                                                  "old_route"))
    kernels = [
        {"name": "roi_align_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/roi_align.cu",
         "replaces": "vlbert_tpu/ops/roi_align.py:125",
         "launches": launches["roi_align"],
         "max_abs_err": k1_fp32_err, "bf16_out_max_abs_err": k1_bf16_err,
         "out_dtype": "bfloat16", "ms": k1_main["ms"],
         "plain_ms": k1_t["plain"][0], "bound_ms": k1_bf16[0],
         "bound_by": k1_bf16[1], "library_ms": None,
         "library_note": k1_note, "call_ms": k1_main["call_ms"],
         "kernels_per_call": k1_main["kernels_per_call"],
         "plain_call_ms": k1_t["plain"][1],
         "fp32_out": {"ms": k1_f32["ms"], "call_ms": k1_f32["call_ms"],
                      "kernels_per_call": k1_f32["kernels_per_call"],
                      "bound_ms": k1_fp32[0], "bound_by": k1_fp32[1]},
         "replaced_route": {
             "ms": k1_old["route_ms"], "call_ms": k1_old["call_ms"],
             "kernels_per_call": k1_old["kernels_per_call"],
             "by_kernel": k1_old["by_kernel"],
             "note": "the three ops the main path ran before this K1 "
                     "stored the compute dtype (bool mask to uint8, fp32-out "
                     "K1, cast to bf16), timed in this run with this K1"}},
        {"name": "attention_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention_dropout_mma.cu",
         "fp32_source": "vlbert_tpu_torch/csrc/attention.cu",
         "replaces": "vlbert_tpu/ops/attention.py:127",
         "launches": launches["fused_attention"],
         "max_abs_err": max(k2_errs.values()), "ms": k2_ms[41][0][0],
         "plain_ms": k2_ms[41][1][0],
         **dict(zip(("bound_ms", "bound_by"),
                    attention_bound(1, 41, H, D, "bfloat16"))),
         "library_ms": lib["K2_L41"][0], "library_kernels": lib["K2_L41"][1],
         "call_ms": k2_ms[41][0][1], "plain_call_ms": k2_ms[41][1][1],
         "at_B16_L128": {
             "ms": k2_ms[128][0][0], "plain_ms": k2_ms[128][1][0],
             **dict(zip(("bound_ms", "bound_by"),
                        attention_bound(B, L, H, D, "bfloat16"))),
             "library_ms": lib["K2_L128"][0],
             "library_kernels": lib["K2_L128"][1],
             "call_ms": k2_ms[128][0][1],
             "plain_call_ms": k2_ms[128][1][1]}},
        {"name": "dropout", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/dropout.cu",
         "replaces": "vlbert_tpu/ops/dropout.py:83",
         "launches": train_launches["K5_fwd"],
         "bwd_launches": train_launches["K5_bwd"],
         "max_abs_err": max(k5_errs.values()), "ms": k5_ms[0][0],
         "plain_ms": k5_ms[1][0],
         **dict(zip(("bound_ms", "bound_by"),
                    roofline(2 * n_drop * 2, n_drop, "bfloat16"))),
         "philox_floor_ms": philox_floor_ms(PHILOX_PER_CALL["K5"](n_drop),
                                            philox4_instr),
         "library_ms": lib["K5"][0], "library_kernels": lib["K5"][1],
         "call_ms": k5_ms[0][1], "plain_call_ms": k5_ms[1][1]},
        {"name": "attention_dropout_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention_dropout_mma.cu",
         "fp32_source": "vlbert_tpu_torch/csrc/attention_dropout.cu",
         "replaces": "vlbert_tpu/ops/attention.py:300",
         "launches": train_launches["K3"],
         "max_abs_err": max(k34_errs["K3"].values()), "ms": k3_ms[0][0],
         "plain_ms": k3_ms[1][0],
         **dict(zip(("bound_ms", "bound_by"),
                    attention_bound(B, L, H, D, "bfloat16"))),
         "philox_floor_ms": philox_floor_ms(
             PHILOX_PER_CALL["K3"](B, H, L), philox4_instr),
         "library_ms": lib["K3"][0], "library_kernels": lib["K3"][1],
         "call_ms": k3_ms[0][1], "plain_call_ms": k3_ms[1][1]},
        {"name": "attention_dropout_bwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention_dropout_mma.cu",
         "fp32_source": "vlbert_tpu_torch/csrc/attention_dropout.cu",
         "replaces": "vlbert_tpu/ops/attention.py:326",
         "launches": train_launches["K4"],
         "max_abs_err": max(k34_errs["K4"].values()),
         "err_is_relative_to": "max(1, max |plain|)", "ms": k4_ms[0][0],
         "plain_ms": k4_ms[1][0],
         **dict(zip(("bound_ms", "bound_by"),
                    attention_bound(B, L, H, D, "bfloat16", backward=True))),
         "philox_floor_ms": philox_floor_ms(
             PHILOX_PER_CALL["K4"](B, H, L), philox4_instr),
         "library_ms": lib["K4"][0], "library_kernels": lib["K4"][1],
         "per_kernel_ms": k4_split, "call_ms": k4_ms[0][1],
         "plain_call_ms": k4_ms[1][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def descendants(pid):
    """Pids of every live process below ``pid``, from /proc."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:                 # ended while we looked
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z":            # zombies have already ended
            children.setdefault(int(fields[1]), []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        for c in children.get(todo.pop(), ()):
            found.append(c)
            todo.append(c)
    return found


def stop_child_processes():
    """Stop every process this run started that still runs. The loader's
    worker pools are shut down where they are used, but the forkserver
    that forked their workers and multiprocessing's resource tracker stay
    up until the interpreter exits; stop both and wait for them, then kill
    and reap any other descendant. Returns the pids that had to be
    killed."""
    import multiprocessing.forkserver as forkserver
    import multiprocessing.resource_tracker as resource_tracker
    import signal

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    left = descendants(os.getpid())
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    for pid in left:
        with contextlib.suppress(ChildProcessError):   # not our child
            os.waitpid(pid, 0)
    return left


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        killed = stop_child_processes()
        if killed:
            print(f"chip_smoke: killed leftover processes {killed}",
                  file=sys.stderr)
    sys.exit(rc)
