#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (vlbert_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (built and checked for an NVIDIA H100) and the CUDA
toolkit (``nvcc``); exits non-zero without a card. Phases, each printing
its own line:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the kernels from vlbert_tpu_torch/csrc at first use;
  3. kernel parity: ROIAlign (K1) and attention (K2) against their plain
     PyTorch versions at the serve shapes, with device times (profiler)
     and per-call CUDA-event times for both;
  4. serve: ResNetVLBERTForRefCOCO from cfgs/refcoco/base_gt_boxes_4x16G.yaml
     at full width (ResNet-101, VL-BERT 768 x 12 layers x 12 heads, vocab
     30522), random weights from a fixed seed, bf16 compute, behind the
     port's RefCOCOServer; answers 8 distinct queries and checks that each
     launched K1 once and K2 twelve times;
  5. end-to-end agreement: the same weights in fp32, one query, with the
     kernels and with their plain versions;
  6. training-kernel parity at the VQA training shapes, fp32 and bf16:
     dropout (K5) forward and backward, attention with prob dropout
     forward (K3) and backward (K4), and K2's backward, each against its
     plain version in explicit-bits mode; in Philox mode the kernels' keep
     masks are read back exactly and must equal the plain Philox's bit for
     bit, the backward must replay the forward's mask, the keep fraction
     must lie within 5 sigma of 1 - rate and two seeds must differ;
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

Any failure raises. The last three lines are the kernels' JSON record, the
nvidia-smi line, and {"ok": true, "device": {...}}. Kernel launches made
to compare a kernel with its plain version are not counted: each path's
counts are set to 0 just before it runs.
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
# |out| ~ 1 is 2**-7 ~ 8e-3)
K1_ATOL = 1e-4
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


class HashTokenizer:
    """Deterministic hash tokenizer for random-weight runs (no vocab)."""

    cls_id, sep_id, mask_id = 101, 102, 103

    def tokenize(self, text):
        return text.lower().split()

    def convert_tokens_to_ids(self, toks):
        return [zlib.crc32(t.encode()) % 29000 + 1000 for t in toks]


def cuda_ms(fn, iters=50, warmup=5):
    """(device ms, call ms) per call of ``fn``.

    device ms: the summed device time of every kernel and copy that one
    call runs, from a torch.profiler trace of ``iters`` calls. call ms: the
    CUDA-event time per call of back-to-back calls, which includes the
    host's launch overhead wherever the host is slower than the device.
    """
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
    call_ms = start.elapsed_time(end) / iters
    dev_us = sum(device_us_by_name(fn, iters).values())
    return dev_us / 1e3 / iters, call_ms


def device_us_by_name(fn, iters):
    """{kernel name: summed device µs} over ``iters`` calls of ``fn`` in a
    torch.profiler window. The profiler now and then returns a window
    without device events; such a window is measured again, up to three
    times in all."""
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
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        if sum(by_name.values()) > 0:
            return by_name
    raise AssertionError("the profiler recorded no device time in three "
                         "windows")


def k1_parity(dev):
    """ROIAlign kernel vs plain at the serve shape: body4 [1,38,63,1024]
    (a 600x1000 canvas at stride 16), 16 box slots."""
    import torch
    from vlbert_tpu_torch.ops.roi_align import roi_align, roi_align_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    feat = torch.randn(1, 38, 63, 1024, generator=g, device=dev)
    boxes = torch.tensor([[
        [0, 0, 999, 599],          # the whole canvas
        [10, 20, 300, 400],
        [900, 500, 1100, 700],     # crosses the right and bottom edges
        [-50, -50, -20, -10],      # entirely outside
        [30, 40, 30.5, 40.2],      # smaller than 1x1 on the map
        [990, 590, 1000, 600],     # on the map's far corner
        [0, 0, 8, 8],
        [500, 100, 700, 599],
        [-10, -10, 1010, 610],     # exceeds the map on every side
        [100, 100, 101, 130],
        [1000, 600, 1040, 640],    # starts at the map's far edge
        [5, 5, 995, 15],
        [200, 200, 600, 500],
        [0, 580, 999, 599],        # a strip along the bottom edge
        [0, 0, 0, 0], [0, 0, 0, 0]]], device=dev)
    mask = torch.ones(1, 16, dtype=torch.bool, device=dev)
    mask[0, 14:] = False                                  # padded slots
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        f = feat.to(dtype)
        for sr in (1, 0):
            a = roi_align(f, boxes, mask, sampling_ratio=sr)
            b = roi_align_plain(f, boxes, mask, sampling_ratio=sr)
            torch.cuda.synchronize()
            err = (a - b).abs().max().item()
            if not (err <= K1_ATOL and torch.all(a[~mask] == 0)):
                raise AssertionError(f"K1 {dtype} sampling_ratio={sr}: max "
                                     f"abs err {err} > {K1_ATOL}")
            errs[f"{str(dtype)[6:]}/sr{sr}"] = err
    f = feat.to(torch.bfloat16)    # the serve path's body4 is bf16
    ms = cuda_ms(lambda: roi_align(f, boxes, mask, sampling_ratio=1))
    plain_ms = cuda_ms(lambda: roi_align_plain(f, boxes, mask,
                                               sampling_ratio=1))
    return errs, ms, plain_ms


def k2_parity(dev):
    """Attention kernel vs plain at the serve shapes: B=1, H=12, D=64,
    L = 41 (24 text + 16 boxes + END) and 173 (the largest shipped bucket),
    5 keys masked; q, k, v are strided views of one fused projection."""
    import torch
    from vlbert_tpu_torch.ops.attention import fused_attention, plain_attention

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    errs, timing = {}, {}
    for L in (41, 173):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(1, L, 3 * 768, generator=g, device=dev)
            q, k, v = (t.view(1, L, 12, 64) for t in qkv.to(dtype).split(
                768, dim=-1))
            m = torch.ones(1, L, device=dev)
            m[0, -5:] = 0
            bias = ((1.0 - m) * -10000.0)[:, None, None, :].contiguous()
            a = fused_attention(q, k, v, bias)
            b = plain_attention(q, k, v, bias)
            torch.cuda.synchronize()
            err = (a.float() - b.float()).abs().max().item()
            tol = K2_ATOL[str(dtype)[6:]]
            if not err <= tol:
                raise AssertionError(f"K2 L={L} {dtype}: max abs err {err} "
                                     f"> {tol}")
            errs[f"L{L}/{str(dtype)[6:]}"] = err
            if dtype == torch.bfloat16:
                timing[L] = (cuda_ms(lambda: fused_attention(q, k, v, bias)),
                             cuda_ms(lambda: plain_attention(q, k, v, bias)))
    return errs, timing


def _maxerr(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel_err(a, b):
    """max |a - b| / max(1, max |b|)."""
    return _maxerr(a, b) / max(1.0, b.float().abs().max().item())


def k5_parity(dev):
    """Dropout kernel vs plain at the training shapes, both modes, forward
    and backward; Philox masks bit for bit; timing at [16,128,768] bf16."""
    import torch
    from vlbert_tpu_torch.ops.dropout import (flat_index_bits, hw_dropout,
                                              keep_mask, plain_dropout)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {}
    for shape in ((16, 128, 768), (16, 95, 4096), (16, 768)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype) \
                .requires_grad_()
            gy = torch.randn(shape, generator=g, device=dev).to(dtype)
            bits = torch.randint(0, 65536, shape, generator=g, device=dev,
                                 dtype=torch.int32)
            for mode, kw in (("bits", dict(bits=bits)),
                             ("philox", dict(seed=SEED + 11))):
                a = hw_dropout(x, DROP_RATE, **kw)
                (da,) = torch.autograd.grad(a, x, gy)
                b = plain_dropout(x, DROP_RATE, **kw)
                (db,) = torch.autograd.grad(b, x, gy)
                err = max(_maxerr(a, b), _maxerr(da, db))
                key = f"{'x'.join(map(str, shape))}/{str(dtype)[6:]}/{mode}"
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
    key masked."""
    import torch

    qkv = torch.randn(B, L, 3 * 768, generator=g, device=dev).to(dtype) \
        .requires_grad_()
    q, k, v = qkv.view(B, L, 3, 12, 64).unbind(2)
    m = torch.ones(B, L, device=dev)
    m[:, -7:] = 0
    m[1] = 0
    bias = ((1.0 - m) * -10000.0)[:, None, None, :].contiguous() \
        .requires_grad_()
    return qkv, (q, k, v), bias


def _attention_masks(dev, seed, B=16, H=12, L=128, D=64):
    """K3's and K4's keep masks [B, H, L, L], read back exactly: with
    q = k = 0 and bias 0 every prob is 1/L; v (and for K4 the cotangent g)
    encodes key (query) j as 2**(j % 16) in dim j // 16, so each output
    (dv) element is drop_scale / L times a 16-bit word of the mask."""
    import torch
    from vlbert_tpu_torch.ops.attention import fused_attention_dropout

    j = torch.arange(L, device=dev)
    enc = torch.zeros(L, D, device=dev)
    enc[j, j // 16] = (2.0 ** (j % 16)).float()
    enc = enc[None, :, None, :].expand(B, L, H, D).contiguous()
    z = torch.zeros(B, L, H, D, device=dev)
    v = enc.clone().requires_grad_()
    out = fused_attention_dropout(z, z, v, torch.zeros(B, 1, 1, L,
                                                       device=dev),
                                  DROP_RATE, seed=seed)
    (dv,) = torch.autograd.grad(out, v, enc)
    f = L * (1.0 - DROP_RATE)
    shifts = torch.arange(16, device=dev)

    def unpack(words):            # [B, X, H, D] -> [B, H, X, L]
        w = torch.round(words.double() * f).long()[..., :L // 16]
        bits = (w.permute(0, 2, 1, 3)[..., None] >> shifts) & 1
        return bits.reshape(B, H, L, L).bool()

    return unpack(out), unpack(dv).transpose(2, 3)


def k34_parity(dev):
    """K3/K4 vs plain at B=16 H=12 L=128 D=64, explicit bits and Philox;
    masks read back bit for bit; K2's backward; timings in bf16."""
    import torch
    from vlbert_tpu_torch.ops.attention import (
        attention_bits, fused_attention, fused_attention_dropout,
        plain_attention, plain_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import keep_mask

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = {"K3": {}, "K4": {}, "K2_bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        qkv, (q, k, v), bias = _train_qkv(g, dev, dtype)
        gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        bits = torch.randint(0, 65536, (16, 12, 128, 128), generator=g,
                             device=dev, dtype=torch.int32)
        for mode, kw in (("bits", dict(bits=bits)),
                         ("philox", dict(seed=SEED + 12))):
            a = fused_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
            ga = torch.autograd.grad(a, (qkv, bias), gy)
            b = plain_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
            gb = torch.autograd.grad(b, (qkv, bias), gy)
            e3 = _maxerr(a, b)
            e4 = max(_rel_err(x, y) for x, y in zip(ga, gb))
            if not (e3 <= K3_ATOL[dn] and e4 <= BWD_RTOL[dn]):
                raise AssertionError(f"K3/K4 {dn} {mode}: out err {e3} "
                                     f"(atol {K3_ATOL[dn]}), grad rel err "
                                     f"{e4} (rtol {BWD_RTOL[dn]})")
            errs["K3"][f"{dn}/{mode}"] = e3
            errs["K4"][f"{dn}/{mode}"] = e4
        a = fused_attention(q, k, v, bias)
        ga = torch.autograd.grad(a, (qkv, bias), gy)
        gb = torch.autograd.grad(plain_attention(q, k, v, bias), (qkv, bias),
                                 gy)
        e2 = max(_rel_err(x, y) for x, y in zip(ga, gb))
        if not e2 <= BWD_RTOL[dn]:
            raise AssertionError(f"K2 backward {dn}: rel err {e2}")
        errs["K2_bwd"][dn] = e2

    fwd_masks = []
    for seed in (SEED + 31, SEED + 32):
        fwd, bwd = _attention_masks(dev, seed)
        want = keep_mask(attention_bits(16, 12, 128, seed, dev), DROP_RATE,
                         False)
        if not (torch.equal(fwd, want) and torch.equal(bwd, want)):
            raise AssertionError(
                f"K3/K4 seed {seed}: mismatched keep bits fwd "
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
    return errs, {"keep_fraction": frac, "sigma": sigma}, k3, k4


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
    k1_errs, k1_ms, k1_plain_ms = k1_parity(dev)
    print(f"[3 parity K1 roi_align] max abs err {k1_errs} (atol {K1_ATOL}); "
          f"bf16 body4 [1,38,63,1024], 16 boxes, sampling 1, device ms "
          f"(call ms): kernel {k1_ms[0]:.4f} ({k1_ms[1]:.4f}), plain "
          f"{k1_plain_ms[0]:.4f} ({k1_plain_ms[1]:.4f}) ({card})",
          flush=True)
    k2_errs, k2_ms = k2_parity(dev)
    print(f"[3 parity K2 attention] max abs err {k2_errs} (atol "
          f"{K2_ATOL}); bf16 B=1 H=12 D=64, device ms (call ms): " +
          ", ".join(f"L={L} kernel {a[0]:.4f} ({a[1]:.4f}), plain "
                    f"{b[0]:.4f} ({b[1]:.4f})"
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
          f"{len(k5_errs)} cases (shapes [16,128,768], [16,95,4096], "
          f"[16,768]; fp32, bf16; bits and Philox; forward and backward; "
          f"atol {K5_ATOL}); Philox keep masks equal the plain Philox's bit "
          f"for bit, backward replays them, keep fraction "
          f"{k5_mask['keep_fraction']:.6f} (1 - rate {1 - DROP_RATE}, sigma "
          f"{k5_mask['sigma']:.1e}), two seeds differ; bf16 [16,128,768] "
          f"device ms (call ms): kernel {k5_ms[0][0]:.4f} "
          f"({k5_ms[0][1]:.4f}), plain {k5_ms[1][0]:.4f} ({k5_ms[1][1]:.4f}) "
          f"({card})", flush=True)
    k34_errs, k3_mask, k3_ms, k4_ms = k34_parity(dev)
    print(f"[6 parity K3/K4 attention dropout] B=16 H=12 L=128 D=64, q/k/v "
          f"views of one fused projection, 7 padded keys, one all-masked "
          f"row: K3 max abs err {k34_errs['K3']} (atol {K3_ATOL}); K4 "
          f"(dq, dk, dv, dbias) rel err {k34_errs['K4']} (rtol {BWD_RTOL}); "
          f"K2 backward rel err {k34_errs['K2_bwd']}; K3 and K4 keep masks "
          f"read back equal the plain Philox's bit for bit for two seeds, "
          f"keep fraction {k3_mask['keep_fraction']:.6f} (sigma "
          f"{k3_mask['sigma']:.1e}); bf16 device ms (call ms): K3 "
          f"{k3_ms[0][0]:.4f} ({k3_ms[0][1]:.4f}) vs plain "
          f"{k3_ms[1][0]:.4f} ({k3_ms[1][1]:.4f}); K4 {k4_ms[0][0]:.4f} "
          f"({k4_ms[0][1]:.4f}) vs plain autograd {k4_ms[1][0]:.4f} "
          f"({k4_ms[1][1]:.4f}) ({card})", flush=True)

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

    kernels = [
        {"name": "roi_align_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/roi_align.cu",
         "replaces": "vlbert_tpu/ops/roi_align.py:125",
         "launches": launches["roi_align"],
         "max_abs_err": max(k1_errs.values()), "ms": k1_ms[0],
         "plain_ms": k1_plain_ms[0], "call_ms": k1_ms[1],
         "plain_call_ms": k1_plain_ms[1]},
        {"name": "attention_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention.cu",
         "replaces": "vlbert_tpu/ops/attention.py:127",
         "launches": launches["fused_attention"],
         "max_abs_err": max(k2_errs.values()), "ms": k2_ms[41][0][0],
         "plain_ms": k2_ms[41][1][0], "call_ms": k2_ms[41][0][1],
         "plain_call_ms": k2_ms[41][1][1]},
        {"name": "dropout", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/dropout.cu",
         "replaces": "vlbert_tpu/ops/dropout.py:83",
         "launches": train_launches["K5_fwd"],
         "bwd_launches": train_launches["K5_bwd"],
         "max_abs_err": max(k5_errs.values()), "ms": k5_ms[0][0],
         "plain_ms": k5_ms[1][0], "call_ms": k5_ms[0][1],
         "plain_call_ms": k5_ms[1][1]},
        {"name": "attention_dropout_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention_dropout.cu",
         "replaces": "vlbert_tpu/ops/attention.py:300",
         "launches": train_launches["K3"],
         "max_abs_err": max(k34_errs["K3"].values()), "ms": k3_ms[0][0],
         "plain_ms": k3_ms[1][0], "call_ms": k3_ms[0][1],
         "plain_call_ms": k3_ms[1][1]},
        {"name": "attention_dropout_bwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention_dropout.cu",
         "replaces": "vlbert_tpu/ops/attention.py:326",
         "launches": train_launches["K4"],
         "max_abs_err": max(k34_errs["K4"].values()),
         "err_is_relative_to": "max(1, max |plain|)", "ms": k4_ms[0][0],
         "plain_ms": k4_ms[1][0], "call_ms": k4_ms[0][1],
         "plain_call_ms": k4_ms[1][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
