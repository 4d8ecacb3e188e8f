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
     kernels and with their plain versions.

Any failure raises. The last three lines are the kernels' JSON record, the
nvidia-smi line, and {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import sys
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
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.device_time for e in prof.events()
                 if e.device_type.name == "CUDA")
    if dev_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return dev_us / 1e3 / iters, call_ms


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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vlbert_tpu.data.transforms import build_transforms
    from vlbert_tpu.utils.config import load_config
    from vlbert_tpu_torch.engine.serve import RefCOCOServer
    from vlbert_tpu_torch.kernels import build
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.ops.attention import fused_attention
    from vlbert_tpu_torch.ops.roi_align import roi_align

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
