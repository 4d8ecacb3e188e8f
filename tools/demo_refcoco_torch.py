#!/usr/bin/env python
"""RefCOCO+ single-image grounding demo on the PyTorch + CUDA port
(vlbert_tpu_torch); the counterpart of tools/demo_refcoco.py.

Runs the full end-to-end serving path on one synthetic image: eval
transform (Resize/Normalize/FixPadding), ResNet-101 + ROIAlign backbone,
[CLS] expr [SEP] text, per-candidate grounding logits, argmax box in
original coords. Weights are random, made from a seed, at the config's real
size (pass --tiny for a seconds-fast CPU check), or --ckpt's:

    python tools/demo_refcoco_torch.py --tiny --device cpu    # smoke check
    python tools/demo_refcoco_torch.py --device cuda          # base size
    python tools/demo_refcoco_torch.py --ckpt <.model>        # e.g. a TPU
                                                              # run's msgpack

Prints one JSON object: predicted box (original coords), per-candidate
scores, and single-query latency.
"""

import argparse
import json
import os
import sys
import time
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


class _DemoTok:
    """Hash tokenizer for random-weight demos (no vocab download)."""

    cls_id, sep_id, mask_id = 2, 3, 4

    def tokenize(self, text):
        return text.lower().split()

    def convert_tokens_to_ids(self, toks):
        return [zlib.crc32(t.encode()) % 20000 + 10 for t in toks]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=os.path.join(
        REPO, "cfgs/refcoco/base_gt_boxes_4x16G.yaml"))
    ap.add_argument("--expr", default="the large object on the left")
    ap.add_argument("--tiny", action="store_true",
                    help="1-layer/32-hidden model + small image: CPU smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda, cuda:1 or cpu")
    ap.add_argument("--ckpt", default="",
                    help="weights to load instead of random ones: a "
                         "reference or port .model, the JAX package's "
                         "msgpack checkpoint or an .npz (the real vocab "
                         "of NETWORK.BERT_MODEL_NAME tokenizes then)")
    args = ap.parse_args()

    import torch

    from vlbert_tpu_torch.data.transforms import build_transforms
    from vlbert_tpu_torch.engine.serve import RefCOCOServer
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.utils.config import load_config

    device = torch.device(args.device)
    cfg = load_config("refcoco", args.cfg)
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False
    if args.tiny:
        v = cfg.NETWORK.VLBERT
        v.hidden_size = 32; v.visual_size = 32; v.num_hidden_layers = 1
        v.num_attention_heads = 2; v.intermediate_size = 64
        cfg.NETWORK.IMAGE_FINAL_DIM = 32
        cfg.NETWORK.IMAGE_NUM_LAYERS = 50
        cfg.SCALES = (64, 96)

    rng = np.random.default_rng(0)
    hw = (120, 160) if args.tiny else (480, 640)
    image = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    h0, w0 = image.shape[:2]
    boxes = np.stack([
        np.asarray([w0 * .05, h0 * .1, w0 * .45, h0 * .8], np.float32),
        np.asarray([w0 * .5, h0 * .15, w0 * .95, h0 * .85], np.float32),
        np.asarray([w0 * .3, h0 * .3, w0 * .7, h0 * .7], np.float32)])

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = build_module(cfg, "refcoco", dtype=dtype, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(0))
    tok, loaded = _DemoTok(), None
    if args.ckpt:  # the test driver's loader; real weights, real vocab
        from vlbert_tpu_torch.data.tokenization import BertTokenizer
        from vlbert_tpu_torch.engine.test import _load_params

        tok = BertTokenizer.from_pretrained(cfg.NETWORK.BERT_MODEL_NAME)
        loaded = len(_load_params(model, args.ckpt))
    srv = RefCOCOServer(model, tok,
                        transform=build_transforms(cfg, "test"),
                        max_text=24, max_boxes=len(boxes) + 1)

    t0 = time.perf_counter()
    r = srv.query(image, boxes, args.expr)       # includes kernel build
    first_call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = srv.query(image, boxes, args.expr)
    query_s = time.perf_counter() - t0

    print(json.dumps({
        "expr": args.expr,
        "image_hw": [h0, w0],
        "pred_box_xyxy": [round(float(x), 2) for x in r["box"]],
        "best_candidate": r["best_index"],
        "candidate_scores": [round(float(s), 4)
                             for s in r["candidate_scores"]],
        "latency_ms": round(query_s * 1e3, 2),
        "first_call_ms": round(first_call_s * 1e3, 1),
        "weights": args.ckpt or "random-init",
        "loaded_tensors": loaded,
        "backend": str(device),
    }, indent=1))


if __name__ == "__main__":
    main()
