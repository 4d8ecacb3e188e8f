"""Weight-only int8 accuracy of the PyTorch + CUDA port at base scale.

The port's counterpart of tools/int8_accuracy.py: the VQA head (768 x 12
x 30522, precomputed features, 3129 answers) and the RefCOCO+ head (the
same encoder from pixels through ResNet-50 and ROIAlign), on random
weights from a seed, fp32 compute, with fp32 weights and with the same
weights quantized per output channel to int8 (``vlbert_tpu_torch/ops/
quant.py``, ``min_size`` 4096). For each head it reports the max and mean
|logit delta|, the logit std, the smallest top-2 margin, the argmax flips
and those beyond the 2 delta margin bound (a flip where the fp32 top-2
margin exceeds twice the sample's largest delta: a tie closer than that
can flip under any perturbation of the measured size, and says nothing
about int8), and the weight bytes, int8 against fp32. It bounds the logit
perturbation on the real-size compute graph; accuracy on real data needs
trained checkpoints and datasets, which the repo has not.

    python tools/int8_accuracy_torch.py [--B 8] [--seed 0] [--device cpu]
        [--tiny]

Prints one JSON line, with the card's name and power limit (nvidia-smi)
on a card. Runs on ``cuda`` unless ``--device cpu`` is given; ``--tiny``
cuts the encoder to 2 layers of 32 (``min_size`` 512) for a CPU rehearsal.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _cfg(task, tiny):
    from vlbert_tpu_torch.utils.config import default_config

    cfg = default_config(task)
    cfg.MODULE = "ResNetVLBERT"
    v = cfg.NETWORK.VLBERT
    width, layers, heads = (32, 2, 2) if tiny else (768, 12, 12)
    v.hidden_size = v.visual_size = width
    v.num_hidden_layers = layers
    v.num_attention_heads = heads
    v.intermediate_size = 4 * width
    v.vocab_size = 30522
    v.max_position_embeddings = 512
    v.visual_ln = True
    v.visual_scale_text_init = v.visual_scale_object_init = 1.0
    v.hidden_dropout_prob = v.attention_probs_dropout_prob = 0.0
    cfg.NETWORK.IMAGE_FINAL_DIM = width
    cfg.NETWORK.CLASSIFIER_HIDDEN_SIZE = width
    cfg.NETWORK.CLASSIFIER_DROPOUT = 0.0
    cfg.NETWORK.IMAGE_SEMANTIC = False
    if task == "vqa":
        cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = True
        cfg.DATASET.ANSWER_VOCAB_SIZE = 3129
    else:
        cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False
        cfg.NETWORK.IMAGE_NUM_LAYERS = 50
        cfg.NETWORK.ENABLE_CNN_REG_LOSS = False
    return cfg


def _vqa_batch(rng, B, O=36, T=32, F=2048):
    """tools/int8_accuracy.py's VQA batch."""
    boxes = np.full((B, O, 4 + F), -2.0, np.float32)
    boxes[..., 0] = rng.uniform(0, 400, (B, O))
    boxes[..., 1] = rng.uniform(0, 300, (B, O))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(16, 200, (B, O))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(16, 200, (B, O))
    boxes[..., 4:] = rng.normal(size=(B, O, F)).astype(np.float32)
    ids = np.asarray(rng.integers(105, 30000, (B, T)), np.int64)
    tmask = np.broadcast_to(np.arange(T)[None] < 16, (B, T)).copy()
    return (None, boxes, np.ones((B, O), bool),
            np.asarray([[640, 480, 1, 1]] * B, np.float32), ids * tmask,
            np.zeros((B, T), np.int64), tmask, np.full((B,), 14, np.int64))


def _refcoco_batch(rng, B, O=8, T=16, IMG=64):
    """tools/int8_accuracy.py's RefCOCO+ batch: normalized float images."""
    image = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    boxes = np.zeros((B, O, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, IMG // 2, (B, O))
    boxes[..., 1] = rng.uniform(0, IMG // 2, (B, O))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(8, IMG // 2, (B, O))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(8, IMG // 2, (B, O))
    ids = np.asarray(rng.integers(105, 30000, (B, T)), np.int64)
    tmask = np.broadcast_to(np.arange(T)[None] < 10, (B, T)).copy()
    return (image, boxes, np.ones((B, O), bool),
            np.asarray([[IMG, IMG, 1, 1]] * B, np.float32), ids * tmask,
            tmask)


def compare(model, batch, min_size):
    """fp32-weight logits against int8-weight logits of a copy of
    ``model`` on the same batch (a tuple of device tensors)."""
    from vlbert_tpu_torch.ops.quant import quantize_module, quantized_bytes

    qmodel = copy.deepcopy(model)
    quantize_module(qmodel, min_size)
    with torch.inference_mode():
        full = model(*batch)["label_logits"].float().cpu().numpy()
        q = qmodel(*batch)["label_logits"].float().cpu().numpy()
    delta = np.abs(q - full)
    top2 = np.sort(full, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    flipped = np.argmax(q, -1) != np.argmax(full, -1)
    unsafe = flipped & (margin > 2.0 * delta.max(-1))
    acct = quantized_bytes(qmodel)
    return {"n_samples": int(full.shape[0]),
            "n_classes": int(full.shape[-1]),
            "max_abs_logit_delta": float(delta.max()),
            "mean_abs_logit_delta": float(delta.mean()),
            "logit_std": float(full.std()),
            "min_top2_margin": float(margin.min()),
            "argmax_flips": int(flipped.sum()),
            "argmax_flips_beyond_margin": int(unsafe.sum()),
            "quantized_bytes": acct["quantized_bytes"],
            "fp32_bytes": acct["fp32_bytes"]}


def measure(task, B=8, seed=0, device="cuda", tiny=False):
    """The numbers of one head (``task`` "vqa" or "refcoco")."""
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    batch = (_vqa_batch if task == "vqa" else _refcoco_batch)(rng, B)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the ignored TPU.* knobs
        model = build_module(_cfg(task, tiny), task, dtype=torch.float32,
                             device=device).eval()
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    tensors = tuple(None if a is None else torch.from_numpy(a).to(device)
                    for a in batch)
    r = compare(model, tensors, 512 if tiny else 4096)
    r["task"] = task
    return r


def card_name():
    """'<name>, <power limit>' of card 0 from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--B", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--tiny", action="store_true")
    args = parser.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda is not "
                           "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": args.device,
           "card": card_name() if args.device.startswith("cuda") else None,
           "tiny": args.tiny}
    for task in ("vqa", "refcoco"):
        out[task] = measure(task, args.B, args.seed, args.device, args.tiny)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
