"""VCR paired-model validation: Q->A, QA->R and the joint Q->AR (port of
the root ``vcr/val.py``).

    python -m vlbert_tpu_torch.engine.vcr_val --a-cfg <q2a yaml> \\
        --r-cfg <qa2r yaml> --a-ckpt <path> --r-ckpt <path> \\
        [--cache-dir D] [--device cpu]

ref: vcr/val.py:69-210. A Q2A model and a QA2R model, each from its own
config and checkpoint, score the val split through the test driver's
inference loop (``engine/test.py::run_inference``); their logits can be
cached as ``a_pred.npy`` / ``r_pred.npy`` under ``--cache-dir`` and are
read back from there when present. Q->AR counts a question right when
both models are.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from vlbert_tpu_torch.data.io_utils import load_jsonl
from vlbert_tpu_torch.engine.test import run_inference


def predict(config, ckpt, cache_path="", device="cuda"):
    """Val logits [N, C] of one model, from ``cache_path`` when it
    exists (and written there when given)."""
    if cache_path and os.path.exists(cache_path):
        return np.load(cache_path)
    results, loader = run_inference(config, "vcr", ckpt, "val", device)
    logits = np.concatenate([o["label_logits"] for o in results])
    logits = logits[: len(loader.dataset)]
    if cache_path:
        np.save(cache_path, logits)
    return logits


def paired_accuracies(a_logits, r_logits, db):
    """(Q->A, QA->R, Q->AR) accuracies over the val rows ``db``."""
    a_ok = a_logits.argmax(1) == np.asarray([r["answer_label"] for r in db])
    r_ok = r_logits.argmax(1) == np.asarray([r["rationale_label"]
                                              for r in db])
    return (float(a_ok.mean()), float(r_ok.mean()),
            float((a_ok & r_ok).mean()))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="VCR paired-model validation (PyTorch + CUDA)")
    parser.add_argument("--a-cfg", required=True, help="Q2A config yaml")
    parser.add_argument("--r-cfg", required=True, help="QA2R config yaml")
    parser.add_argument("--a-ckpt", required=True)
    parser.add_argument("--r-ckpt", required=True)
    parser.add_argument("--cache-dir", default="",
                        help="where the two models' val logits are cached")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda needs a card (no fallback)")
    return parser.parse_args(argv)


def main(argv=None):
    from vlbert_tpu_torch.utils.config import load_config

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    a_cfg = load_config("vcr", args.a_cfg)
    a_cfg.DATASET.TASK = "Q2A"
    r_cfg = load_config("vcr", args.r_cfg)
    r_cfg.DATASET.TASK = "QA2R"
    cache = {k: os.path.join(args.cache_dir, f"{k}_pred.npy")
             if args.cache_dir else "" for k in ("a", "r")}
    a_logits = predict(a_cfg, args.a_ckpt, cache["a"], args.device)
    r_logits = predict(r_cfg, args.r_ckpt, cache["r"], args.device)

    d = a_cfg.DATASET
    ann = d.VAL_ANNOTATION_FILE if os.path.isabs(d.VAL_ANNOTATION_FILE) \
        else os.path.join(d.DATASET_PATH, d.VAL_ANNOTATION_FILE)
    a_acc, r_acc, joint = paired_accuracies(a_logits, r_logits,
                                            load_jsonl(ann))
    print(f"Q->A: {a_acc:.4f}  QA->R: {r_acc:.4f}  Q->AR: {joint:.4f}")
    return a_acc, r_acc, joint


if __name__ == "__main__":
    main()
