"""test_net, the inference drivers that write result files (port of
vlbert_tpu/engine/test.py).

    python -m vlbert_tpu_torch.engine.test --task vqa|refcoco \\
        --cfg <yaml> --ckpt <path> [--split val|test] [--result-path D] \\
        [--result-name N] [--device cpu]

ref: vqa/function/test.py (answers json :74-81), refcoco/function/test.py
(pred-box json + local IoU@0.5 accuracy :20-97). One process on one card
(``--device cuda`` unless asked for the CPU; no fallback), as the
reference runs its rank-0 test. The checkpoint may be a reference
``.model``, a raw torch state dict, an ``.npz`` of
``tools/convert_checkpoint.py`` or a checkpoint the port wrote; it is
loaded on reference names (``training/convert.py``). VCR's csv driver and
``merge_vcr_results`` wait for the VCR module (ROADMAP.md queue 1 #4).
"""

from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np
import torch

from vlbert_tpu_torch.data.build import dist_rank_world, make_dataloader
from vlbert_tpu_torch.data.tokenization import BertTokenizer
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.training import checkpoint as ckpt_lib
from vlbert_tpu_torch.training import convert as cvt
from vlbert_tpu_torch.training.loop import to_device

logger = logging.getLogger(__name__)

_VCR = "VCR is not ported yet; see ROADMAP.md queue 1 #4 (VCR forward)"


def _load_params(model, ckpt_path):
    """Load ``ckpt_path`` into ``model`` on reference names; tensors the
    file lacks keep their initial values, as in the JAX package. Returns
    the names loaded."""
    sd, raw = cvt.load_state_dict_file(ckpt_path, model)
    if raw:
        sd = cvt.convert_torch_state_dict(sd)
    loaded, _, _ = ckpt_lib.partial_load(model, sd)
    left = len(model.state_dict()) - len(loaded)
    logger.info("loaded %d tensors from %s%s", len(loaded), ckpt_path,
                f"; {left} keep their initial values" if left else "")
    return loaded


def _n_labels(config, task, mode):
    if mode == "test":
        return 0
    if task == "vcr":
        raise NotImplementedError(_VCR)
    return 1


def setup_inference(config, task, ckpt_path, mode="test", device="cuda"):
    """(model in eval mode, loader, number of label columns) for a task.
    The loader is unsharded: test runs on one process."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda is not "
                           "available")
    tokenizer = BertTokenizer.from_pretrained(config.NETWORK.BERT_MODEL_NAME)
    dtype = torch.bfloat16 if config.TPU.COMPUTE_DTYPE == "bfloat16" \
        else torch.float32
    model = build_module(config, task, dtype=dtype, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(0))
    _load_params(model, ckpt_path)
    loader = make_dataloader(config, task, mode, tokenizer, num_replicas=1,
                             rank=0)
    return model.eval(), loader, _n_labels(config, task, mode)


def infer_loader(model, loader, n_label, device):
    """Inference over every batch of ``loader``; returns the per-batch host
    numpy output dicts (fp32)."""
    results = []
    with torch.inference_mode():
        for batch in loader:
            b = to_device(batch if n_label == 0 else batch[:-n_label], device)
            results.append({k: v.float().cpu().numpy()
                            for k, v in model(*b).items()})
    return results


def run_inference(config, task, ckpt_path, mode="test", device="cuda"):
    """Shared inference loop; returns (list of per-batch host numpy output
    dicts, the loader)."""
    model, loader, n_label = setup_inference(config, task, ckpt_path, mode,
                                             device)
    try:
        return infer_loader(model, loader, n_label, device), loader
    finally:
        loader.shutdown()


def test_net_vqa(config, ckpt_path, answer_vocab, output_path, mode="test",
                 device="cuda"):
    """VQA leaderboard json: [{'question_id', 'answer'}] (ref vqa test
    :74-81)."""
    results, loader = run_inference(config, "vqa", ckpt_path, mode, device)
    answers = []
    db = loader.dataset.database
    # the dataset's vocab is the one the model indexed against
    answer_vocab = getattr(loader.dataset, "answer_vocab", answer_vocab) \
        or answer_vocab
    i = 0
    for out in results:
        for p in np.argmax(out["label_logits"], axis=1):
            if i < len(db):       # the loader wraps its last batch
                answers.append({"question_id": db[i].get("question_id", i),
                                "answer": answer_vocab[int(p)]})
            i += 1
    with open(output_path, "w") as f:
        json.dump(answers, f)
    logger.info("wrote %d answers to %s", len(answers), output_path)
    return answers


def test_net_refcoco(config, ckpt_path, output_path, mode="val",
                     device="cuda"):
    """RefCOCO+ predicted boxes json + local IoU@0.5 accuracy
    (ref refcoco test :20-97). Returns (preds, accuracy)."""
    from vlbert_tpu_torch.data.datasets.refcoco import bbox_iou

    results, loader = run_inference(config, "refcoco", ckpt_path, mode,
                                    device)
    db = loader.dataset.database
    preds = []
    n_correct, n_total = 0, 0
    i = 0
    for out in results:
        for pb in np.asarray(out["pred_boxes"], np.float32):
            if i < len(db):
                preds.append({"pred_box": pb.tolist()})
                gt = db[i].get("gt_box")
                if gt is not None:
                    iou = bbox_iou(pb[None], np.asarray(gt, np.float32))
                    n_correct += int(iou[0] > 0.5)
                    n_total += 1
            i += 1
    with open(output_path, "w") as f:
        json.dump(preds, f)
    acc = n_correct / max(n_total, 1)
    logger.info("RefCOCO local accuracy@0.5: %.4f (%d)", acc, n_total)
    return preds, acc


def test_net_vcr(config, ckpt_path, output_path, mode="test",
                 device="cuda"):
    raise NotImplementedError(_VCR)


def merge_vcr_results(q2a_csv, qa2r_csv, output_path):
    raise NotImplementedError(_VCR)


def result_file(result_path, name, task, split):
    return os.path.join(result_path, f"{name}_vqa2_{split}.json"
                        if task == "vqa" else f"{name}_refcoco_{split}.json")


def test_net(config, task, ckpt, result_path, name="result", split="test",
             device="cuda"):
    """Score ``ckpt`` on ``split`` into ``result_path``: the VQA answers
    json, or the RefCOCO+ pred-box json and its accuracy."""
    os.makedirs(result_path, exist_ok=True)
    out = result_file(result_path, name, task, split)
    if task == "vqa":
        with open(config.DATASET.ANSWER_VOCAB_FILE) as f:
            vocab = [line.strip() for line in f if line.strip()]
        return test_net_vqa(config, ckpt, vocab, out, mode=split,
                            device=device)
    if task == "refcoco":
        return test_net_refcoco(config, ckpt, out, mode=split, device=device)
    if task == "vcr":
        raise NotImplementedError(_VCR)
    raise ValueError(f"test unsupported for task {task!r}")


def do_test(args, config, task):
    """The post-training test run behind --do-test on rank 0 (ref
    vcr/train_end2end.py:51-56: rank 0 runs test_net on the best
    checkpoint after training)."""
    from vlbert_tpu_torch.engine.train import (model_prefix_of,
                                               train_output_path)

    if dist_rank_world()[0] != 0:
        return None
    train_output = train_output_path(config, args, task)
    ckpt = getattr(args, "ckpt", "") \
        or model_prefix_of(config, train_output) + "-best.model"
    return test_net(config, task, ckpt,
                    getattr(args, "result_path", "") or train_output,
                    getattr(args, "result_name", "") or "result",
                    "test", getattr(args, "device", "cuda"))


def main(argv=None):
    from vlbert_tpu_torch.engine.cli import parse_test_args
    from vlbert_tpu_torch.utils.config import load_config

    args = parse_test_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    config = load_config(args.task, args.cfg)
    test_net(config, args.task, args.ckpt, args.result_path,
             args.result_name, args.split, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
