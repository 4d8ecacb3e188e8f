"""test_net, the inference drivers that write result files (port of
vlbert_tpu/engine/test.py).

    python -m vlbert_tpu_torch.engine.test --task vqa|refcoco|vcr \\
        --cfg <yaml> --ckpt <path> [--split val|test] [--result-path D] \\
        [--result-name N] [--device cpu]

ref: vqa/function/test.py (answers json :74-81), refcoco/function/test.py
(pred-box json + local IoU@0.5 accuracy :20-97), vcr/function/test.py
(csv of per-choice probabilities :90-135, the Q2A + QA2R merge :138-147).
VCR's QA2R test split is answer-conditioned: its text tensors are
[B, A, C, T] and each batch runs the model once per candidate answer. One
process on one card (``--device cuda`` unless asked for the CPU; no
fallback), as the reference runs its rank-0 test. The checkpoint may be a
reference ``.model``, a raw torch state dict, an ``.npz`` of
``tools/convert_checkpoint.py`` or a checkpoint the port wrote; it is
loaded on reference names (``training/convert.py``).
"""

from __future__ import annotations

import csv
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

# the text slots of a VCR batch (input ids, token types, tags, mask)
VCR_TEXT_SLOTS = (5, 6, 7, 8)


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
    if task == "vcr" and config.DATASET.get("TASK") == "Q2AR":
        return 2      # answer_label + rationale_label
    return 1


def is_conditioned(config, task, mode):
    """VCR QA2R on the test split: one query per candidate answer."""
    return task == "vcr" and config.DATASET.TASK == "QA2R" and mode == "test"


def _slice_conditioned(batch, a_id):
    """Conditioning answer ``a_id`` of the [B, A, C, T] text tensors."""
    out = list(batch)
    for k in VCR_TEXT_SLOTS:
        out[k] = batch[k][:, a_id]
    return tuple(out)


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


def _host(out):
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def infer_loader(model, loader, n_label, device, conditioned=False):
    """Inference over every batch of ``loader``; returns the per-batch host
    numpy output dicts (fp32). ``conditioned``: the batches hold [B, A, C,
    T] text; the model runs once per conditioning answer and each output
    is stacked on a new axis 1, [B, A, ...]."""
    results = []
    with torch.inference_mode():
        for batch in loader:
            b = to_device(batch if n_label == 0 else batch[:-n_label], device)
            if not conditioned:
                results.append(_host(model(*b)))
                continue
            per_a = [_host(model(*_slice_conditioned(b, a)))
                     for a in range(b[VCR_TEXT_SLOTS[0]].shape[1])]
            results.append({k: np.stack([o[k] for o in per_a], 1)
                            for k in per_a[0]})
    return results


def run_inference(config, task, ckpt_path, mode="test", device="cuda"):
    """Shared inference loop; returns (list of per-batch host numpy output
    dicts, the loader)."""
    model, loader, n_label = setup_inference(config, task, ckpt_path, mode,
                                             device)
    try:
        return infer_loader(model, loader, n_label, device,
                            is_conditioned(config, task, mode)), loader
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


def _softmax_np(logits):
    logits = np.asarray(logits, np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def test_net_vcr(config, ckpt_path, output_path, mode="test",
                 device="cuda"):
    """VCR leaderboard csv (ref vcr/function/test.py:90-135): the softmax
    over the choices of each question (per-choice sigmoid logits too).

    Q2A: columns ``answer_{k}``. QA2R on the test split: 4 conditioned
    passes, one per candidate answer, and 16 columns
    ``rationale_conditioned_on_a{i}_{j}``. The probability matrix is also
    saved as .npy beside the csv. Returns the csv rows."""
    task = config.DATASET.TASK
    if task not in ("Q2A", "QA2R"):
        raise ValueError(f"the leaderboard test takes Q2A or QA2R, got "
                         f"{task!r} (ref test.py:116)")
    conditioned = is_conditioned(config, "vcr", mode)
    results, loader = run_inference(config, "vcr", ckpt_path, mode, device)
    db = loader.dataset.database
    probs = np.concatenate([_softmax_np(o["label_logits"]) for o in results])
    # [N, A, C] -> blocks of C rationale probabilities per answer
    probs = probs.reshape(len(probs), -1)[: len(db)]

    np.save(os.path.splitext(output_path)[0] + ".npy", probs)
    if conditioned:
        columns = [f"rationale_conditioned_on_a{i}_{j}"
                   for i in range(4) for j in range(4)]
    else:
        columns = [f"answer_{k}" for k in range(probs.shape[1])]
    rows = [[db[i].get("annot_id", i)] + probs[i].tolist()
            for i in range(len(probs))]
    with open(output_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["annot_id"] + columns)
        w.writerows(rows)
    logger.info("wrote %d rows to %s", len(rows), output_path)
    return rows


def merge_vcr_results(q2a_csv, qa2r_csv, output_path):
    """Join the Q2A and QA2R csvs on annot_id into the leaderboard
    submission (ref vcr/function/test.py:138-147): an inner join in the
    Q2A file's row order, the Q2A columns first, fields copied as they
    are (the JAX package's pandas merge, without pandas)."""
    def read(path):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        return rows[0], rows[1:]

    a_head, a_rows = read(q2a_csv)
    r_head, r_rows = read(qa2r_csv)
    ka, kr = a_head.index("annot_id"), r_head.index("annot_id")
    by_id = {}
    for r in r_rows:
        by_id.setdefault(r[kr], []).append(r[:kr] + r[kr + 1:])
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(a_head + r_head[:kr] + r_head[kr + 1:])
        for a in a_rows:
            w.writerows(a + r for r in by_id.get(a[ka], ()))
    logger.info("merged result csv saved to %s", output_path)
    return output_path


def result_file(result_path, name, task, split, vcr_task=None):
    """The result file test_net writes: ``vcr_task`` is DATASET.TASK."""
    if task == "vcr":
        return os.path.join(result_path, f"{name}_{split}_{vcr_task}.csv")
    return os.path.join(result_path, f"{name}_vqa2_{split}.json"
                        if task == "vqa" else f"{name}_refcoco_{split}.json")


def test_net(config, task, ckpt, result_path, name="result", split="test",
             device="cuda"):
    """Score ``ckpt`` on ``split`` into ``result_path``: the VQA answers
    json, the RefCOCO+ pred-box json and its accuracy, or the VCR csv."""
    os.makedirs(result_path, exist_ok=True)
    out = result_file(result_path, name, task, split,
                      config.DATASET.get("TASK"))
    if task == "vqa":
        with open(config.DATASET.ANSWER_VOCAB_FILE) as f:
            vocab = [line.strip() for line in f if line.strip()]
        return test_net_vqa(config, ckpt, vocab, out, mode=split,
                            device=device)
    if task == "refcoco":
        return test_net_refcoco(config, ckpt, out, mode=split, device=device)
    if task == "vcr":
        return test_net_vcr(config, ckpt, out, mode=split, device=device)
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
