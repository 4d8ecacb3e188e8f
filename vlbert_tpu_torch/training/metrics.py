"""Metrics as (sum, count) pairs (port of vlbert_tpu/training/metrics.py).

Each metric is computed on the device from a step's outputs and stays
there as a tensor; the host accumulates them into Python floats only at
log points (``HostAccumulator``), so a step does not wait on the device.
Ported: the VQA, VCR, RefCOCO+ and pretraining metrics.
"""

from __future__ import annotations

import torch


def _sample_valid(outputs, B):
    """Per-sample validity [B] (validation batches mark the loader's
    wrap-padding duplicates invalid) and the count of valid samples."""
    v = outputs.get("valid")
    if v is None or v.shape[0] != B:
        return None, float(B)
    vf = v.to(torch.float32)
    return vf, vf.sum()


def _correct_sum(correct, vf):
    correct = correct.to(torch.float32)
    return (correct if vf is None else correct * vf).sum()


def vcr_accuracy(outputs):
    """The argmax choice is the labelled one (per-choice sigmoid logits
    too: they are [B, C] like softmax logits)."""
    logits, label = outputs["label_logits"], outputs["label"]
    vf, n = _sample_valid(outputs, logits.shape[0])
    return _correct_sum(logits.argmax(dim=1) == label.long(), vf), n


def vcr_rationale_accuracy(outputs):
    """Q2AR's rationale stream: the argmax rationale is the labelled one."""
    logits, label = outputs["rationale_logits"], outputs["rationale_label"]
    vf, n = _sample_valid(outputs, logits.shape[0])
    return _correct_sum(logits.argmax(dim=1) == label.long(), vf), n


def vcr_joint_accuracy(outputs):
    """Q->AR: the answer and the rationale both right."""
    a_ok = outputs["label_logits"].argmax(dim=1) == outputs["label"].long()
    r_ok = (outputs["rationale_logits"].argmax(dim=1)
            == outputs["rationale_label"].long())
    vf, n = _sample_valid(outputs, a_ok.shape[0])
    return _correct_sum(a_ok & r_ok, vf), n


def vqa_soft_accuracy(outputs):
    """Soft VQA score of the argmax answer."""
    logits, label = outputs["label_logits"], outputs["label"]
    vf, n = _sample_valid(outputs, logits.shape[0])
    idx = logits.argmax(dim=1)
    score = torch.gather(label, 1, idx[:, None])[:, 0].to(torch.float32)
    return (score if vf is None else score * vf).sum(), n


def refcoco_accuracy(outputs):
    """The argmax region is a positive one (IoU > 0.5 with the referent)."""
    logits, label = outputs["label_logits"], outputs["label"]
    vf, n = _sample_valid(outputs, logits.shape[0])
    idx = logits.argmax(dim=1)
    hit = torch.gather(label, 1, idx[:, None])[:, 0] > 0.5
    return _correct_sum(hit, vf), n


def _region_masks(outputs):
    """(valid, positive) [B, O] region masks: label >= 0 marks a live slot
    (padded slots carry -1), label > 0.5 a positive one; wrap-padded
    samples drop out."""
    label = outputs["label"]
    valid, pos = label >= 0, label > 0.5
    vf, _ = _sample_valid(outputs, label.shape[0])
    if vf is not None:
        keep = vf[:, None] > 0
        valid, pos = valid & keep, pos & keep
    return valid, pos


def refcoco_cls_accuracy(outputs):
    """Per-region binary accuracy (logit > 0 against label > 0.5) over the
    live slots."""
    valid, pos = _region_masks(outputs)
    correct = ((outputs["label_logits"] > 0) == pos) & valid
    return correct.to(torch.float32).sum(), valid.to(torch.float32).sum()


def refcoco_cls_pos_accuracy(outputs):
    """Binary accuracy over the positive regions only."""
    _, pos = _region_masks(outputs)
    correct = (outputs["label_logits"] > 0) & pos
    return correct.to(torch.float32).sum(), pos.to(torch.float32).sum()


def refcoco_cls_pos_fraction(outputs):
    """The fraction of live regions that are positive."""
    valid, pos = _region_masks(outputs)
    return pos.to(torch.float32).sum(), valid.to(torch.float32).sum()


def relationship_accuracy(outputs):
    """The argmax of the caption-image relationship logits is the label."""
    logits, label = outputs["relationship_logits"], \
        outputs["relationship_label"]
    vf, n = _sample_valid(outputs, logits.shape[0])
    return _correct_sum(logits.argmax(dim=1) == label.long(), vf), n


def _kept(valid, outputs):
    """[B, X] ``valid`` without the rows of wrap-padded samples."""
    vf, _ = _sample_valid(outputs, valid.shape[0])
    return valid if vf is None else valid & (vf[:, None] > 0)


def mlm_accuracy(outputs, logits_key="mlm_logits_wvc",
                 label_key="mlm_label_wvc"):
    """Argmax accuracy over the tokens whose label is not -1 (the caption
    rows; ``mlm_logits_aux`` / ``mlm_label_aux`` for the corpus rows)."""
    logits, label = outputs[logits_key], outputs[label_key]
    valid = _kept(label != -1, outputs)
    correct = (logits.argmax(dim=-1) == label.long()) & valid
    return correct.to(torch.float32).sum(), valid.to(torch.float32).sum()


def mvrc_accuracy(outputs):
    """The argmax region class is the soft label's argmax, over the rows
    whose soft labels sum to ~1 (the masked regions)."""
    logits, label = outputs["mvrc_logits"], outputs["mvrc_label"]
    valid = _kept((label.sum(dim=-1) - 1.0).abs() < 0.1, outputs)
    correct = (logits.argmax(dim=-1) == label.argmax(dim=-1)) & valid
    return correct.to(torch.float32).sum(), valid.to(torch.float32).sum()


def loss_logger(outputs, key):
    """Running mean of a loss output."""
    return outputs[key].detach().to(torch.float32).sum(), 1


# the named host metric of each task's ValidationMonitor
HOST_METRIC_NAME = {"vcr": "Acc", "vqa": "SoftAcc", "refcoco": "RefAcc",
                    "pretrain": "MLMAcc"}


def host_metric_name(task, config=None):
    """HOST_METRIC_NAME, except for pretraining without the MLM task:
    MVRCAcc, else RelAcc (MLMAcc would not exist, and the best checkpoint
    would never be chosen)."""
    net = config.NETWORK if config is not None else None
    if task == "pretrain" and net is not None and not net.WITH_MLM_LOSS:
        if net.WITH_MVRC_LOSS:
            return "MVRCAcc"
        if net.WITH_REL_LOSS:
            return "RelAcc"
    return HOST_METRIC_NAME[task]


TASK_METRICS = {"vcr": {"Acc": vcr_accuracy},
                "vqa": {"SoftAcc": vqa_soft_accuracy},
                "refcoco": {"RefAcc": refcoco_accuracy,
                            "ClsAcc": refcoco_cls_accuracy,
                            "ClsPosAcc": refcoco_cls_pos_accuracy,
                            "ClsPosFrac": refcoco_cls_pos_fraction},
                "pretrain": {"MLMAcc": mlm_accuracy,
                             "MVRCAcc": mvrc_accuracy}}
# the outputs a pretraining metric reads: absent when its task is off
_NEEDS = {"MLMAcc": "mlm_logits_wvc", "MVRCAcc": "mvrc_logits"}


def device_metrics(task, config, outputs):
    """All (sum, count) pairs of a task, on the device."""
    out = {name: fn(outputs) for name, fn in TASK_METRICS[task].items()
           if name not in _NEEDS or _NEEDS[name] in outputs}
    if task == "vcr" and "rationale_logits" in outputs \
            and "rationale_label" in outputs:
        out["RationaleAcc"] = vcr_rationale_accuracy(outputs)
        out["JointAcc"] = vcr_joint_accuracy(outputs)
    if task == "pretrain" and config.NETWORK.WITH_REL_LOSS \
            and "relationship_logits" in outputs:
        out["RelAcc"] = relationship_accuracy(outputs)
    if task == "pretrain" and "mlm_logits_aux" in outputs:
        out["MLMAccAUX"] = mlm_accuracy(outputs, "mlm_logits_aux",
                                        "mlm_label_aux")
    for output_name, display_name in config.TRAIN.LOSS_LOGGERS:
        if output_name in outputs:
            out[display_name] = loss_logger(outputs, output_name)
    return out


class HostAccumulator:
    """Host-side running sums (EvalMetric reset/update/get)."""

    def __init__(self):
        self.sums = {}
        self.nums = {}

    def reset(self):
        self.sums.clear()
        self.nums.clear()

    def update(self, device_out):
        for k, (s, n) in device_out.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(s)
            self.nums[k] = self.nums.get(k, 0) + float(n)

    def get(self):
        return {k: (self.sums[k] / self.nums[k] if self.nums[k]
                    else float("nan")) for k in self.sums}

    def format(self):
        return ", ".join(f"{k}={v:.4f}" for k, v in sorted(self.get().items()))
