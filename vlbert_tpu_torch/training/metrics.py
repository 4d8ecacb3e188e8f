"""Metrics as (sum, count) pairs (port of vlbert_tpu/training/metrics.py).

Each metric is computed on the device from a step's outputs and stays
there as a tensor; the host accumulates them into Python floats only at
log points (``HostAccumulator``), so a step does not wait on the device.
Ported so far: the VQA and VCR metrics; the RefCOCO+ and pretraining ones
are ROADMAP.md queue 1 #5 and #8.
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


def loss_logger(outputs, key):
    """Running mean of a loss output."""
    return outputs[key].detach().to(torch.float32).sum(), 1


# the named host metric of each task's ValidationMonitor
HOST_METRIC_NAME = {"vcr": "Acc", "vqa": "SoftAcc"}

TASK_METRICS = {"vcr": {"Acc": vcr_accuracy},
                "vqa": {"SoftAcc": vqa_soft_accuracy}}


def device_metrics(task, config, outputs):
    """All (sum, count) pairs of a task, on the device."""
    if task not in TASK_METRICS:
        raise NotImplementedError(f"metrics of task {task!r} are not ported "
                                  f"yet; see ROADMAP.md queue 1")
    out = {name: fn(outputs) for name, fn in TASK_METRICS[task].items()}
    if task == "vcr" and "rationale_logits" in outputs \
            and "rationale_label" in outputs:
        out["RationaleAcc"] = vcr_rationale_accuracy(outputs)
        out["JointAcc"] = vcr_joint_accuracy(outputs)
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
