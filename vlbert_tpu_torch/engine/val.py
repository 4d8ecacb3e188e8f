"""Validation over a loader (port of vlbert_tpu/engine/val.py): inference
on every batch, metrics from the batch's label columns, wrap-padded
duplicates masked out."""

from __future__ import annotations

import torch

from vlbert_tpu_torch.training import metrics as metrics_lib
from vlbert_tpu_torch.training.loop import make_eval_step, to_device

# which trailing batch entries are labels, and the output key each feeds;
# the pretraining model takes its labels as inputs and returns them
TASK_LABELS = {"vcr": {"label": -1}, "vqa": {"label": -1},
               "refcoco": {"label": -1}, "pretrain": {}}


def label_map_of(config, task):
    """TASK_LABELS, and for VCR Q2AR both labels: the answer's and the
    rationale's, last."""
    if task == "vcr" and config.DATASET.get("TASK") == "Q2AR":
        return {"label": -2, "rationale_label": -1}
    return TASK_LABELS[task]


def make_validation_fn(model, config, task, device):
    label_map = label_map_of(config, task)
    n_labels = len(label_map)
    eval_step = make_eval_step(model, task, config)

    def validation_fn(val_loader):
        acc = metrics_lib.HostAccumulator()
        for batch, valid in val_loader.iter_with_valid():
            batch = to_device(batch, device)
            labels = {k: batch[i] for k, i in label_map.items()}
            dm = eval_step(batch[:len(batch) - n_labels], labels,
                           torch.as_tensor(valid).to(device))
            acc.update(dm)
        return acc.get()

    return validation_fn
