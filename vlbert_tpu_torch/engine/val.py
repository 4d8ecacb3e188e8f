"""Validation over a loader (port of vlbert_tpu/engine/val.py): inference
on every batch, metrics from the batch's label columns, wrap-padded
duplicates masked out."""

from __future__ import annotations

import torch

from vlbert_tpu_torch.training import metrics as metrics_lib
from vlbert_tpu_torch.training.loop import make_eval_step, to_device

# which trailing batch entries are labels, and the output key each feeds
TASK_LABELS = {"vqa": {"label": -1}}


def make_validation_fn(model, config, task, device):
    label_map = TASK_LABELS[task]
    n_labels = len(label_map)
    eval_step = make_eval_step(model, task, config)

    def validation_fn(val_loader):
        acc = metrics_lib.HostAccumulator()
        for batch, valid in val_loader.iter_with_valid():
            batch = to_device(batch, device)
            labels = {k: batch[i] for k, i in label_map.items()}
            dm = eval_step(batch[:-n_labels], labels,
                           torch.as_tensor(valid).to(device))
            acc.update(dm)
        return acc.get()

    return validation_fn
