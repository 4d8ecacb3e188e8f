"""Loss functions with the reference's torch semantics (port of
vlbert_tpu/utils/losses.py). All are computed in fp32 whatever the
model's compute dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(x):
    return x.to(torch.float32)


def _nll(logits, labels):
    logp = torch.log_softmax(_f32(logits), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits, labels):
    """Mean CE over all entries (torch F.cross_entropy default)."""
    return _nll(logits, labels).mean()


def cross_entropy_ignore_index(logits, labels, ignore_index=-1):
    """Mean CE over entries whose label is not ``ignore_index``; 0 when
    none is valid (torch would give NaN)."""
    valid = labels != ignore_index
    nll = _nll(logits, torch.where(valid, labels, torch.zeros_like(labels)))
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def soft_cross_entropy(logits, soft_labels):
    """Soft-target CE over rows whose soft labels sum to ~1 (|sum - 1| <
    0.1); mean over valid rows, 0 if none."""
    soft = _f32(soft_labels)
    valid = (soft.sum(-1) - 1.0).abs() < 0.1
    per_row = -(soft * torch.log_softmax(_f32(logits), dim=-1)).sum(-1)
    per_row = torch.where(valid, per_row, torch.zeros_like(per_row))
    return per_row.sum() / valid.sum().clamp(min=1)


def bce_with_logits(logits, targets, weight=None):
    """torch F.binary_cross_entropy_with_logits, mean reduction."""
    w = None if weight is None else _f32(weight)
    return F.binary_cross_entropy_with_logits(_f32(logits), _f32(targets),
                                              weight=w)


def bce_with_logits_masked(logits, targets, mask):
    """BCE averaged over the mask-selected entries only."""
    loss = F.binary_cross_entropy_with_logits(_f32(logits), _f32(targets),
                                              reduction="none")
    m = _f32(mask)
    return (loss * m).sum() / m.sum().clamp(min=1.0)
