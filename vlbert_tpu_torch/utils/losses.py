"""Loss functions with the reference's torch semantics (port of
vlbert_tpu/utils/losses.py). All are computed in fp32 whatever the
model's compute dtype.

A loss that divides by a count of the data (masked tokens, live boxes,
valid soft-label rows) divides, within ``global_counts``, by the count
over every rank's batch, over the world size: the JAX package computes
such a loss once over the global batch, and the mean of the ranks'
losses (and gradients) is then that loss. Plain means over equal
per-rank batches need nothing. Outside the block, as on one process,
each count is the batch's own.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# (sum over the ranks, world size) within ``global_counts``
_GLOBAL = []


@contextlib.contextmanager
def global_counts(reduce_sum, world):
    """Within this block, each data-dependent denominator is
    ``denominator(reduce_sum(count)) / world``: ``reduce_sum`` returns the
    count summed over the ranks, detached (``parallel/dist.py::
    all_reduce_sum``). Every rank must compute the same losses in the same
    order (a collective each)."""
    _GLOBAL.append((reduce_sum, world))
    try:
        yield
    finally:
        _GLOBAL.pop()


def _denominator(count, finish):
    """``finish(count)``, of the global count within ``global_counts``."""
    if not _GLOBAL:
        return finish(count)
    reduce_sum, world = _GLOBAL[-1]
    return finish(reduce_sum(count.to(torch.float32))) / world


def _at_least_one(count):
    return count.clamp(min=1)


def _plus_eps(count):
    return count.to(torch.float32) + 1e-4


def _f32(x):
    return x.to(torch.float32)


def _nll(logits, labels):
    logp = torch.log_softmax(_f32(logits), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits, labels):
    """Mean CE over all entries (torch F.cross_entropy default)."""
    return _nll(logits, labels).mean()


def masked_cross_entropy(logits, labels, mask):
    """Mean CE over the entries ``mask`` selects; 0 when it selects none
    (the CNN regularization losses over live box slots)."""
    m = _f32(mask)
    return (_nll(logits, labels) * m).sum() / _denominator(m.sum(),
                                                          _at_least_one)


def cross_entropy_ignore_index(logits, labels, ignore_index=-1):
    """Mean CE over entries whose label is not ``ignore_index``; 0 when
    none is valid (torch would give NaN)."""
    valid = labels != ignore_index
    nll = _nll(logits, torch.where(valid, labels, torch.zeros_like(labels)))
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / _denominator(valid.sum(), _at_least_one)


def soft_cross_entropy(logits, soft_labels):
    """Soft-target CE over rows whose soft labels sum to ~1 (|sum - 1| <
    0.1); mean over valid rows, 0 if none."""
    soft = _f32(soft_labels)
    valid = (soft.sum(-1) - 1.0).abs() < 0.1
    per_row = -(soft * torch.log_softmax(_f32(logits), dim=-1)).sum(-1)
    per_row = torch.where(valid, per_row, torch.zeros_like(per_row))
    return per_row.sum() / _denominator(valid.sum(), _at_least_one)


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
    return (loss * m).sum() / _denominator(m.sum(), _at_least_one)


def cross_entropy_ignore_index_batch_first(logits, labels, ignore_index=-1):
    """MLM_LOSS_NORM_IN_BATCH_FIRST: each example's mean over its valid
    tokens, then the mean over the examples that have any; both
    denominators get the reference's +1e-4. logits [B, T, V]."""
    valid = labels != ignore_index
    nll = _nll(logits, torch.where(valid, labels, torch.zeros_like(labels)))
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    num = valid.sum(dim=1).to(torch.float32)
    per_ex = nll.sum(dim=1) / (num + 1e-4)
    return per_ex.sum() / _denominator((num != 0).sum(), _plus_eps)


def soft_cross_entropy_batch_first(logits, soft_labels):
    """MVRC_LOSS_NORM_IN_BATCH_FIRST: a row is valid when its soft labels
    sum to ~1; each example's mean over its valid rows, then the mean over
    the examples that have any (+1e-4 on both). logits [B, O, C]."""
    soft = _f32(soft_labels)
    valid = (soft.sum(-1) - 1.0).abs() < 0.1
    per_row = -(soft * torch.log_softmax(_f32(logits), dim=-1)).sum(-1)
    per_row = torch.where(valid, per_row, torch.zeros_like(per_row))
    num = valid.sum(dim=1).to(torch.float32)
    per_ex = per_row.sum(dim=1) / (num + 1e-4)
    return per_ex.sum() / _denominator((num != 0).sum(), _plus_eps)
