"""Startup parameter summary (port of vlbert_tpu/utils/misc.py): a
per-parameter name/dtype/shape/#params table plus trainable /
non-trainable / total counts, logged once at model build. The split is
``requires_grad``, which ``training.optim.apply_trainable_mask`` sets.
And ``master_dataset``, the DATASET entry a config's run is defined by."""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def master_dataset(cfg):
    """``cfg.DATASET``, or the first entry of a pretraining config's list
    (the master loader's, which sets the epoch length)."""
    d = cfg.DATASET
    return d[0] if isinstance(d, (list, tuple)) else d


def summary_parameters(module, log=None):
    """Log the parameter table; returns (n_trainable, n_frozen, n_total)."""
    log = log or logger
    rows = [(name, str(p.dtype).removeprefix("torch."), tuple(p.shape),
             p.numel(), p.requires_grad)
            for name, p in module.named_parameters()]
    cols = [[r[0] for r in rows], [r[1] for r in rows],
            [str(r[2]) for r in rows], [str(r[3]) for r in rows]]
    widths = [max((len(c) for c in col), default=4) + 2 for col in cols]
    fmt = "|" + "|".join(f"{{:{w}s}}" for w in widths) + "| {}"
    sep = "-" * (sum(widths) + len(widths) + 13)

    log.info(">> Trainable Parameters:")
    log.info(sep)
    log.info(fmt.format("Name", "Dtype", "Shape", "#Params", "Trainable"))
    log.info(sep)
    for name, dtype, shape, count, is_t in rows:
        log.info(fmt.format(name, dtype, str(shape), str(count),
                            "yes" if is_t else "FROZEN"))
    log.info(sep)

    n_trainable = sum(r[3] for r in rows if r[4])
    n_total = sum(r[3] for r in rows)
    n_frozen = n_total - n_trainable
    log.info(">> %-25s\t%.2f\tM", "# TrainableParams:", n_trainable / 1e6)
    log.info(">> %-25s\t%.2f\tM", "# NonTrainableParams:", n_frozen / 1e6)
    log.info(">> %-25s\t%.2f\tM", "# TotalParams:", n_total / 1e6)
    return n_trainable, n_frozen, n_total
