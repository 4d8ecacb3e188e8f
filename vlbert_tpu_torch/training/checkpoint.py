"""Checkpoint save / load / resume (port of vlbert_tpu/training/checkpoint.py).

ref: common/callbacks/epoch_end_callbacks/checkpoint.py:10-25 (save
{state_dict, optimizer, ...} per epoch + '-best.model' copy),
common/utils/load.py:20-54 (smart_resume + AUTO_RESUME downward scan),
:57-81 (smart_partial_load: ignore non-matching keys, report).

Format: the reference's own, ``torch.save({"state_dict", "optimizer",
"step", "extra"})`` to ``{prefix}-{epoch:04d}.model``, with ``-best.model``
beside it. ``state_dict`` holds the port module's parameters and buffers
under reference names, so the JAX package reads the file as "torch"
(``vlbert_tpu.training.convert.load_torch_or_native_checkpoint``);
``optimizer`` is ``Optimizer.state_dict()`` (moments keyed by parameter
name, ``count``, ``plateau_scale``); ``extra`` carries ``best_val`` and the
plateau detector. The port reads its own files with ``weights_only=True``.

Not ported: ``_reconcile_masked_opt_state`` migrates optax moment trees
across a format change the port never had (its moments are dense tensors
keyed by name), and ``_to_host`` / ``snapshot_needs_all_ranks`` gather
state sharded across hosts, which waits for multi-GPU (ROADMAP.md queue
1): one process writes its own full state. The pretraining model's tied
MLM decoder is one tensor under two names: ``_to_host`` keeps it one.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading

import torch

from vlbert_tpu_torch.training.convert import (apply_reference_prefix_changes,
                                               reference_name)

logger = logging.getLogger(__name__)

# at most one in-flight background writer (per process); every reader /
# next writer joins it first, so async saves are invisible to callers —
# except that a background write FAILURE surfaces at the next join point
# (next save / mirror / load / end of train_net) instead of immediately
_pending_save: threading.Thread | None = None
_pending_error: list = []


def wait_for_pending_save():
    """Join the in-flight async checkpoint write; re-raise its failure.

    The reference's synchronous torch.save raises in place; an async write
    failure (ENOSPC, permissions) must not vanish into a daemon thread —
    it is re-raised here, one join point after the fact.
    """
    global _pending_save
    if _pending_save is not None:
        _pending_save.join()
        _pending_save = None
    if _pending_error:
        e = _pending_error.pop()
        _pending_error.clear()
        raise RuntimeError(f"async checkpoint write failed: {e!r}") from e


def _atomic_copy(src, dst):
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _to_host(obj, memo=None):
    """A copy of ``obj`` with every tensor on the CPU: the caller's next
    step updates the live tensors in place. Two entries that are one
    tensor (the pretraining model's tied MLM decoder) stay one copy, so
    the file holds it once, as the reference's does."""
    memo = {} if memo is None else memo
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.dtype, tuple(obj.shape), obj.stride())
        if key not in memo:
            memo[key] = obj.detach().to("cpu", copy=True)
        return memo[key]
    if isinstance(obj, dict):
        return {k: _to_host(v, memo) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, memo) for v in obj)
    return obj


def save_checkpoint(prefix, epoch, model, optimizer, extra=None,
                    async_write=False, mirror_best_to=None):
    """Save weights, optimizer state and step (+ the extra dict) to
    ``{prefix}-{epoch:04d}.model``; returns the path.

    The device-to-host copy is always synchronous (the next step updates
    the tensors in place). With ``async_write`` the torch.save — seconds
    for base-width state that the reference spends inside the epoch loop
    (ref checkpoint.py:10-25) — runs in a background thread instead,
    overlapping the next epoch. Writes go to a temp file and then
    ``os.replace``, so a preemption mid-write never leaves a torn
    ``{epoch}.model`` for AUTO_RESUME to trip over. ``mirror_best_to``
    also copies the finished file to ``{mirror_best_to}-best.model``
    inside the writer (atomically too), so best-epoch mirroring does not
    force a join. A failed background write raises at the next join point
    (``wait_for_pending_save`` / the next save / any load).
    """
    global _pending_save
    wait_for_pending_save()
    payload = {"state_dict": _to_host(model.state_dict()),
               "optimizer": _to_host(optimizer.state_dict()),
               "step": int(optimizer.count),
               "extra": dict(extra or {})}
    path = f"{prefix}-{epoch:04d}.model"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _write_file():
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        logger.info("saved checkpoint %s", path)
        if mirror_best_to is not None:
            best = f"{mirror_best_to}-best.model"
            _atomic_copy(path, best)
            logger.info("mirrored best checkpoint to %s", best)

    def _guarded_write():
        try:
            _write_file()
        except BaseException as e:  # noqa: BLE001 — re-raised at next join
            logger.exception("async checkpoint write failed for %s", path)
            _pending_error.append(e)

    if async_write:
        _pending_save = threading.Thread(
            target=_guarded_write, name="ckpt-writer", daemon=True)
        _pending_save.start()
    else:
        _write_file()
    return path


def mirror_best(prefix, epoch_path):
    wait_for_pending_save()              # epoch_path may still be writing
    best = f"{prefix}-best.model"
    _atomic_copy(epoch_path, best)       # -best.model can't be torn either
    logger.info("mirrored best checkpoint to %s", best)
    return best


def load_checkpoint(path, model=None, optimizer=None):
    """Read a checkpoint the port wrote. Without ``model`` returns the
    payload; with it, loads the weights (every key, strictly) and, given
    ``optimizer``, the optimizer state, and returns the ``extra`` dict."""
    wait_for_pending_save()              # read-after-async-write safety
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return payload
    model.load_state_dict(payload["state_dict"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
        if optimizer.count != payload["step"]:
            raise ValueError(f"{path}: optimizer count {optimizer.count} "
                             f"!= step {payload['step']}")
    return payload.get("extra", {})


def auto_resume(prefix, model, optimizer, end_epoch):
    """Scan from end_epoch downward for the newest checkpoint
    (ref: common/utils/load.py:32-54). Returns (begin_epoch, extra)."""
    for epoch in range(end_epoch - 1, -1, -1):
        path = f"{prefix}-{epoch:04d}.model"
        if os.path.exists(path):
            extra = load_checkpoint(path, model, optimizer)
            logger.info("auto-resumed from %s (begin_epoch=%d)", path,
                        epoch + 1)
            return epoch + 1, extra
    return 0, {}


def partial_load(model, state_dict, prefix_changes=()):
    """smart_partial_load semantics (ref: common/utils/load.py:57-81) on
    reference names: ``prefix_changes`` [(old, new), ...] are applied to
    the raw names first (ref vcr/function/train.py:202-214), then each
    name is normalised (``reference_name``); a key of ``model``'s
    state_dict with the same shape is loaded, cast to the target's dtype.
    Returns (loaded, missing, mismatched): names loaded, names the model
    does not have, and [(name, file shape, model shape)]."""
    renamed = {reference_name(k): v for k, v in
               apply_reference_prefix_changes(state_dict,
                                              prefix_changes).items()}
    target = model.state_dict()
    loaded, missing, mismatched = [], [], []
    with torch.no_grad():
        for k, v in renamed.items():
            if k not in target:
                missing.append(k)
                continue
            v = torch.as_tensor(v)
            if tuple(v.shape) != tuple(target[k].shape):
                mismatched.append((k, tuple(v.shape),
                                   tuple(target[k].shape)))
                continue
            target[k].copy_(v)
            loaded.append(k)
    if missing:
        logger.warning("partial_load: %d keys not in model (e.g. %s)",
                       len(missing), missing[:5])
    if mismatched:
        logger.warning("partial_load: shape mismatches: %s", mismatched[:5])
    logger.info("partial_load: loaded %d/%d keys", len(loaded), len(target))
    return loaded, missing, mismatched


def smart_resume(prefix, model, optimizer, config):
    """Explicit + auto resume (ref: common/utils/load.py:20-54):
    TRAIN.RESUME loads {prefix}-{BEGIN_EPOCH-1:04d}.model; otherwise
    AUTO_RESUME scans downward. Returns (begin_epoch, extra)."""
    t = config.TRAIN
    if t.RESUME:
        if t.BEGIN_EPOCH < 1:
            raise ValueError(
                "TRAIN.RESUME requires TRAIN.BEGIN_EPOCH >= 1 (the epoch to "
                "resume INTO; the checkpoint {prefix}-{BEGIN_EPOCH-1:04d}"
                ".model is loaded) — got BEGIN_EPOCH="
                f"{t.BEGIN_EPOCH}")
        path = f"{prefix}-{t.BEGIN_EPOCH - 1:04d}.model"
        extra = load_checkpoint(path, model, optimizer)
        logger.info("resumed from %s", path)
        return t.BEGIN_EPOCH, extra
    if t.AUTO_RESUME:
        return auto_resume(prefix, model, optimizer, t.END_EPOCH)
    return t.BEGIN_EPOCH, {}


def has_resumable_checkpoint(prefix, config):
    """True iff smart_resume would restore a checkpoint — used to skip the
    warm-start loads, which the resume overwrites, on a restart."""
    t = config.TRAIN
    if t.RESUME:
        return os.path.exists(f"{prefix}-{t.BEGIN_EPOCH - 1:04d}.model")
    if t.AUTO_RESUME:
        return any(os.path.exists(f"{prefix}-{e:04d}.model")
                   for e in range(t.END_EPOCH - 1, -1, -1))
    return False
