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

Under a process group (TPU.PARTITION_MODE dp) every rank holds the same
full state: ``engine/train.py`` has rank 0 alone write (the background
writer and ``-best.model`` included) and alone resume, then broadcasts
what it read; the module is never wrapped, so the files keep the
reference names with no ``module.`` prefix.

Under TPU.PARTITION_MODE fsdp (``parallel/fsdp.py``) each rank holds a
shard of every parameter and moment, and the file is still the one a
``dp`` run writes: the same keys, shapes and dtypes, the tied decoder
once. ``snapshot`` is then collective (JAX's ``_to_host`` and
``snapshot_needs_all_ranks``): every rank enters ``save_checkpoint``, the
tensors are gathered whole in a fixed order (``Fsdp.full_state``), and
rank 0 alone writes (``write``). ``load_checkpoint`` is collective too:
rank 0 reads the file, its tensors are broadcast and each rank keeps its
shard (``Fsdp.load_full_state_``); ``partial_load`` takes each rank's own
copy of a warm-start file. FSDP2 renames nothing, so no prefix is
stripped.

Under TPU.PARTITION_MODE tp (``parallel/tp.py``) each rank holds its part
of the encoder's split tensors and the rest whole; the same collective
snapshot gathers the split parameters and moments over rank 0's model
group along their split dims into the ``dp`` file, and a resume
broadcasts rank 0's whole tensors, each rank keeping its part. fsdp on a
[data, model] mesh does both: a tensor's data-axis chunks are gathered,
then a split one's model parts; a load keeps the rank's data chunk of its
model part. The warm starts load whole tensors before the model is split
or sharded. Every layout is reached through the model's partition
(``dist.partition_of``), whose ``full_state`` and ``load_full_state_``
these call.

The pretraining model's tied MLM decoder is one tensor under two names:
``_to_host`` and the partitions' ``full_state`` keep it one.

``load_checkpoint`` also reads the JAX package's own checkpoints (flax
msgpack of ``{"params", "opt_state", "step", "extra"}``, told apart by
content: ``convert.checkpoint_format``), so a run begun on the TPU resumes
here: ``native_payload`` turns such a file into the port's payload on the
model's names. The weights go through ``convert.native_state_dict`` (the
fused qkv, SCAN_LAYERS' stacks and the pretraining model's ``vlbert.bert``
nesting undone by name); the moments are found by structure in the optax
chain (AdamW's and Adam's ``mu`` / ``nu``, SGD's momentum ``trace``) and
mapped by the same rules. Under TPU.MASKED_OPT_STATE the moments sit one
``inner_state`` level down and a frozen leaf's are an empty map: a
trained parameter without a moment there starts from zeros, as
``_reconcile_masked_opt_state`` gives a dense target. ``count`` is the
file's ``step``, the plateau scale its ``plateau_scale`` leaf, and
``extra`` (``best_val``, ``plateau``) is read as plain numbers. The port
still saves its own torch format.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading

import torch

from vlbert_tpu_torch.parallel import dist as dist_lib
from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
from vlbert_tpu_torch.training import jax_format
from vlbert_tpu_torch.training.convert import (apply_reference_prefix_changes,
                                               checkpoint_format,
                                               flatten_tree, moments_from_jax,
                                               native_state_dict,
                                               reference_name,
                                               unstack_layer_params)

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


def snapshot_needs_all_ranks(model):
    """True when a snapshot of ``model`` is collective (its parameters
    are sharded across ranks, by FSDP2 or tensor parallelism): every rank
    must enter ``save_checkpoint`` and ``load_checkpoint``."""
    return dist_lib.partition_of(model).collective


def snapshot(model, optimizer):
    """(state_dict, optimizer state) as CPU copies: the caller's next step
    updates the live tensors in place. Of a sharded model, collective:
    every tensor gathered whole in one fixed order, the copies on rank 0
    and (None, None) on the others."""
    sd, opt = model.state_dict(), optimizer.state_dict()
    if not snapshot_needs_all_ranks(model):
        return _to_host(sd), _to_host(opt)
    nu = opt["nu"] or {}
    full = dist_lib.partition_of(model).full_state(
        list(sd) + list(opt["mu"]) + list(nu),
        list(sd.values()) + list(opt["mu"].values()) + list(nu.values()))
    if full is None:
        return None, None
    it = iter(full)
    sd = {k: next(it) for k in sd}
    opt = {**opt, "mu": {k: next(it) for k in opt["mu"]},
           "nu": {k: next(it) for k in nu} if opt["nu"] is not None
           else None}
    return sd, opt


def save_checkpoint(prefix, epoch, model, optimizer, extra=None,
                    async_write=False, mirror_best_to=None, write=True):
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

    Of a sharded model every rank calls it (``snapshot``), with ``write``
    true on rank 0 alone; the others gather and return.
    """
    global _pending_save
    wait_for_pending_save()
    state_dict, opt_state = snapshot(model, optimizer)
    path = f"{prefix}-{epoch:04d}.model"
    if not write:
        return path
    payload = {"state_dict": state_dict, "optimizer": opt_state,
               "step": int(optimizer.count), "extra": dict(extra or {})}
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
    """Read a checkpoint the port or the JAX package wrote. Without
    ``model`` returns the payload (a JAX file's decoded tree); with it,
    loads the weights (every key, strictly) and, given ``optimizer``, the
    optimizer state, and returns the ``extra`` dict. A sharded model:
    collective, rank 0 alone reads ``path``."""
    wait_for_pending_save()              # read-after-async-write safety
    if model is not None and snapshot_needs_all_ranks(model):
        return _load_sharded(path, model, optimizer)
    if model is None and checkpoint_format(path) == "native":
        return jax_format.load(path)
    payload = read_payload(path, model, optimizer)
    if model is None:
        return payload
    model.load_state_dict(payload["state_dict"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
        _check_step(path, optimizer, payload["step"])
    return payload.get("extra", {})


def read_payload(path, model=None, optimizer=None):
    """The checkpoint at ``path`` as the port's payload ({"state_dict",
    "optimizer", "step", "extra"}): a torch file as saved, a JAX-native
    one through ``native_payload`` onto ``model`` and ``optimizer``."""
    if checkpoint_format(path) != "native":
        return torch.load(path, map_location="cpu", weights_only=True)
    return native_payload(jax_format.load(path), model, optimizer)


def native_payload(tree, model, optimizer=None):
    """A JAX checkpoint's decoded tree -> the port's payload for ``model``
    (its whole shapes, when its tensors are split across ranks) and
    ``optimizer`` (None leaves ``optimizer`` None)."""
    partition = dist_lib.partition_of(model)
    shapes = {n: partition.full_shape(n, t)
              for n, t in model.state_dict().items()}
    step = int(tree["step"])
    opt = None if optimizer is None else native_optimizer_state(
        tree["opt_state"], model, optimizer, step)
    return {"state_dict": native_state_dict(tree, model, shapes=shapes),
            "optimizer": opt, "step": step,
            "extra": _plain(tree.get("extra") or {})}


def _plain(obj):
    """Decoded ``extra``: 0-d tensors (numpy scalars in the file) as
    Python numbers."""
    if isinstance(obj, torch.Tensor):
        return obj.item() if obj.dim() == 0 else obj
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


def _optax_states(node, masked=False, found=None):
    """{"adam": (ScaleByAdamState, masked), "trace": (TraceState, masked),
    "plateau": scale}: what the JAX package's optax chain (saved as
    {"0": ..., "1": ...}) holds, found by structure; ``masked`` when it
    sits under ``optax.masked``'s ``inner_state``."""
    found = {} if found is None else found
    if not isinstance(node, dict):
        return found
    if "mu" in node and "nu" in node:
        found.setdefault("adam", (node, masked))
    elif "trace" in node:
        found.setdefault("trace", (node, masked))
    else:
        if "plateau_scale" in node:
            found.setdefault("plateau", node["plateau_scale"])
        for k, v in node.items():
            _optax_states(v, masked or k == "inner_state", found)
    return found


def native_optimizer_state(opt_state, model, optimizer, step):
    """A JAX checkpoint's ``opt_state`` -> ``optimizer.state_dict()``'s
    layout: the moments of ``optimizer``'s parameters on their names,
    ``count`` the file's ``step`` and the plateau scale."""
    found = _optax_states(opt_state)
    kind = "trace" if optimizer.kind == "SGD" else "adam"
    if kind not in found:
        raise ValueError(
            f"TRAIN.OPTIMIZER {optimizer.kind}: the JAX checkpoint's "
            f"optimizer state holds {sorted(set(found) - {'plateau'})} "
            f"moments, not {kind}'s")
    node, masked = found[kind]
    shapes = dict(zip(optimizer.names, optimizer.full_shapes()))

    def moments(tree):
        flat = unstack_layer_params(flatten_tree(tree))
        out, missing = moments_from_jax(flat, model, shapes)
        if missing and not masked:
            raise KeyError(f"the JAX checkpoint has no moment for "
                           f"{missing[:5]}")
        # masked layout: a leaf JAX froze carries no moment
        for n in missing:
            out[n] = torch.zeros(shapes[n])
        return out

    if kind == "adam":
        if int(node["count"]) != step:
            raise ValueError(f"JAX checkpoint: Adam count "
                             f"{int(node['count'])} != step {step}")
        mu, nu = moments(node["mu"]), moments(node["nu"])
    else:
        mu, nu = moments(node["trace"]), None
    return {"mu": mu, "nu": nu, "count": step,
            "plateau_scale": float(found.get("plateau", 1.0))}


def _check_step(path, optimizer, step):
    if optimizer.count != step:
        raise ValueError(f"{path}: optimizer count {optimizer.count} "
                         f"!= step {step}")


def _load_sharded(path, model, optimizer):
    """``load_checkpoint`` into a model sharded by FSDP2 or tensor
    parallelism: rank 0 reads the file and checks its keys against the
    model's (strictly, as ``load_state_dict``); each rank keeps its shard
    of every tensor. A failure on rank 0 raises on every rank."""
    targets = model.state_dict(keep_vars=True)
    # the tied decoder is the word embedding: loaded once, under its name
    names, seen = [], set()
    for k, t in targets.items():
        if id(t) not in seen:
            seen.add(id(t))
            names.append(k)
    box = {}

    def read():                          # rank 0 alone
        payload = read_payload(path, model, optimizer)
        sd = payload["state_dict"]
        missing, unexpected = set(targets) - set(sd), set(sd) - set(targets)
        if missing or unexpected:
            raise RuntimeError(
                f"{path}: state_dict does not match the model: missing "
                f"{sorted(missing)[:5]}, unexpected {sorted(unexpected)[:5]}")
        box.update(payload=payload, full=[sd[k] for k in names])
        return payload["step"], payload.get("extra", {})

    step, extra = dist_lib.from_rank0(read)
    dist_lib.partition_of(model).load_full_state_(
        names, [targets[k] for k in names], box.get("full"))
    if optimizer is not None:
        payload = box.get("payload")
        optimizer.load_state_dict(payload and payload["optimizer"])
        _check_step(path, optimizer, step)
    return extra


def _newest(prefix, end_epoch):
    """(path, epoch) of the newest {prefix}-{epoch:04d}.model below
    ``end_epoch``, scanning downward; (None, -1) when there is none."""
    for epoch in range(end_epoch - 1, -1, -1):
        path = f"{prefix}-{epoch:04d}.model"
        if os.path.exists(path):
            return path, epoch
    return None, -1


def auto_resume(prefix, model, optimizer, end_epoch):
    """Scan from end_epoch downward for the newest checkpoint
    (ref: common/utils/load.py:32-54). Returns (begin_epoch, extra)."""
    path, epoch = _newest(prefix, end_epoch)
    if path is None:
        return 0, {}
    extra = load_checkpoint(path, model, optimizer)
    logger.info("auto-resumed from %s (begin_epoch=%d)", path, epoch + 1)
    return epoch + 1, extra


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
            # a sharded parameter keeps its own shard of the file's
            # tensor (every rank has read the file)
            fsdp_lib.copy_shard_(target[k], v)
            loaded.append(k)
    if missing:
        logger.warning("partial_load: %d keys not in model (e.g. %s)",
                       len(missing), missing[:5])
    if mismatched:
        logger.warning("partial_load: shape mismatches: %s", mismatched[:5])
    logger.info("partial_load: loaded %d/%d keys", len(loaded), len(target))
    return loaded, missing, mismatched


def resume_target(prefix, config):
    """(path, begin_epoch) that ``smart_resume`` resumes from: under
    TRAIN.RESUME {prefix}-{BEGIN_EPOCH-1:04d}.model, under AUTO_RESUME the
    newest {prefix}-{epoch:04d}.model below END_EPOCH (path None when there
    is none: begin 0), else (None, BEGIN_EPOCH)."""
    t = config.TRAIN
    if t.RESUME:
        if t.BEGIN_EPOCH < 1:
            raise ValueError(
                "TRAIN.RESUME requires TRAIN.BEGIN_EPOCH >= 1 (the epoch to "
                "resume INTO; the checkpoint {prefix}-{BEGIN_EPOCH-1:04d}"
                ".model is loaded) — got BEGIN_EPOCH="
                f"{t.BEGIN_EPOCH}")
        return f"{prefix}-{t.BEGIN_EPOCH - 1:04d}.model", t.BEGIN_EPOCH
    if t.AUTO_RESUME:
        path, epoch = _newest(prefix, t.END_EPOCH)
        return path, epoch + 1
    return None, t.BEGIN_EPOCH


def smart_resume(prefix, model, optimizer, config):
    """Explicit + auto resume (ref: common/utils/load.py:20-54):
    TRAIN.RESUME loads {prefix}-{BEGIN_EPOCH-1:04d}.model; otherwise
    AUTO_RESUME scans downward. Returns (begin_epoch, extra)."""
    path, begin_epoch = resume_target(prefix, config)
    if path is None:
        return begin_epoch, {}
    extra = load_checkpoint(path, model, optimizer)
    logger.info("resumed from %s (begin_epoch=%d)", path, begin_epoch)
    return begin_epoch, extra


def has_resumable_checkpoint(prefix, config):
    """True iff smart_resume would restore a checkpoint — used to skip the
    warm-start loads, which the resume overwrites, on a restart."""
    t = config.TRAIN
    if t.RESUME:
        return os.path.exists(f"{prefix}-{t.BEGIN_EPOCH - 1:04d}.model")
    if t.AUTO_RESUME:
        return _newest(prefix, t.END_EPOCH)[0] is not None
    return False
