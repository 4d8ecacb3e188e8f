"""Train step and host training loop (port of vlbert_tpu/training/loop.py).

One optimizer step is ``make_train_step``'s closure: the loader's flat
[accum * micro, ...] batch is split into ``grad_accum`` microbatches, each
runs forward and backward under its own dropout seed (the step's seed
folded with the microbatch index), the summed gradients are averaged, the
pre-clip global norm is recorded, and the optimizer applies the update.
Frozen parameters have ``requires_grad`` off, so they get no gradient and
no update. A non-finite loss raises.

``fit`` keeps the reference's epoch structure: set_epoch shuffling, one
seed per step from the trainer's ``torch.Generator``, Speedometer logging,
per-epoch validation, plateau LR stepping from the validation metric, and
``checkpoint_fn`` on CHECKPOINT_FREQUENT epochs and on every best-val
epoch. On a resume the caller passes the checkpoint's ``best_val`` and
plateau state; the dropout seeds restart from the trainer's seed, as the
JAX package's do.
"""

from __future__ import annotations

import logging
import time

import torch

from vlbert_tpu_torch.ops.dropout import dropout_seeds, fold_in
from vlbert_tpu_torch.training import metrics as metrics_lib
from vlbert_tpu_torch.training.optim import ReduceLROnPlateau

logger = logging.getLogger(__name__)


def _split(batch, n):
    if n == 1:
        return [batch]
    for x in batch:
        if x is not None and x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"GRAD_ACCUMULATE_STEPS={n}")
    parts = [x.chunk(n) if x is not None else [None] * n for x in batch]
    return [tuple(p[i] for p in parts) for i in range(n)]


def _add(a, b):
    return {k: (a[k][0] + b[k][0], a[k][1] + b[k][1]) for k in a}


def make_train_step(model, optimizer, task, config, grad_accum=1):
    """Returns ``train_step(batch, seed) -> (loss, device metrics)``.

    batch: tuple of tensors on the model's device (None for absent
    inputs), the labels last; seed: the step's 64-bit dropout seed."""
    params = optimizer.params

    def train_step(batch, seed):
        model.train()
        loss_sum, dm_sum = None, None
        for i, micro in enumerate(_split(batch, grad_accum)):
            with dropout_seeds(seed if grad_accum == 1 else fold_in(seed, i)):
                outputs, loss = model(*micro)
            loss.backward()
            dm = metrics_lib.device_metrics(task, config, outputs)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            dm_sum = dm if dm_sum is None else _add(dm_sum, dm)
        loss = loss_sum / grad_accum
        if not bool(torch.isfinite(loss)):
            raise FloatingPointError(f"non-finite loss {float(loss)} at "
                                     f"step {optimizer.count}")
        # a parameter the forward did not reach has gradient 0 (it still
        # takes weight decay, as in the JAX package)
        grads = [torch.zeros_like(p) if p.grad is None
                 else p.grad / grad_accum if grad_accum > 1 else p.grad
                 for p in params]
        dm_sum["grad_total_norm"] = (optimizer.step(grads), 1)
        for p in params:
            p.grad = None
        return loss, dm_sum

    return train_step


def make_eval_step(model, task, config):
    """Returns ``eval_step(model_inputs, labels, valid) -> device
    metrics``; labels is a dict of label tensors, valid a [B] mask of real
    (not wrap-padded) samples or None."""

    def eval_step(model_inputs, labels, valid=None):
        model.eval()
        with torch.inference_mode():
            outputs = dict(model(*model_inputs))
        outputs.update(labels)
        if valid is not None:
            outputs["valid"] = valid
        return metrics_lib.device_metrics(task, config, outputs)

    return eval_step


def to_device(batch, device):
    return tuple(None if x is None else torch.as_tensor(x).to(device)
                 for x in batch)


class Speedometer:
    """samples/s + ETA logger, every ``frequent`` batches."""

    def __init__(self, batch_size, frequent, batches_per_epoch, epochs):
        self.batch_size = batch_size
        self.frequent = frequent
        self.total_batches = batches_per_epoch * max(epochs, 1)
        self.tic = time.time()
        self.count = 0
        self.global_count = 0

    def __call__(self, epoch, batch_idx, metrics_fmt=""):
        self.count += 1
        self.global_count += 1
        if self.count % self.frequent == 0:
            dt = time.time() - self.tic
            speed = self.frequent * self.batch_size / max(dt, 1e-9)
            remaining = self.total_batches - self.global_count
            eta_h = remaining * dt / self.frequent / 3600
            logger.info("Epoch[%d] Batch [%d]  Speed: %.2f samples/sec  "
                        "ETA: %.2f h  %s", epoch, batch_idx, speed, eta_h,
                        metrics_fmt)
            self.tic = time.time()


class _StepTimer:
    """Per-step time: CUDA events on a card (no sync inside the loop),
    the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self):
        """ms between consecutive marks (start, end) pairs."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks[::2], self.marks[1::2])]
        return [(b - a) * 1e3
                for a, b in zip(self.marks[::2], self.marks[1::2])]


def fit(model, config, task, train_loader, optimizer, *, device,
        seed_generator, val_loader=None, validation_fn=None,
        begin_epoch=None, end_epoch=None, checkpoint_fn=None,
        best_val=None, plateau_state=None):
    """Host training loop. Returns the history: per-step ``loss`` and
    ``step_ms``, per-epoch ``train`` and ``val`` metrics.

    ``checkpoint_fn(model, optimizer, epoch, extra, is_best)`` is called
    after an epoch's validation when ``(epoch + 1) % CHECKPOINT_FREQUENT ==
    0`` or the epoch set a new best validation metric; ``extra`` is
    {"best_val", "plateau"}. ``best_val`` and ``plateau_state`` restore
    those two from a checkpoint's ``extra``."""
    grad_accum = max(int(config.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    train_step = make_train_step(model, optimizer, task, config, grad_accum)
    begin_epoch = config.TRAIN.BEGIN_EPOCH if begin_epoch is None \
        else begin_epoch
    end_epoch = config.TRAIN.END_EPOCH if end_epoch is None else end_epoch
    log_freq = max(config.LOG_FREQUENT, 1)
    batch_images = config.TRAIN.BATCH_IMAGES
    if isinstance(batch_images, (list, tuple)):   # the multitask loaders'
        batch_images = sum(batch_images)
    speedo = Speedometer(batch_images * grad_accum, log_freq,
                         len(train_loader), end_epoch - begin_epoch)
    acc = metrics_lib.HostAccumulator()
    host_metric = metrics_lib.host_metric_name(task, config)
    # restored on resume, so that -best.model never regresses across
    # restarts (ref vcr/function/train.py:267-270)
    best_val = float("-inf") if best_val is None else float(best_val)
    plateau = None
    if config.TRAIN.LR_SCHEDULE == "plateau":
        plateau = ReduceLROnPlateau(factor=config.TRAIN.LR_FACTOR)
        if plateau_state:
            plateau.load_state_dict(plateau_state)
    history = {"loss": [], "step_ms": [], "train": [], "val": []}
    timer = _StepTimer(device)

    for epoch in range(begin_epoch, end_epoch):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        acc.reset()
        for i, batch in enumerate(train_loader):
            batch = to_device(batch, device)
            seed = int(torch.randint(0, 2 ** 63 - 1, (1,),
                                     generator=seed_generator))
            timer.mark()
            loss, dm = train_step(batch, seed)
            timer.mark()
            history["loss"].append(float(loss))
            acc.update(dm)
            speedo(epoch, i, acc.format())
        history["train"].append(acc.get())
        logger.info("Epoch[%d] train: %s", epoch, acc.format())
        is_best = False
        if validation_fn is not None and val_loader is not None \
                and (epoch + 1) % max(config.VAL_FREQUENT, 1) == 0:
            val = validation_fn(val_loader)
            history["val"].append(val)
            logger.info("Epoch[%d] val: %s", epoch, val)
            host_val = float(val.get(host_metric, float("-inf")))
            if host_val > best_val:
                best_val = host_val
                is_best = True
                logger.info("New Best Val %s: %s, Epoch: %d", host_metric,
                            best_val, epoch)
            if plateau is not None:
                optimizer.plateau_scale = plateau.step(host_val)
        # also on best-val epochs between CHECKPOINT_FREQUENT saves, so
        # -best.model never holds stale weights
        on_cadence = (epoch + 1) % max(config.CHECKPOINT_FREQUENT, 1) == 0
        if checkpoint_fn is not None and (on_cadence or is_best):
            extra = {"best_val": best_val}
            if plateau is not None:
                extra["plateau"] = plateau.state_dict()
            checkpoint_fn(model, optimizer, epoch, extra, is_best)
    history["step_ms"] = timer.step_ms()
    return history
