"""Optimizers, LR schedules and parameter groups (port of
vlbert_tpu/training/optim.py, which builds optax chains).

The update rule is applied in the JAX package's order:

    clip by global norm -> [coupled WD for SGD/Adam] -> moments (Adam: b1
    0.9, b2 0.999, bias corrected) -> [decoupled WD for AdamW] -> LR_MULT
    multiplier -> -lr(step) -> [plateau scale]

over the parameters with ``requires_grad``; ``apply_trainable_mask`` sets
that flag from the JAX package's freezing rules, so frozen parameters get
neither gradient nor weight decay. Schedules are plain Python functions of
the optimizer step (no device sync).

The moments are made from the parameters as each rank holds them; the
module's partition (``parallel/dist.py::partition_of``: dp, fsdp or tp)
gives the clip's norm, the whole shapes and, where it is collective, a
resume in which each rank takes its part of the file's whole moments.
The LR scales with the world size, as the JAX package's does (its
device count), whatever the mesh.
"""

from __future__ import annotations

import re

import torch

from vlbert_tpu_torch.parallel import dist as dist_lib


# ---------------------------------------------------------------- schedules

def make_lr_schedule(config, steps_per_epoch, world_size=1):
    """(schedule, base_lr): schedule(step) -> lr, in optimizer steps.

    base_lr = TRAIN.LR x world size x per-device batch x accumulation. For
    'plateau' the schedule is constant; the host scales it
    (``ReduceLROnPlateau``)."""
    t = config.TRAIN
    accum = max(int(t.GRAD_ACCUMULATE_STEPS), 1)
    batch_size = t.BATCH_IMAGES
    if isinstance(batch_size, (list, tuple)):
        batch_size = sum(batch_size)
    base_lr = t.LR * world_size * batch_size * accum
    warmup_iters = t.WARMUP_STEPS if t.WARMUP else 0

    if t.LR_SCHEDULE == "step":
        milestones = [int(e * steps_per_epoch) for e in t.LR_STEP]

        def sched(step):
            lr = base_lr
            if warmup_iters > 0:
                alpha = min(step / warmup_iters, 1.0)
                if t.WARMUP_METHOD == "linear":
                    lr *= t.WARMUP_FACTOR * (1 - alpha) + alpha
                elif step < warmup_iters:            # constant
                    lr *= t.WARMUP_FACTOR
            for m in milestones:
                if step >= m:
                    lr *= t.LR_FACTOR
            return lr

        return sched, base_lr

    if t.LR_SCHEDULE == "triangle":
        t_total = int(t.END_EPOCH * steps_per_epoch)

        def sched(step):
            if step < warmup_iters:
                return base_lr * step / max(warmup_iters, 1)
            return base_lr * max((t_total - step)
                                 / max(t_total - warmup_iters, 1.0), 0.0)

        return sched, base_lr

    if t.LR_SCHEDULE == "plateau":
        return (lambda step: base_lr), base_lr

    raise ValueError(f"unsupported LR_SCHEDULE {t.LR_SCHEDULE!r}")


class ReduceLROnPlateau:
    """Host-side plateau detector with torch's semantics at the reference's
    settings (mode 'max', factor LR_FACTOR, patience 1, threshold 1e-4
    'rel', cooldown 2). ``step(metric)`` returns the LR scale."""

    def __init__(self, factor, patience=1, threshold=1e-4, cooldown=2):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.best = float("-inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def step(self, value):
        if value > self.best * (1.0 + self.threshold):
            self.best = value
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.scale *= self.factor
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self):
        return {k: getattr(self, k) for k in
                ("best", "num_bad_epochs", "cooldown_counter", "scale")}

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)


# ------------------------------------------------------------- param groups

def lr_group_rules(config):
    """[(substring, mult), ...]: TRAIN.LR_MULT plus the visual-scale
    groups. First match wins; unmatched parameters take 1.0."""
    t = config.TRAIN
    rules = list(t.LR_MULT)
    for key, name in (("VISUAL_SCALE_TEXT_LR_MULT", "visual_scale_text"),
                      ("VISUAL_SCALE_OBJECT_LR_MULT", "visual_scale_object")):
        mult = t.get(key, 1.0)
        if mult != 1.0:
            rules.insert(0, (name, mult))
    return rules


def lr_mult(name, rules):
    for key, m in rules:
        if key in name:
            return float(m)
    return 1.0


_BN = re.compile(r"\.(bn\d|downsample\.1)\.")


def is_trainable(name, config):
    """False for the parameters the reference freezes: BN affine under
    IMAGE_FROZEN_BN, IMAGE_FROZEN_BACKBONE_STAGES (1 = stem, 2-4 =
    layer1-3, 5 = the conv5 RoI head), word embeddings under
    word_embedding_frozen (not the special-word table), position
    embeddings under pos_embedding_frozen, visual scales under BLIND."""
    net = config.NETWORK
    backbone = ".backbone." in f".{name}"
    roi_head = "roi_head_feature_extractor." in name
    if net.IMAGE_FROZEN_BN and (backbone or roi_head) and _BN.search(name):
        return False
    for s in net.IMAGE_FROZEN_BACKBONE_STAGES:
        if s == 1 and re.search(r"backbone\.(conv1|bn1)\.", name):
            return False
        if 2 <= s <= 4 and f"backbone.layer{s - 1}." in name:
            return False
        if s == 5 and roi_head:
            return False
    if net.VLBERT.word_embedding_frozen and "word_embeddings" in name \
            and "special" not in name:
        return False
    if net.VLBERT.get("pos_embedding_frozen", False) \
            and "position_embeddings" in name:
        return False
    if net.get("BLIND", False) and ("visual_scale_text" in name
                                    or "visual_scale_object" in name):
        return False
    return True


def apply_trainable_mask(module, config):
    """Set ``requires_grad`` from ``is_trainable``; returns the frozen
    names."""
    frozen = []
    for name, p in module.named_parameters():
        p.requires_grad_(is_trainable(name, config))
        if not p.requires_grad:
            frozen.append(name)
    return frozen


# ---------------------------------------------------------------- optimizer

class Optimizer:
    """The JAX package's optax chain over ``module``'s trainable
    parameters. ``step(grads)`` applies one update in place; ``count`` is
    the number of steps taken (the schedule's step). ``state_dict()`` holds
    the moments keyed by parameter name, ``count`` and ``plateau_scale``;
    a resume that did not restore ``count`` would restart the schedule."""

    def __init__(self, config, module, steps_per_epoch, world_size=1):
        t = config.TRAIN
        if t.OPTIMIZER not in ("AdamW", "Adam", "SGD"):
            raise ValueError(f"unsupported optimizer {t.OPTIMIZER!r}")
        self.kind = t.OPTIMIZER
        self.sched, self.base_lr = make_lr_schedule(config, steps_per_epoch,
                                                    world_size)
        rules = lr_group_rules(config)
        named = [(n, p) for n, p in module.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        # how the parameters are held across ranks (dp, fsdp, tp)
        self.partition = dist_lib.partition_of(module)
        self.mults = [lr_mult(n, rules) for n in self.names]
        self.clip = float(t.CLIP_GRAD_NORM or 0.0)
        self.wd = float(t.WD or 0.0)
        self.momentum = float(t.get("MOMENTUM", 0.9))
        self.eps = 1e-6 if self.kind == "AdamW" else 1e-8
        self.b1, self.b2 = 0.9, 0.999
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = ([torch.zeros_like(p, dtype=torch.float32)
                    for p in self.params] if self.kind != "SGD" else None)
        self.count = 0
        self.plateau_scale = 1.0

    def state_dict(self):
        """{"mu": {name: moment}, "nu": {name: moment} or None, "count",
        "plateau_scale"}; the tensors are the live ones."""
        nu = None if self.nu is None else dict(zip(self.names, self.nu))
        return {"mu": dict(zip(self.names, self.mu)), "nu": nu,
                "count": self.count, "plateau_scale": self.plateau_scale}

    def full_shapes(self):
        """Each trained parameter's whole shape (a tensor-parallel shard's
        before its split; FSDP2's DTensors have it)."""
        return [self.partition.full_shape(n, p)
                for n, p in zip(self.names, self.params)]

    @torch.no_grad()
    def load_state_dict(self, d):
        """Restore moments by parameter name; raises on a missing or
        misshaped moment. Moments sharded by FSDP2 (``parallel/fsdp.py``)
        or split by tensor parallelism (``parallel/tp.py``): collective,
        ``d`` is rank 0's (None on the other ranks) and each rank keeps its
        part."""
        live = self.mu + (self.nu or [])
        if self.partition.collective:
            box = {}

            def read():             # rank 0 alone
                box["full"] = self._moments_of(d)
                return int(d["count"]), float(d["plateau_scale"])

            count, scale = dist_lib.from_rank0(read)
            self.partition.load_full_state_(
                self.names * (len(live) // len(self.params)), live,
                box.get("full"))
        else:
            for m, saved in zip(live, self._moments_of(d)):
                m.copy_(saved)
            count, scale = int(d["count"]), float(d["plateau_scale"])
        self.count, self.plateau_scale = count, scale

    def _moments_of(self, d):
        """``d``'s moments in the order of ``self.mu + self.nu``."""
        out = []
        for key, live in (("mu", self.mu), ("nu", self.nu)):
            if live is None:
                continue
            saved = d.get(key) or {}
            for name, shape in zip(self.names, self.full_shapes()):
                if name not in saved:
                    raise KeyError(f"optimizer state has no {key} for {name}")
                if tuple(saved[name].shape) != tuple(shape):
                    raise ValueError(
                        f"optimizer {key} of {name}: shape "
                        f"{tuple(saved[name].shape)}, parameter "
                        f"{tuple(shape)}")
                out.append(saved[name])
        return out

    def lr(self):
        """The learning rate the next step uses."""
        return self.sched(self.count) * self.plateau_scale

    @torch.no_grad()
    def step(self, grads):
        """grads: fp32 tensors aligned with ``self.params``. Returns their
        global norm before clipping."""
        u = [g.to(torch.float32) for g in grads]
        norm = self.partition.norm(self.names, u)
        if self.clip > 0:
            # optax's clip_by_global_norm: g / norm * max when norm >= max
            factor = torch.where(norm < self.clip, torch.ones_like(norm),
                                 self.clip / norm)
            torch._foreach_mul_(u, factor)
        if self.kind != "AdamW" and self.wd:
            torch._foreach_add_(u, self.params, alpha=self.wd)
        if self.kind == "SGD":
            torch._foreach_mul_(self.mu, self.momentum)
            torch._foreach_add_(self.mu, u)
            u = [m.clone() for m in self.mu]
        else:
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, u, alpha=1.0 - self.b1)
            torch._foreach_mul_(self.nu, self.b2)
            torch._foreach_addcmul_(self.nu, u, u, value=1.0 - self.b2)
            n = self.count + 1
            den = torch._foreach_div(self.nu, 1.0 - self.b2 ** n)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(self.mu, 1.0 - self.b1 ** n)
            torch._foreach_div_(u, den)
        if self.kind == "AdamW" and self.wd:
            torch._foreach_add_(u, self.params, alpha=self.wd)
        torch._foreach_mul_(u, self.mults)
        torch._foreach_mul_(u, -self.lr())
        torch._foreach_add_(self.params, u)
        self.count += 1
        return norm

