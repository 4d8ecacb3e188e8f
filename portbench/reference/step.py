"""The reference's training steps: the trained leaves, the learning-rate
schedule and the optimizer update, in float32 on the weights the
benchmark made, over the batches and step seeds the program's first
steps took.

The update follows the configuration: the gradient clipped by its global
norm; SGD with momentum and coupled weight decay; times the learning rate
of the step's schedule ("step" milestones or the "triangle" decay, no
warm-up). Frozen leaves take no gradient: BN affine under
IMAGE_FROZEN_BN, the stem and stages in IMAGE_FROZEN_BACKBONE_STAGES.
"""

from __future__ import annotations

import contextlib
import re

import torch

from portbench.reference import model, ops

_BN = re.compile(r"\.(bn\d|downsample\.1)\.")


def is_trained(name, net):
    """Whether the configuration trains the leaf ``name``."""
    visual = name.startswith(model.VISUAL + "backbone.") \
        or name.startswith(model.VISUAL + "roi_head_feature_extractor.")
    if net["IMAGE_FROZEN_BN"] and visual and _BN.search(name):
        return False
    for s in net["IMAGE_FROZEN_BACKBONE_STAGES"]:
        if s == 1 and re.search(r"backbone\.(conv1|bn1)\.", name):
            return False
        if 2 <= s <= 4 and f"backbone.layer{s - 1}." in name:
            return False
        if s == 5 and "roi_head_feature_extractor." in name:
            return False
    return True


def check_supported(cfg, task):
    """The reference computes VCR from pixels as this benchmark's
    configurations state it; anything else is refused rather than
    computed wrongly."""
    if task != "vcr":
        raise ValueError(f"the reference does not compute task {task!r}")
    net, vl, train = cfg["NETWORK"], cfg["NETWORK"]["VLBERT"], cfg["TRAIN"]
    want = {"CLASSIFIER_TYPE": "1fc", "CLASSIFIER_SIGMOID": True,
            "ENABLE_CNN_REG_LOSS": True, "CNN_LOSS_TOP": True,
            "IMAGE_FEAT_PRECOMPUTED": False, "IMAGE_SEMANTIC": False,
            "IMAGE_C5_DILATED": True}
    bad = {k: net.get(k) for k, v in want.items() if net.get(k) != v}
    if vl["object_word_embed_mode"] != 2:
        bad["object_word_embed_mode"] = vl["object_word_embed_mode"]
    for k in ("visual_ln", "with_pooler"):
        if not vl.get(k):
            bad[k] = vl.get(k)
    if vl["visual_size"] != vl["hidden_size"] or \
            vl.get("word_embedding_frozen"):
        bad["visual_size / word_embedding_frozen"] = True
    if int(train["GRAD_ACCUMULATE_STEPS"]) != 1 or train["WARMUP"] \
            or train["LR_MULT"]:
        bad["GRAD_ACCUMULATE_STEPS / WARMUP / LR_MULT"] = True
    if bad:
        raise ValueError(f"the reference does not compute {task} with {bad}")


def lr_schedule(cfg, steps_per_epoch):
    """lr(step) of the configuration on one card."""
    t = cfg["TRAIN"]
    base = t["LR"] * t["BATCH_IMAGES"]
    if t["LR_SCHEDULE"] == "step":
        marks = [int(float(e) * steps_per_epoch)
                 for e in str(t["LR_STEP"]).split(",")]
        return lambda step: base * t["LR_FACTOR"] ** sum(step >= m
                                                         for m in marks)
    if t["LR_SCHEDULE"] == "triangle":
        total = int(t["END_EPOCH"] * steps_per_epoch)
        return lambda step: base * max((total - step) / max(total, 1.0), 0.0)
    raise ValueError(f"LR_SCHEDULE {t['LR_SCHEDULE']!r}")


class Optimizer:
    def __init__(self, cfg, names, params, steps_per_epoch):
        t = cfg["TRAIN"]
        self.kind = t["OPTIMIZER"]
        if self.kind != "SGD":
            raise ValueError(f"optimizer {self.kind!r}")
        self.names, self.params = names, params
        self.lr = lr_schedule(cfg, steps_per_epoch)
        self.clip = float(t["CLIP_GRAD_NORM"])
        self.wd = float(t["WD"])
        self.momentum = float(t.get("MOMENTUM", 0.9))
        self.mu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        """Applies the update; returns the gradient as the optimizer got
        it, before its clip."""
        g = [p.grad for p in self.params]
        got = [x.clone() for x in g]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(x) for x in g]))
        if self.clip > 0 and norm >= self.clip:
            g = [x * (self.clip / norm) for x in g]
        lr = self.lr(self.count)
        for i, p in enumerate(self.params):
            self.mu[i].mul_(self.momentum).add_(g[i] + self.wd * p)
            p.add_(self.mu[i], alpha=-lr)
            p.grad = None
        self.count += 1
        return got


def leaf_norms(tensors):
    return [float(torch.linalg.vector_norm(t)) for t in tensors]


def run_steps(weights, cfg, task, batches, seeds, steps_per_epoch,
              lower=False):
    """The reference's steps from ``weights`` ({name: tensor}, float32 on
    the card) over ``batches`` (tuples of device tensors) under ``seeds``.
    Returns {"loss": [...], "grad": {leaf: norm of the first step's
    gradient before the clip}, "change": {leaf: norm of the change over
    the steps}}. ``lower``: every product in float8 (the control)."""
    check_supported(cfg, task)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _steps(weights, cfg, task, batches, seeds, steps_per_epoch,
                      lower)
    finally:
        # the program's settings, for whatever runs after the reference
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _steps(weights, cfg, task, batches, seeds, steps_per_epoch, lower):
    net = cfg["NETWORK"]
    w = {k: v.detach().clone().to(torch.float32) for k, v in weights.items()}
    names = [k for k in w if is_trained(k, net)
             and not k.endswith(("running_mean", "running_var"))]
    params = [w[k].requires_grad_(True) for k in names]
    start = [p.detach().clone() for p in params]
    opt = Optimizer(cfg, names, params, steps_per_epoch)
    out = {"loss": []}
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        with ops.lower_precision() if lower else contextlib.nullcontext():
            loss = model.loss_and_backward(w, cfg, task, batch, seed)
        out["loss"].append(float(loss))
        got = opt.step()
        if i == 0:
            out["grad"] = dict(zip(names, leaf_norms(got)))
        del got
    out["change"] = dict(zip(names, leaf_norms(
        [p.detach() - s for p, s in zip(params, start)])))
    return out
