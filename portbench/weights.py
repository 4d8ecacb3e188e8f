"""Random weights made from the run's seed, on the card, in one draw.

The initializers are the configuration's: normal(0, initializer_range) for
dense and embedding tables, He normal (fan out) for convolutions, zero
biases, LayerNorm scales 1 (the visual LayerNorms at their configured
initial scale), frozen BN as the identity affine with zero mean and unit
variance. Every normal leaf is cut from one ``randn`` of their total size
in name order, so the same seed gives the same weights on every run, and
the benchmark hands the same tensors to the program and the reference.
"""

from __future__ import annotations

import math

import torch


def _std(name, shape, vl):
    if len(shape) == 4:
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if len(shape) == 2:
        return float(vl["initializer_range"])
    return None


def _constant(name, vl):
    if name.endswith(("running_mean", ".bias")):
        return 0.0
    if "visual_ln_text" in name:
        return float(vl["visual_scale_text_init"])
    if "visual_ln_object" in name:
        return float(vl["visual_scale_object_init"])
    return 1.0


def make(shapes, cfg, seed, device):
    """{name: float32 tensor} for ``shapes`` ({name: shape})."""
    vl = cfg["NETWORK"]["VLBERT"]
    normal = sorted(n for n, s in shapes.items() if _std(n, s, vl))
    total = sum(math.prod(shapes[n]) for n in normal)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n in normal:
        size = math.prod(shapes[n])
        out[n] = draw[at:at + size].view(shapes[n]) * _std(n, shapes[n], vl)
        at += size
    for n, s in shapes.items():
        if n not in out:
            out[n] = torch.full(s, _constant(n, vl), device=device)
    return out


@torch.no_grad()
def load_into(module, weights):
    """Copy ``weights`` into the module's parameters and frozen-BN
    statistics; the two name sets and every shape must agree exactly."""
    state = dict(module.named_parameters())
    state.update((n, b) for n, b in module.named_buffers()
                 if n.endswith(("running_mean", "running_var")))
    missing = sorted(set(weights) - set(state))
    extra = sorted(set(state) - set(weights))
    if missing or extra:
        raise ValueError(f"the program's model does not hold the "
                         f"configuration's leaves: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for n, t in state.items():
        if tuple(t.shape) != tuple(weights[n].shape):
            raise ValueError(f"{n}: program {tuple(t.shape)}, configuration "
                             f"{tuple(weights[n].shape)}")
        t.copy_(weights[n])
