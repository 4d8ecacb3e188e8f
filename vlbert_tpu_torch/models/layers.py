"""Layers that keep fp32 parameters and compute in a chosen dtype.

The JAX package builds every Dense/Conv/Embed with fp32 params and a
compute ``dtype`` (bf16 when serving): the weights are cast at the op, and
the op's output has the compute dtype. These subclasses do the same in
PyTorch while keeping the torch parameter names (``weight``, ``bias``) that
checkpoint conversion relies on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def cast(t, dtype):
    return t if t is None or t.dtype == dtype else t.to(dtype)


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, *,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return F.linear(cast(x, d), cast(self.weight, d), cast(self.bias, d))


class Conv2d(nn.Conv2d):
    """Bias-free conv with the JAX package's padding rule,
    ``dilation * (k - 1) // 2`` on each side."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, dilation=1, *,
                 dtype=torch.float32, device=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=dilation * (kernel - 1) // 2,
                         dilation=dilation, bias=False, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return self._conv_forward(cast(x, d), cast(self.weight, d), None)


class Embedding(nn.Embedding):
    def __init__(self, num, dim, *, dtype=torch.float32, device=None):
        super().__init__(num, dim, device=device)
        self.compute_dtype = dtype

    def forward(self, ids):
        return cast(F.embedding(ids, self.weight), self.compute_dtype)


@torch.no_grad()
def init_weights(module, generator, initializer_range=0.02):
    """Random weights from an explicit generator, with the JAX package's
    initializers: normal(initializer_range) for dense and embedding
    tables with zero biases, He normal (fan_out) for convolutions.
    LayerNorm, frozen-BN and scalar parameters keep their constructed
    values. ``generator`` must live on the parameters' device."""
    for m in module.modules():
        if isinstance(m, (Linear, Embedding)):
            m.weight.normal_(0.0, initializer_range, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                             generator=generator)
