"""Layers that keep fp32 parameters and compute in a chosen dtype.

The JAX package builds every Dense/Conv/Embed with fp32 params and a
compute ``dtype`` (bf16 when serving): the weights are cast at the op, and
the op's output has the compute dtype. These subclasses do the same in
PyTorch while keeping the torch parameter names (``weight``, ``bias``) that
checkpoint conversion relies on.

``Linear`` and ``Conv2d`` also take a weight-only int8 state for serving
(``ops/quant.py``): ``quantize_int8_`` replaces the fp32 ``weight``
Parameter by an int8 buffer of the same name and an fp32 ``weight_scale``
buffer, and the op dequantizes it in the JAX package's order,
``(q.to(float32) * scale).to(compute_dtype)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vlbert_tpu_torch.ops.quant import MIN_SIZE, quantize_leaf, should_quantize


def cast(t, dtype):
    return t if t is None or t.dtype == dtype else t.to(dtype)


class _Int8Weight:
    """The int8 state of a Linear or Conv2d weight. A floating-point
    ``weight`` loaded into a quantized layer is quantized on the way in,
    and an int8 one loaded into an fp32 layer turns it int8 first, so
    neither is copied across dtypes."""

    @property
    def quantized(self):
        return self.weight.dtype == torch.int8

    def quantize_int8_(self, min_size=MIN_SIZE):
        """Quantize the weight in place if ``should_quantize`` selects it.
        Returns whether it did."""
        if self.quantized or not should_quantize(self.weight, min_size):
            return False
        q, scale = quantize_leaf(self.weight.detach().cpu().numpy())
        self._set_int8(torch.from_numpy(q), torch.from_numpy(scale))
        return True

    def _set_int8(self, q, scale):
        device = self.weight.device
        del self.weight
        self.register_buffer("weight", q.to(device))
        self.register_buffer("weight_scale", scale.to(device))

    def op_weight(self, dtype):
        """The weight as the op takes it, in ``dtype``."""
        if self.quantized:
            return (self.weight.to(torch.float32)
                    * self.weight_scale).to(dtype)
        return cast(self.weight, dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        if w is not None and self.quantized and w.is_floating_point():
            q, scale = quantize_leaf(w.detach().cpu().numpy())
            state_dict[prefix + "weight"] = torch.from_numpy(q)
            state_dict[prefix + "weight_scale"] = torch.from_numpy(scale)
        elif w is not None and not self.quantized \
                and w.dtype == torch.int8:
            scale_shape = (w.shape[0],) + (1,) * (w.dim() - 1)
            self._set_int8(torch.zeros_like(w),
                           torch.zeros(scale_shape, dtype=torch.float32))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Linear(_Int8Weight, nn.Linear):
    def __init__(self, in_features, out_features, bias=True, *,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return F.linear(cast(x, d), self.op_weight(d), cast(self.bias, d))


class Conv2d(_Int8Weight, nn.Conv2d):
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
        return self._conv_forward(cast(x, d), self.op_weight(d), None)


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
