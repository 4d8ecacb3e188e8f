"""Weight-only int8 for serving (port of vlbert_tpu/ops/quant.py).

Matmul and conv weights are kept on the card as per-output-channel
symmetric int8 with an fp32 scale, and dequantized at the op:
``(q.to(float32) * scale).to(compute_dtype)``, the JAX package's order
(its ``dequantize_params`` gives fp32 and the model casts where the weight
is used). The product itself stays ``F.linear`` / cuDNN; the dequant is
plain PyTorch, as it is XLA outside any Pallas kernel in the JAX package.

Selection follows the JAX package's ``_should_quantize``: what it names
``kernel`` (Dense and Conv), with ndim >= 2 and at least ``min_size``
elements. In the port those are the weights of ``models/layers.py``'s
``Linear`` and ``Conv2d``. Embedding tables, biases, LayerNorm and
frozen-BN parameters stay fp32.

Layouts: JAX's kernels are [in, out] and [kh, kw, in, out], the port's
weights [out, in] and [out, in, kh, kw], so the output channel is dim 0
here. ``quantize_leaf`` does the JAX package's arithmetic in numpy fp32
(amax over every axis but the output channel, ``scale = max(amax, 1e-12)
/ 127``, ``q = clip(rint(w / scale), -127, 127)``), so q and scale are
bit-identical to JAX's after the layout transpose. The port keeps q, k and
v apart where JAX may fuse them into one [H, 3H] kernel: per-output-channel
scales are the same either way, and only a ``min_size`` between H^2 and
3 H^2 selects differently.
"""

from __future__ import annotations

import numpy as np
import torch

# the JAX package's default: smaller kernels save nothing worth a fusion
MIN_SIZE = 4096


def quantize_leaf(w):
    """Per-output-channel symmetric int8 of a weight whose output channel
    is axis 0. Returns (q int8, scale fp32) numpy arrays; scale keeps
    every axis, with size 1 on all but axis 0."""
    w = np.asarray(w)
    reduce_axes = tuple(range(1, w.ndim))
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def should_quantize(weight, min_size=MIN_SIZE):
    """The JAX package's ``_should_quantize`` for a Linear / Conv2d
    weight: floating point, ndim >= 2, at least ``min_size`` elements."""
    return (weight.dim() >= 2 and weight.numel() >= min_size
            and weight.is_floating_point())


def quantizable_layers(module):
    """(name, layer) of every Linear and Conv2d in ``module``, the layers
    whose weight the JAX package names ``kernel``."""
    from vlbert_tpu_torch.models.layers import Conv2d, Linear

    return [(n, m) for n, m in module.named_modules()
            if isinstance(m, (Linear, Conv2d))]


def is_quantized(module):
    """Whether any layer of ``module`` holds an int8 weight."""
    return any(m.quantized for _, m in quantizable_layers(module))


@torch.no_grad()
def quantize_module(module, min_size=MIN_SIZE):
    """Quantize ``module``'s Linear and Conv2d weights in place, each
    that ``should_quantize`` selects. A module that already holds int8
    weights is left as it is, as the JAX servers leave a quantized tree.
    Returns the names of the layers quantized by this call."""
    if is_quantized(module):
        return []
    return [n for n, m in quantizable_layers(module)
            if m.quantize_int8_(min_size)]


def quantized_bytes(module):
    """Byte accounting as the JAX package's: every parameter and buffer
    at its size, except that an int8 weight counts its bytes plus 4 a
    scale in ``quantized_bytes`` and 4 an element in ``fp32_bytes``."""
    q_bytes = full_bytes = 0
    quantized = [m for _, m in quantizable_layers(module) if m.quantized]
    int8 = {id(m.weight) for m in quantized}
    scales = {id(m.weight_scale) for m in quantized}
    for t in list(module.parameters()) + list(module.buffers()):
        if id(t) in int8:
            q_bytes += t.numel()
            full_bytes += t.numel() * 4
        elif id(t) in scales:
            q_bytes += t.numel() * 4
        else:
            nbytes = t.numel() * t.element_size()
            q_bytes += nbytes
            full_bytes += nbytes
    return {"quantized_bytes": int(q_bytes), "fp32_bytes": int(full_bytes)}
