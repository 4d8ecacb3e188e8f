"""Attention core, softmax(Q K^T / sqrt(D) + bias) V (port of
vlbert_tpu/ops/attention.py, inference path).

Two versions of one function:
  * ``plain_attention``: plain PyTorch, scores and softmax in fp32 (the
    counterpart of the JAX package's ``_xla_attention``). It is the oracle
    for the kernel.
  * kernel K2 (``csrc/attention.cu``), launched by ``fused_attention`` for
    CUDA tensors.

Layout: q, k, v are [B, L, H, D]; the additive key bias is exactly
[B, 1, 1, L] (-10000 on masked keys). Any other bias shape is rejected, as
the JAX kernel rejects it: the kernel broadcasts one key-bias row over
heads and queries.
"""

from __future__ import annotations

import math

import torch


def _check_bias(q, bias):
    B, L = q.shape[0], q.shape[1]
    if tuple(bias.shape) != (B, 1, 1, L):
        raise ValueError(f"fused_attention bias must be [B,1,1,L]="
                         f"[{B},1,1,{L}], got {tuple(bias.shape)}")


def plain_attention(q, k, v, bias):
    """Plain PyTorch attention; q, k, v [B, L, H, D] -> [B, L, H, D] in
    q's dtype, with scores, softmax and P.V in fp32."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(D)
    s = s + bias.to(torch.float32)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return o.to(q.dtype)


def fused_attention(q, k, v, bias):
    """Attention core; launches kernel K2 for CUDA tensors.

    q, k, v: [B, L, H, D] (views with any strides, unit stride on D);
    bias: [B, 1, 1, L] additive fp32. Returns [B, L, H, D] in q's dtype.
    A CPU tensor takes ``plain_attention``; a CUDA tensor launches the
    kernel or raises.
    """
    _check_bias(q, bias)
    if q.device.type == "cpu":
        return plain_attention(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _attention_cuda(q, k, v, bias)


def _attention_cuda(q, k, v, bias):
    from vlbert_tpu_torch.kernels import build

    B, L, H, D = q.shape
    if D != 64:
        raise ValueError(f"fused_attention kernel needs head dim 64, got {D}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, L, H, D):
            raise ValueError(f"fused_attention: {name} shape "
                             f"{tuple(t.shape)} != q shape {(B, L, H, D)}")
        if t.dtype != q.dtype:
            raise TypeError(f"fused_attention: {name} dtype {t.dtype} != "
                            f"q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"fused_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention kernel takes fp32 or bf16, got "
                        f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"fused_attention: {name} needs unit stride on "
                             f"the head dim, got strides {t.stride()}")
    if (bias.dtype != torch.float32 or not bias.is_contiguous()
            or bias.device != q.device):
        raise ValueError("fused_attention kernel needs a contiguous fp32 "
                         "bias on q's device")
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lib = build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), B, L, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(D), stream)
    build.check(err, "attention_fwd")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
