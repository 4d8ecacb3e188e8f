"""Attention core, softmax(Q K^T / sqrt(D) + bias) V, with and without
attention-prob dropout (port of vlbert_tpu/ops/attention.py).

Inference / rate 0:
  * ``plain_attention``: plain PyTorch, scores and softmax in fp32 (the
    counterpart of the JAX package's ``_xla_attention``), the oracle.
  * kernel K2 (``csrc/attention.cu``), launched by ``fused_attention`` for
    CUDA tensors inside a ``torch.autograd.Function`` whose backward is
    ``attention_bwd_plain``, the JAX package's recompute ``_bwd`` in plain
    PyTorch (JAX runs it in XLA, not in Pallas).

Training (prob dropout, 0 < rate <= 1):
  * ``plain_attention_dropout``: the fp32 probs times the keep mask times
    1/(1 - rate) in fp32, then P V; its autograd is the plain backward.
  * kernels K3 (forward) and K4 (recompute backward), launched by
    ``fused_attention_dropout`` for CUDA tensors inside a
    ``torch.autograd.Function`` that saves only (q, k, v, bias, seed or
    bits): on the tensor cores for bf16 (``csrc/attention_dropout_mma.cu``),
    on the CUDA cores for fp32 (``csrc/attention_dropout.cu``).

The mask's bits (``attention_bits``): one Philox4x32-10 evaluation per four
neighbouring keys, counter (key // 4, query, b*H + h, 1) and the call's
64-bit seed, key k taking word k % 4; drop iff bits < min(round(rate *
2^32), 2^32 - 1). Or explicit [B, H, L, L] uint16 bits as an int tensor,
drop iff bits < round(rate * 65536), the JAX package's 'bits16' rule, for
parity tests.

Layout: q, k, v are [B, L, H, D]; the additive key bias is exactly
[B, 1, 1, L] (-10000 on masked keys). Any other bias shape is rejected, as
the JAX kernel rejects it.
"""

from __future__ import annotations

import math

import torch

from vlbert_tpu_torch import ops
from vlbert_tpu_torch.ops.dropout import keep_mask, philox4x32, threshold

# the kernels loop over L without a size limit; the bound is the model's
# position table (max_position_embeddings 512)
MAX_L = 512
# bytes: the bf16 K3/K4 copy rows of q, k, v and g in 16-byte pieces
_ALIGN = 16


def _check_bias(q, bias):
    B, L = q.shape[0], q.shape[1]
    if tuple(bias.shape) != (B, 1, 1, L):
        raise ValueError(f"fused_attention bias must be [B,1,1,L]="
                         f"[{B},1,1,{L}], got {tuple(bias.shape)}")


def _probs(q, k, bias):
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(D)
    return torch.softmax(s + bias.to(torch.float32), dim=-1)


def plain_attention(q, k, v, bias):
    """Plain PyTorch attention; q, k, v [B, L, H, D] -> [B, L, H, D] in
    q's dtype, with scores, softmax and P.V in fp32."""
    p = _probs(q, k, bias)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return o.to(q.dtype)


def attention_bwd_plain(q, k, v, bias, g):
    """Gradients of ``plain_attention`` by recompute, the JAX package's
    ``_bwd``: fp32 probs, dv, ds, dq, dk and dbias (summed over heads and
    queries), each cast to its input's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, bias)
    gf, vf = g.to(torch.float32), v.to(torch.float32)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32)) * scale
    dbias = ds.sum(2, keepdim=True).sum(1, keepdim=True)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dbias.to(bias.dtype))


def attention_bits(B, H, L, seed, device=None):
    """K3/K4's bits for a [B, H, L, L] prob tensor: key k of query q in
    head (b, h) takes word k % 4 of Philox4x32-10 at counter
    (k // 4, q, b*H + h, 1)."""
    i64 = dict(dtype=torch.int64, device=device)
    group = torch.arange((L + 3) // 4, **i64)
    qry = torch.arange(L, **i64)[:, None]
    bh = torch.arange(B * H, **i64)[:, None, None]
    one = torch.ones((), **i64)
    words = torch.stack(philox4x32(group, qry, bh, one, seed), -1)
    return words.reshape(B, H, L, -1)[..., :L]


def plain_attention_dropout(q, k, v, bias, rate, seed=None, bits=None):
    """Plain PyTorch attention with prob dropout. Exactly one of ``seed``
    (Philox mode) and ``bits`` ([B, H, L, L] uint16 values in an int
    tensor)."""
    if (seed is None) == (bits is None):
        raise ValueError("attention dropout takes exactly one of seed and "
                         "bits")
    _check_bias(q, bias)
    B, L, H, _ = q.shape
    if bits is None:
        bits = attention_bits(B, H, L, seed, q.device)
    keep = keep_mask(bits.to(torch.int64), rate, seed is None)
    p = _probs(q, k, bias)
    drop_scale = 1.0 / (1.0 - rate) if rate < 1.0 else 0.0
    pd = torch.where(keep, p * drop_scale, torch.zeros_like(p))
    o = torch.einsum("bhqk,bkhd->bqhd", pd, v.to(torch.float32))
    return o.to(q.dtype)


def fused_attention(q, k, v, bias):
    """Attention core; launches kernel K2 for CUDA tensors.

    q, k, v: [B, L, H, D] (views with any strides, unit stride on D);
    bias: [B, 1, 1, L] additive fp32. Returns [B, L, H, D] in q's dtype.
    A CPU tensor takes ``plain_attention``; a CUDA tensor launches the
    kernel (its gradient is ``attention_bwd_plain``) or raises.
    """
    _check_bias(q, bias)
    kind = ops.device_kind(q)
    if kind == "cpu":
        return plain_attention(q, k, v, bias)
    if kind != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _FusedAttention.apply(q, k, v, bias)


fused_attention.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        out = _attention_launch(q, k, v, bias)
        fused_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return attention_bwd_plain(*ctx.saved_tensors, g)


def fused_attention_dropout(q, k, v, bias, rate, seed=None, bits=None):
    """Attention with prob dropout (training); launches kernel K3 forward
    and K4 backward for CUDA tensors.

    rate in (0, 1]; exactly one of ``seed`` (a 64-bit int, Philox mode) and
    ``bits`` ([B, H, L, L] uint16 values as an int tensor). A CPU tensor
    takes ``plain_attention_dropout``; a CUDA tensor launches the kernels
    or raises.
    """
    if (seed is None) == (bits is None):
        raise ValueError("attention dropout takes exactly one of seed and "
                         "bits")
    if not 0.0 < float(rate) <= 1.0:
        raise ValueError(f"attention dropout needs 0 < rate <= 1, got {rate}")
    _check_bias(q, bias)
    kind = ops.device_kind(q)
    if kind == "cpu":
        return plain_attention_dropout(q, k, v, bias, rate, seed=seed,
                                       bits=bits)
    if kind != "cuda":
        raise ValueError(f"fused_attention_dropout: unsupported device "
                         f"{q.device}")
    return _FusedAttentionDropout.apply(q, k, v, bias, float(rate), seed,
                                        bits)


fused_attention_dropout.launches = 0       # K3 launches
fused_attention_dropout.bwd_launches = 0   # K4 calls (two kernels each)


class _FusedAttentionDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed, bits):
        ctx.rate, ctx.seed = rate, seed
        ctx.save_for_backward(q, k, v, bias, bits)
        out = _attention_dropout_launch(q, k, v, bias, rate, seed, bits)
        fused_attention_dropout.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, bits = ctx.saved_tensors
        grads = _attention_dropout_bwd_launch(q, k, v, bias, g, ctx.rate,
                                              ctx.seed, bits)
        fused_attention_dropout.bwd_launches += 1
        return (*grads, None, None, None)


def _check_cuda_args(q, k, v, bias, name):
    B, L, H, D = q.shape
    if D != 64:
        raise ValueError(f"{name} kernel needs head dim 64, got {D}")
    if L > MAX_L:
        raise ValueError(f"{name} kernel supports L <= {MAX_L}, got {L}")
    for n, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, L, H, D):
            raise ValueError(f"{name}: {n} shape {tuple(t.shape)} != q "
                             f"shape {(B, L, H, D)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {n} dtype {t.dtype} != q dtype "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {n} on {t.device}, q on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes fp32 or bf16, got {q.dtype}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {n} needs unit stride on the head "
                             f"dim, got strides {t.stride()}")
    if (bias.dtype != torch.float32 or not bias.is_contiguous()
            or bias.device != q.device):
        raise ValueError(f"{name} kernel needs a contiguous fp32 bias on "
                         f"q's device")


def _check_dropout_args(q, k, v, bias, **more):
    """K3/K4's checks: those of every attention kernel, and for bf16, whose
    kernels copy each row of q, k, v (and g) in 16-byte pieces, each view's
    start and (b, l, h) strides on 16-byte boundaries."""
    name = "fused_attention_dropout"
    _check_cuda_args(q, k, v, bias, name)
    if q.dtype != torch.bfloat16:
        return
    for n, t in dict(q=q, k=k, v=v, **more).items():
        step = _ALIGN // t.element_size()
        if t.data_ptr() % _ALIGN or any(s % step for s in t.stride()[:3]):
            raise ValueError(f"{name}: the bf16 kernel needs {n} rows on "
                             f"{_ALIGN}-byte boundaries, got data_ptr % "
                             f"{_ALIGN} = {t.data_ptr() % _ALIGN}, strides "
                             f"{t.stride()}")


def _strides(q, k, v):
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def _drop_args(q, rate, seed, bits):
    """(bits pointer or None, keep-alive bits, threshold, fp32 scale,
    seed) for the dropout kernels."""
    ptr = None
    if bits is not None:
        B, L, H, _ = q.shape
        if tuple(bits.shape) != (B, H, L, L) or bits.device != q.device:
            raise ValueError(f"attention dropout bits must be "
                             f"{(B, H, L, L)} on {q.device}, got "
                             f"{tuple(bits.shape)} on {bits.device}")
        bits = bits.to(torch.int32).contiguous()
        ptr = bits.data_ptr()
    drop_scale = 1.0 / (1.0 - rate) if rate < 1.0 else 0.0
    return (ptr, bits, threshold(rate, bits is not None), drop_scale,
            0 if seed is None else int(seed))


def _attention_launch(q, k, v, bias):
    from vlbert_tpu_torch.kernels import build

    _check_cuda_args(q, k, v, bias, "fused_attention")
    B, L, H, D = q.shape
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lib = build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), B, L, H, D,
        *_strides(q, k, v), 1.0 / math.sqrt(D), stream)
    build.check(err, "attention_fwd")
    return out


def _dropout_kernels(lib, q):
    """K3 and K4's entry points for q's dtype: the tensor-core kernels for
    bf16, the CUDA-core kernels for fp32."""
    if q.dtype == torch.bfloat16:
        return lib.attention_dropout_fwd_bf16, lib.attention_dropout_bwd_bf16
    return lib.attention_dropout_fwd_f32, lib.attention_dropout_bwd_f32


def _attention_dropout_launch(q, k, v, bias, rate, seed, bits):
    from vlbert_tpu_torch.kernels import build

    _check_dropout_args(q, k, v, bias)
    B, L, H, D = q.shape
    ptr, _bits, thresh, drop_scale, seed = _drop_args(q, rate, seed, bits)
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    fwd, _ = _dropout_kernels(build.load(), q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
              out.data_ptr(), B, L, H, D, *_strides(q, k, v),
              1.0 / math.sqrt(D), ptr, thresh, drop_scale, seed, stream)
    build.check(err, fwd.__name__)
    return out


def _attention_dropout_bwd_launch(q, k, v, bias, g, rate, seed, bits):
    from vlbert_tpu_torch.kernels import build

    g = g.to(q.dtype).contiguous()
    _check_dropout_args(q, k, v, bias, g=g)
    B, L, H, D = q.shape
    ptr, _bits, thresh, drop_scale, seed = _drop_args(q, rate, seed, bits)
    kw = dict(dtype=q.dtype, device=q.device)
    dq, dk, dv = (torch.empty((B, L, H, D), **kw) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    dbias_h = torch.empty((B, H, L), **f32)
    stats = torch.empty((B * H * L * 3,), **f32)
    _, bwd = _dropout_kernels(build.load(), q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
              g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              dbias_h.data_ptr(), stats.data_ptr(), B, L, H, D,
              *_strides(q, k, v), 1.0 / math.sqrt(D), ptr, thresh,
              drop_scale, seed, stream)
    build.check(err, bwd.__name__)
    dbias = dbias_h.sum(1)[:, None, None, :].to(bias.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype), dbias
