"""Dropout with integer-threshold masks (port of vlbert_tpu/ops/dropout.py).

torch-dropout semantics: keep probability ``1 - rate``, kept values scaled
by ``1 / (1 - rate)`` rounded to the input's dtype (1/(1-0.1) is 1.109375
in bf16, 1.111328125 in fp16), dropped values 0. The mask compares raw
random bits with an integer threshold:

  * Philox mode (the training path): 32-bit words of Philox4x32-10 keyed by
    a 64-bit seed, one evaluation per four consecutive elements: flat index
    i takes word i % 4 of the evaluation at counter (g & 0xffffffff,
    g >> 32, 0, 0), g = i // 4 (``philox_bits``); drop iff word <
    min(round(rate * 2^32), 2^32 - 1).
  * explicit-bits mode (parity with the JAX package): uint16 bits given as
    int32, drop iff bits < round(rate * 65536), the JAX 'bits16' rule.

Two versions of one function:
  * ``plain_dropout``: plain PyTorch, with ``philox_bits`` as the plain
    generator (integer ops on int64 tensors). It is the oracle for the
    kernel and yields the kernel's bits exactly.
  * kernel K5 (``csrc/dropout.cu``), launched by ``hw_dropout`` for CUDA
    tensors inside a ``torch.autograd.Function`` whose backward replays the
    mask from the saved seed (nothing else is saved).

Seeds: a training step opens ``dropout_seeds(step_seed)``; every dropout
site draws ``next_site_seed()`` in forward order, so each site gets its own
seed from the step's seed and its fixed position on the path. No dropout
uses torch's global RNG; a module in training mode outside that context
raises. An activation-checkpointed layer (TPU.REMAT) takes ``site_state()``
before its forward and recomputes under ``replay_sites``, so the recompute
draws the forward's seeds again: the kernels rebuild the same masks.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from vlbert_tpu_torch import ops

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
# bytes: K5 moves x, out and the explicit bits in 16-byte pieces
_ALIGN = 16
# Philox4x32 multipliers and Weyl key increments (Salmon et al., SC 2011)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a, m):
    """(hi, lo) 32-bit halves of a * m for uint32 values held in int64
    tensors, without overflowing int64: a is split into 16-bit halves."""
    t1 = (a & 0xFFFF) * m
    t2 = (a >> 16) * m
    hi = (t2 + (t1 >> 16)) >> 16
    lo = (((t2 & 0xFFFF) << 16) + t1) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, seed):
    """Philox4x32-10 on int64 tensors of uint32 counters (broadcast
    together); ``seed`` is the 64-bit key as a Python int. Returns the four
    output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(g, seed):
    """K5's bits of flat elements 4g .. 4g + 3 for each group index in the
    int64 tensor ``g``: the four words of Philox4x32-10 at counter
    (g & 0xffffffff, g >> 32, 0, 0), as a [..., 4] tensor."""
    zero = torch.zeros((), dtype=torch.int64, device=g.device)
    return torch.stack(philox4x32(g & _MASK32, g >> 32, zero, zero, seed), -1)


def flat_index_bits(shape, seed, device=None):
    """K5's bits for a tensor of ``shape``: flat element i takes word i % 4
    of group i // 4 (``philox_bits``)."""
    n = 1
    for s in shape:
        n *= int(s)
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    return philox_bits(g, seed).reshape(-1)[:n].reshape(shape)


def threshold(rate, explicit_bits):
    """Integer drop threshold: drop iff bits < threshold."""
    if explicit_bits:
        return int(round(float(rate) * 65536.0))
    return min(int(round(float(rate) * 4294967296.0)), _MASK32)


def keep_mask(bits, rate, explicit_bits):
    return bits >= threshold(rate, explicit_bits)


def fold_in(seed, data):
    """A new 64-bit seed from ``seed`` and an integer (splitmix64 of their
    sum), for per-site and per-microbatch seeds."""
    z = (int(seed) + 0x9E3779B97F4A7C15 * (int(data) + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class _SeedState:
    seed = None
    site = 0


_STATE = _SeedState()


@contextlib.contextmanager
def dropout_seeds(seed):
    """Within this block, dropout site i (in forward order) uses
    ``fold_in(seed, i)``."""
    saved = _STATE.seed, _STATE.site
    _STATE.seed, _STATE.site = int(seed) & _MASK64, 0
    try:
        yield
    finally:
        _STATE.seed, _STATE.site = saved


def site_state():
    """The step's seed and the index of the next dropout site: what
    ``replay_sites`` needs to draw again the seeds the forward draws from
    this point on (an activation-checkpointed layer's recompute)."""
    return _STATE.seed, _STATE.site


class replay_sites:
    """Within this block, dropout sites draw their seeds from ``state`` (a
    ``site_state()``) on, as the forward did from where it was taken; on
    exit the seed and counter found on entry come back. Inside or outside
    a ``dropout_seeds`` block alike: a recompute during ``backward()``
    runs after the step's block has exited. Re-enterable: a backward that
    keeps its graph recomputes a checkpointed layer each time it runs."""

    def __init__(self, state):
        self.state = state
        self.saved = []

    def __enter__(self):
        self.saved.append((_STATE.seed, _STATE.site))
        _STATE.seed, _STATE.site = self.state

    def __exit__(self, *exc):
        _STATE.seed, _STATE.site = self.saved.pop()


def next_site_seed():
    if _STATE.seed is None:
        raise RuntimeError(
            "dropout in training mode needs a seed: run the forward inside "
            "vlbert_tpu_torch.ops.dropout.dropout_seeds(seed)")
    site = _STATE.site
    _STATE.site += 1
    return fold_in(_STATE.seed, site)


def _scale(rate, dtype):
    """1 / (1 - rate) rounded to ``dtype``, as the JAX package does."""
    return float(torch.tensor(1.0 / (1.0 - float(rate)), dtype=dtype))


def plain_dropout(x, rate, seed=None, bits=None):
    """Plain PyTorch dropout. Exactly one of ``seed`` (Philox mode) and
    ``bits`` (explicit uint16 bits as an int tensor of x's shape)."""
    if (seed is None) == (bits is None):
        raise ValueError("plain_dropout takes exactly one of seed and bits")
    if bits is None:
        bits = flat_index_bits(x.shape, seed, x.device)
    keep = keep_mask(bits.to(torch.int64), rate, seed is None)
    scaled = x * torch.tensor(_scale(rate, x.dtype), dtype=x.dtype,
                              device=x.device)
    return torch.where(keep, scaled, torch.zeros_like(x))


def hw_dropout(x, rate, seed=None, bits=None):
    """Dropout at 0 < rate < 1; launches kernel K5 for CUDA tensors.

    The backward applies the same mask and scale to the cotangent (K5
    again); only the seed (or the explicit bits) is kept for it. A CPU
    tensor takes ``plain_dropout``; a CUDA tensor launches the kernel or
    raises.
    """
    if (seed is None) == (bits is None):
        raise ValueError("hw_dropout takes exactly one of seed and bits")
    kind = ops.device_kind(x)
    if kind == "cpu":
        return plain_dropout(x, rate, seed=seed, bits=bits)
    if kind != "cuda":
        raise ValueError(f"hw_dropout: unsupported device {x.device}")
    return _HwDropout.apply(x, float(rate), seed, bits)


hw_dropout.launches = 0          # K5 forward launches
hw_dropout.bwd_launches = 0      # K5 backward launches


class _HwDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed, bits):
        ctx.rate, ctx.seed = rate, seed
        ctx.save_for_backward(bits)
        out = _dropout_launch(x, rate, seed, bits)
        hw_dropout.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        (bits,) = ctx.saved_tensors
        dx = _dropout_launch(g, ctx.rate, ctx.seed, bits)
        hw_dropout.bwd_launches += 1
        return dx, None, None, None


def _aligned_like(x, dtype):
    """An empty tensor of x's shape and ``dtype`` whose element h starts on
    a 16-byte boundary, h being the first element of the contiguous ``x``
    that does: K5 reads x and the bits and writes out 16 bytes at a time
    from the same flat index, whatever x's storage offset."""
    n = x.numel()
    head = (-x.data_ptr() % _ALIGN) // x.element_size()
    out = torch.empty(n, dtype=dtype, device=x.device)
    es = out.element_size()
    if (out.data_ptr() + head * es) % _ALIGN:
        buf = torch.empty(n + _ALIGN // es, dtype=dtype, device=x.device)
        skip = (-(buf.data_ptr() + head * es) % _ALIGN) // es
        out = buf[skip:skip + n]
    return out.view(x.shape)


def _dropout_launch(x, rate, seed, bits):
    from vlbert_tpu_torch.kernels import build

    if x.dtype not in ops.DTYPE_CODES:
        raise TypeError(f"dropout kernel takes fp32, bf16 or fp16, got "
                        f"{x.dtype}")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout kernel needs 0 < rate < 1, got {rate}")
    x = x.contiguous()
    bits_ptr = None
    if bits is not None:
        if tuple(bits.shape) != tuple(x.shape) or bits.device != x.device:
            raise ValueError(f"dropout bits must be {tuple(x.shape)} on "
                             f"{x.device}, got {tuple(bits.shape)} on "
                             f"{bits.device}")
        bits = _aligned_like(x, torch.int32).copy_(bits)
        bits_ptr = bits.data_ptr()
    out = _aligned_like(x, x.dtype)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dropout_fwd(x.data_ptr(), out.data_ptr(), x.numel(),
                          ops.DTYPE_CODES[x.dtype], bits_ptr,
                          threshold(rate, bits is not None),
                          _scale(rate, x.dtype),
                          0 if seed is None else int(seed), stream)
    build.check(err, "dropout_fwd")
    return out


def dropout_apply(x, rate, seed=None, bits=None):
    """Pure-function dropout: identity at rate 0, zeros at rate 1, else
    ``hw_dropout``."""
    rate = float(rate)
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    return hw_dropout(x, rate, seed=seed, bits=bits)


class Dropout(nn.Module):
    """Dropout whose mask comes from the step's seed (``dropout_seeds``),
    active in training mode only."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return dropout_apply(x, self.rate, seed=next_site_seed())

    def extra_repr(self):
        return f"rate={self.rate}"
