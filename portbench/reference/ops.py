"""Plain PyTorch operations of the reference training step.

A frozen copy of the semantics the program states, written here so that
no later change to the program can change the yardstick: Philox4x32-10
dropout masks drawn from the step's seed (the hidden dropout's flat-index
rule and the attention dropout's (key // 4, query, head, 1) counter),
ROIAlign as two separable einsums, the sin/cos box embedding, the uint8
image normalisation and the losses. Everything runs in float32. The
matrix products go through ``matmul_operand``, which leaves an operand
as it is in the reference and rounds it to float8 (e4m3, one scale a
tensor) in the lower-precision control (``lower_precision``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (Salmon et al., SC 2011)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

# ------------------------------------------------------------- precision

_FP8 = {"on": False}
_FP8_MAX = 448.0          # the largest finite float8_e4m3fn


@contextlib.contextmanager
def lower_precision():
    """Within this block every product operand is rounded to float8 e4m3
    with one scale a tensor (its largest magnitude mapped to 448): the
    control, the nearest precision below the configuration's bfloat16."""
    saved = _FP8["on"]
    _FP8["on"] = True
    try:
        yield
    finally:
        _FP8["on"] = saved


def matmul_operand(x):
    if not _FP8["on"]:
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    # the rounding passes the gradient straight through
    return x + (q - x).detach()


def linear(x, w, b=None):
    return F.linear(matmul_operand(x), matmul_operand(w), b)


def conv2d(x, w, stride=1, padding=0, dilation=1):
    return F.conv2d(matmul_operand(x), matmul_operand(w), None, stride,
                    padding, dilation)


def einsum(eq, a, b):
    return torch.einsum(eq, matmul_operand(a), matmul_operand(b))


# ---------------------------------------------------------------- Philox

def _mulhilo(a, m):
    t1 = (a & 0xFFFF) * m
    t2 = (a >> 16) * m
    hi = (t2 + (t1 >> 16)) >> 16
    lo = (((t2 & 0xFFFF) << 16) + t1) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, seed):
    """Philox4x32-10 on int64 tensors holding uint32 counters; ``seed`` is
    the 64-bit key. Returns the four output words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def fold_in(seed, data):
    """splitmix64 of seed + golden-ratio step x (data + 1): the seed of
    dropout site ``data`` within a step."""
    z = (int(seed) + 0x9E3779B97F4A7C15 * (int(data) + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def drop_threshold(rate):
    return min(int(round(float(rate) * 4294967296.0)), _MASK32)


class Sites:
    """The step's dropout sites in forward order: site i draws
    ``fold_in(step seed, i)``."""

    def __init__(self, seed):
        self.seed = int(seed) & _MASK64
        self.next = 0

    def draw(self):
        s = fold_in(self.seed, self.next)
        self.next += 1
        return s


def hidden_dropout(x, rate, sites):
    """Dropout of a hidden tensor: flat element i keeps iff word i % 4 of
    Philox at counter (i // 4 low, i // 4 high, 0, 0) is at least the
    threshold; kept values times 1 / (1 - rate). Rate 0 draws no site."""
    if rate == 0.0:
        return x
    seed = sites.draw()
    n = x.numel()
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=x.device)
    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    bits = torch.stack(philox4x32(g & _MASK32, g >> 32, zero, zero, seed),
                       -1).reshape(-1)[:n].reshape(x.shape)
    keep = bits >= drop_threshold(rate)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


def attention_keep(B, H, L, seed, device):
    """[B, H, L, L] keep mask of attention-prob dropout: key k of query q
    in head (b, h) takes word k % 4 of Philox at counter (k // 4, q,
    b * H + h, 1)."""
    i64 = dict(dtype=torch.int64, device=device)
    group = torch.arange((L + 3) // 4, **i64)
    qry = torch.arange(L, **i64)[:, None]
    bh = (torch.arange(B, **i64)[:, None] * H
          + torch.arange(H, **i64)).reshape(-1, 1, 1)
    one = torch.ones((), **i64)
    words = torch.stack(philox4x32(group, qry, bh, one, seed), -1)
    return words.reshape(B, H, L, -1)[..., :L]


def attention(q, k, v, bias, rate, sites):
    """softmax(q k^T / sqrt(D) + bias) with prob dropout, then P v. q, k,
    v: [B, L, H, D]; bias [B, 1, 1, L]."""
    B, L, H, D = q.shape
    s = einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    p = torch.softmax(s + bias, dim=-1)
    if rate > 0.0:
        bits = attention_keep(B, H, L, sites.draw(), q.device)
        p = torch.where(bits >= drop_threshold(rate), p * (1.0 / (1.0 - rate)),
                        torch.zeros_like(p))
    return einsum("bhqk,bkhd->bqhd", p, v)


# -------------------------------------------------------------- ROIAlign

MAX_GRID = 8


def _interp_weights(start, roi_size, grid_n, pooled, fm_size):
    """[n, P, fm_size] weights whose product with a feature row averages
    the grid_n bilinear samples of each bin (the original ROIAlign's
    sampling: samples outside [-1, size] give 0, y clamped at 0 from
    below, both taps at size - 1 on the far edge)."""
    dev = start.device
    bin_size = roi_size / pooled
    p = torch.arange(pooled, dtype=torch.float32, device=dev)
    g = torch.arange(MAX_GRID, dtype=torch.float32, device=dev)
    grid_f = grid_n.to(torch.float32)
    y = (start[:, None, None] + p[:, None] * bin_size[:, None, None]
         + (g[None, :] + 0.5) * bin_size[:, None, None]
         / grid_f[:, None, None])
    valid = g[None, :] < grid_f[:, None, None]
    in_range = (y >= -1.0) & (y <= fm_size)
    yc = torch.clamp(y, min=0.0)
    y_low = torch.floor(yc)
    top = y_low >= fm_size - 1
    y_low = torch.where(top, torch.full_like(y_low, fm_size - 1.0), y_low)
    y_high = torch.where(top, y_low, y_low + 1.0)
    ly = torch.where(top, torch.zeros_like(yc), yc - y_low)
    contrib = torch.where(valid & in_range, 1.0 / grid_f[:, None, None],
                          torch.zeros_like(y))
    hh = torch.arange(fm_size, dtype=torch.int64, device=dev)
    w = (contrib * (1.0 - ly))[..., None] * (y_low.long()[..., None] == hh) \
        + (contrib * ly)[..., None] * (y_high.long()[..., None] == hh)
    return w.sum(dim=-2)


def roi_align(fmap, boxes, pooled=14, spatial_scale=1.0 / 16,
              sampling_ratio=1):
    """fmap [H, W, C] of one image, boxes [n, 4] -> [n, P, P, C]."""
    H, W, _ = fmap.shape
    b = boxes.to(torch.float32) * spatial_scale
    roi_w = torch.clamp(b[:, 2] - b[:, 0], min=1.0)
    roi_h = torch.clamp(b[:, 3] - b[:, 1], min=1.0)
    if sampling_ratio > 0:
        gh = gw = torch.full(roi_h.shape, sampling_ratio, dtype=torch.int32,
                             device=boxes.device)
    else:
        gh = torch.clamp(torch.ceil(roi_h / pooled), max=MAX_GRID).int()
        gw = torch.clamp(torch.ceil(roi_w / pooled), max=MAX_GRID).int()
    ry = _interp_weights(b[:, 1], roi_h, gh, pooled, H)
    cx = _interp_weights(b[:, 0], roi_w, gw, pooled, W)
    rows = torch.einsum("oph,hwc->opwc", ry, fmap)
    return torch.einsum("oqw,opwc->opqc", cx, rows)


# ------------------------------------------------------------ embeddings

def normalize_image(images, im_info, means):
    """uint8 RGB [B, H, W, 3] -> BGR, minus the caffe means, zero outside
    each image's (w, h) of ``im_info``; float32."""
    B, H, W, _ = images.shape
    dev = images.device
    x = images.flip(-1).to(torch.float32) - torch.tensor(
        means, dtype=torch.float32, device=dev)
    xs = torch.arange(W, device=dev).view(1, 1, W, 1)
    ys = torch.arange(H, device=dev).view(1, H, 1, 1)
    w = im_info[:, 0].view(B, 1, 1, 1)
    h = im_info[:, 1].view(B, 1, 1, 1)
    return torch.where((xs < w) & (ys < h), x, torch.zeros((), device=dev))


def box_embedding(boxes, im_info, dim=256):
    """(centre, size) of each box in percent of its image, as sin / cos
    of frequency base 1000: [B, O, 4] -> [B, O, 4 * 2 * dim]."""
    B, O, _ = boxes.shape
    w = im_info[:, None, 0].expand(B, O)
    h = im_info[:, None, 1].expand(B, O)
    x1, y1, x2, y2 = boxes.unbind(-1)
    pos = torch.stack([(x1 + x2) / 2 / w * 100, (y1 + y2) / 2 / h * 100,
                       (x2 - x1) / w * 100, (y2 - y1) / h * 100], -1)
    freq = 1000.0 ** (torch.arange(dim, dtype=torch.float32,
                                   device=boxes.device) / dim)
    arg = pos[..., None] / freq
    return torch.cat([torch.sin(arg), torch.cos(arg)], -1).reshape(B, O, -1)


def layer_norm(x, w, b, eps=1e-12):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


# ---------------------------------------------------------------- losses

def masked_cross_entropy(logits, labels, mask):
    nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                        labels.long()[..., None])[..., 0]
    m = mask.to(torch.float32)
    return (nll * m).sum() / m.sum().clamp(min=1)


def bce_with_logits(logits, targets, weight=None):
    return F.binary_cross_entropy_with_logits(logits, targets, weight=weight)
