"""K1 (ROIAlign forward) of the port: the plain version with ``out_dtype``
against the JAX package on the CPU, and the rules of the CUDA route,
reached by monkeypatching the device kind (the kernel itself runs only on
the card: chip_smoke.py phase 3 holds it against the plain version).

bf16 outputs are held within one bf16 step of the JAX package's fp32
result rounded to bf16 (|a - b| <= 2**-7 |b| + 1e-4, chip_smoke's K1
tolerance): the fp32 sums are taken in another order, so where they
straddle a rounding boundary the two round to neighbouring bf16 values.
fp16 outputs likewise within one fp16 step (2**-10 |b| + 1e-4).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chip_smoke import (K1_ATOL, K1_BF16_RTOL, K1_FP16_RTOL, K1_SERVE_BOXES,
                        K1_SERVE_LIVE)
from vlbert_tpu.ops.roi_align import roi_align as j_roi_align
from vlbert_tpu_torch import ops
from vlbert_tpu_torch.kernels import build
from vlbert_tpu_torch.models import fast_rcnn
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.ops import roi_align as troi

T = torch.from_numpy
BF16 = torch.bfloat16
F16 = torch.float16
# one step of a 16-bit type, relative
STEP = {"bfloat16": K1_BF16_RTOL, "float16": K1_FP16_RTOL}


def _edge_case(rng, C=16):
    """A map [2,38,63,C] (a 1000x600 canvas at stride 16). Image 0 takes
    the edge boxes of chip_smoke's K1 parity (whole canvas, crossing edges,
    entirely outside, sub-pixel, the far corner, exceeding every side, a
    box starting at the far edge) with its 2 padded slots; image 1 the same
    boxes in reverse order, its first two (0, 0, 0, 0) live and slots 3 and
    9 padded."""
    feat = rng.normal(size=(2, 38, 63, C)).astype(np.float32)
    b0 = np.asarray(K1_SERVE_BOXES, np.float32)
    boxes = np.stack([b0, b0[::-1]])
    mask = np.zeros((2, len(b0)), bool)
    mask[0, :K1_SERVE_LIVE] = True
    mask[1] = True
    mask[1, [3, 9]] = False
    return feat, boxes, mask


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("sampling_ratio", [0, 1, 2])
def test_plain_bf16_out_matches_jax_cast(rng, impl, feat_dtype,
                                         sampling_ratio):
    """roi_align_plain(..., out_dtype=bf16) against the JAX package's
    roi_align(...).astype(bfloat16), as its FastRCNN computes it; the
    Pallas kernel runs in interpret mode."""
    feat, boxes, mask = _edge_case(rng)
    want = j_roi_align(jnp.asarray(feat).astype(feat_dtype),
                       jnp.asarray(boxes), jnp.asarray(mask), impl=impl,
                       sampling_ratio=sampling_ratio).astype(jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    got = troi.roi_align_plain(T(feat).to(getattr(torch, feat_dtype)),
                               T(boxes), T(mask),
                               sampling_ratio=sampling_ratio, out_dtype=BF16)
    assert got.dtype == BF16 and got.shape == (2, 16, 14, 14, 16)
    got = got.float().numpy()
    excess = np.abs(got - want) - (K1_BF16_RTOL * np.abs(want) + K1_ATOL)
    assert excess.max() <= 0, excess.max()
    assert np.all(got[~mask] == 0)
    assert np.abs(want).max() > 1.0     # the boxes do read the map


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("feat_dtype", ["float32", "float16"])
def test_plain_fp16_out_matches_jax_cast(rng, impl, feat_dtype):
    """roi_align_plain(..., out_dtype=fp16) against the JAX package's
    roi_align(...).astype(float16), as its FastRCNN computes it under
    float16 compute: within one fp16 step."""
    feat, boxes, mask = _edge_case(rng)
    want = j_roi_align(jnp.asarray(feat).astype(feat_dtype),
                       jnp.asarray(boxes), jnp.asarray(mask), impl=impl,
                       sampling_ratio=0).astype(jnp.float16)
    want = np.asarray(want.astype(jnp.float32))
    got = troi.roi_align_plain(T(feat).to(getattr(torch, feat_dtype)),
                               T(boxes), T(mask), sampling_ratio=0,
                               out_dtype=F16)
    assert got.dtype == F16 and got.shape == (2, 16, 14, 14, 16)
    got = got.float().numpy()
    excess = np.abs(got - want) - (K1_FP16_RTOL * np.abs(want) + K1_ATOL)
    assert excess.max() <= 0, excess.max()
    assert np.all(got[~mask] == 0)


@pytest.mark.parametrize("sampling_ratio", [0, 1, 2])
def test_cpu_out_dtype_is_the_old_cast_bit_for_bit(rng, sampling_ratio):
    """On the CPU, out_dtype=bf16 gives exactly what the serve path took
    before, roi_align(...).to(bf16); the default stays fp32."""
    feat, boxes, mask = _edge_case(rng)
    for dtype in (torch.float32, BF16):
        args = (T(feat).to(dtype), T(boxes), T(mask))
        old = troi.roi_align(*args, sampling_ratio=sampling_ratio)
        assert old.dtype == torch.float32
        new = troi.roi_align(*args, sampling_ratio=sampling_ratio,
                             out_dtype=BF16)
        assert new.dtype == BF16 and torch.equal(new, old.to(BF16))
        assert torch.equal(troi.roi_align(*args,
                                          sampling_ratio=sampling_ratio,
                                          out_dtype=torch.float32), old)


class _FakeLib:
    """Stands in for the kernel library: records each call, launches
    nothing, reports success."""

    def __init__(self):
        self.calls = []

    def roi_align_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def cuda_route(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(troi.roi_align, "launches", 0)
    return lib


def _shifted(shape, dtype, elements):
    """A contiguous tensor of ``shape`` that starts ``elements`` past the
    start of its (64-byte aligned) storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + elements, dtype=dtype)[elements:].view(shape)


@pytest.mark.parametrize("case,exc,match", [
    ("bf16 C=12", ValueError, "not a multiple of 8"),
    ("fp32 C=6", ValueError, "not a multiple of 4"),
    ("bf16 map 2 bytes in", ValueError, "16-byte boundary"),
    ("fp32 map 4 bytes in", ValueError, "16-byte boundary"),
    ("out fp64", TypeError, "out_dtype"),
    ("bf16 map fp16 out", TypeError, "not mixed"),
])
def test_cuda_route_refuses_what_the_kernel_cannot_take(cuda_route, case,
                                                        exc, match):
    """The kernel moves 16 bytes of channels a thread and stores fp32,
    bf16 or fp16 (not one 16-bit type from the other): C off the vector
    width, a map off a 16-byte boundary or another output type is refused
    before any launch, never handed to the plain version."""
    kw = {}
    feat = {"bf16 C=12": lambda: torch.zeros(1, 6, 7, 12, dtype=BF16),
            "fp32 C=6": lambda: torch.zeros(1, 6, 7, 6),
            "bf16 map 2 bytes in": lambda: _shifted((1, 6, 7, 8), BF16, 1),
            "fp32 map 4 bytes in": lambda: _shifted((1, 6, 7, 8),
                                                    torch.float32, 1),
            "out fp64": lambda: torch.zeros(1, 6, 7, 8, dtype=BF16),
            "bf16 map fp16 out": lambda: torch.zeros(1, 6, 7, 8,
                                                     dtype=BF16)}[case]()
    kw["out_dtype"] = {"out fp64": torch.float64,
                       "bf16 map fp16 out": F16}.get(case, torch.float32)
    assert feat.is_contiguous()
    with pytest.raises(exc, match=match):
        troi.roi_align(feat, torch.zeros(1, 2, 4),
                       torch.ones(1, 2, dtype=torch.bool), **kw)
    assert cuda_route.calls == [] and troi.roi_align.launches == 0


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("out_dtype", [torch.float32, BF16])
def test_cuda_route_reads_a_bool_mask_in_place(cuda_route, out_dtype):
    """With fp32 boxes and a bool mask the call runs no conversion: the
    kernel gets the mask's and the boxes' own storage, and the only tensor
    op is the output's allocation (and the mask's dtype view). One launch,
    of the output type asked for."""
    feat = torch.zeros(1, 6, 7, 16, dtype=BF16)
    boxes = torch.zeros(1, 3, 4)
    mask = torch.tensor([[True, False, True]])
    with _OpLog() as log:
        out = troi.roi_align(feat, boxes, mask, out_dtype=out_dtype)
    assert not [op for op in log.ops if "copy" in op or op == "to"], log.ops
    (args,) = cuda_route.calls
    assert args[2] == boxes.data_ptr() and args[3] == mask.data_ptr()
    assert args[4] == out.data_ptr()
    assert (args[1], args[5]) == (1, ops.DTYPE_CODES[out_dtype])
    assert out.dtype == out_dtype and out.shape == (1, 3, 14, 14, 16)
    assert troi.roi_align.launches == 1
    # a mask of another dtype is converted to bytes first
    troi.roi_align(feat, boxes, mask.float(), out_dtype=out_dtype)
    assert cuda_route.calls[1][3] != mask.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, BF16, F16])
def test_fast_rcnn_asks_roi_align_for_its_compute_dtype(rng, monkeypatch,
                                                        dtype):
    """The end-to-end FastRCNN takes ROIAlign's output in its compute dtype
    from the call itself (the kernel's store), with no cast after it."""
    seen = []
    real = fast_rcnn.roi_align

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((kw.get("out_dtype"), out.dtype))
        return out

    monkeypatch.setattr(fast_rcnn, "roi_align", spy)
    m = fast_rcnn.FastRCNN(num_layers=50, stride_in_1x1=True,
                           c5_dilated=True, final_dim=32, dtype=dtype)
    init_weights(m, torch.Generator().manual_seed(0))
    images = T(rng.integers(0, 256, (1, 64, 96, 3)).astype(np.uint8))
    boxes = torch.tensor([[[0.0, 0.0, 89.0, 59.0], [5.0, 10.0, 40.0, 50.0]]])
    with torch.no_grad():
        out = m.eval()(images, boxes, torch.ones(1, 2, dtype=torch.bool),
                       torch.tensor([[90.0, 60.0, 1.0, 1.0]]))
    assert seen == [(dtype, dtype)]
    assert out["obj_reps"].shape == (1, 2, 32)


# ------------------------------------------------- K1b (the dF backward)

@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("sampling_ratio", [0, 1, 2])
def test_bwd_plain_matches_jax_vjp(rng, impl, feat_dtype, sampling_ratio):
    """roi_align_bwd_plain against jax.vjp of the JAX package's roi_align
    with respect to the map: through _sep_bwd's custom_vjp (impl="pallas",
    the kernel in interpret mode) and through autodiff of the einsums
    (impl="xla"), on the K1 edge boxes (off the map, the edges, sub-pixel
    boxes, padded slots). fp32: rtol 1e-3 / atol 1e-4 (sums in another
    order); a bf16 (fp16) map gets its gradient in bf16 (fp16), held
    within one step of that type of JAX's, as K1's 16-bit output is."""
    import jax

    feat, boxes, mask = _edge_case(rng)
    g = rng.normal(size=(2, 16, 14, 14, 16)).astype(np.float32)
    f = jnp.asarray(feat).astype(feat_dtype)
    _, vjp = jax.vjp(lambda x: j_roi_align(
        x, jnp.asarray(boxes), jnp.asarray(mask), impl=impl,
        sampling_ratio=sampling_ratio), f)
    (want,) = vjp(jnp.asarray(g))
    assert want.dtype == f.dtype
    want = np.asarray(want.astype(jnp.float32))
    got = troi.roi_align_bwd_plain(
        T(feat).to(getattr(torch, feat_dtype)), T(boxes), T(mask), T(g),
        sampling_ratio=sampling_ratio)
    assert got.dtype == getattr(torch, feat_dtype) and got.shape == feat.shape
    got = got.float().numpy()
    if feat_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    else:
        excess = np.abs(got - want) - (STEP[feat_dtype] * np.abs(want)
                                       + K1_ATOL)
        assert excess.max() <= 0, excess.max()
    assert np.abs(want).max() > 1.0     # the boxes do cover the map


def test_bwd_plain_is_the_gradient_of_the_plain_forward(rng):
    """The plain dF is autograd's gradient of roi_align_plain with respect
    to the map, padded slots contributing nothing (their g is ignored)."""
    feat, boxes, mask = _edge_case(rng)
    g = T(rng.normal(size=(2, 16, 14, 14, 16)).astype(np.float32))
    f = T(feat).requires_grad_()
    out = troi.roi_align_plain(f, T(boxes), T(mask), sampling_ratio=0)
    (want,) = torch.autograd.grad(out, f, g)
    got = troi.roi_align_bwd_plain(T(feat), T(boxes), T(mask), g,
                                   sampling_ratio=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g[~T(mask)] = 1e6
    torch.testing.assert_close(
        troi.roi_align_bwd_plain(T(feat), T(boxes), T(mask), g,
                                 sampling_ratio=0), got, rtol=0, atol=0)


def _fake_kernels(monkeypatch):
    """K1 and K1b on a faked CUDA route: each records its call and computes
    its plain version. Returns the call log."""
    calls = []

    def fwd(features, boxes, box_mask, ph, pw, scale, sr, out_dtype):
        calls.append("K1")
        troi.roi_align.launches += 1
        return troi.roi_align_plain(features, boxes, box_mask, pooled_h=ph,
                                    pooled_w=pw, spatial_scale=scale,
                                    sampling_ratio=sr, out_dtype=out_dtype)

    def bwd(g, boxes, box_mask, shape, dtype, ph, pw, scale, sr):
        calls.append(("K1b", tuple(shape), dtype, g.dtype))
        return troi.roi_align_bwd_plain(
            torch.empty(shape, dtype=dtype), boxes, box_mask, g,
            pooled_h=ph, pooled_w=pw, spatial_scale=scale, sampling_ratio=sr)

    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(troi, "_roi_align_cuda", fwd)
    monkeypatch.setattr(troi, "_roi_align_bwd_cuda", bwd)
    monkeypatch.setattr(troi.roi_align, "launches", 0)
    monkeypatch.setattr(troi.roi_align, "bwd_launches", 0)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, BF16, F16])
def test_cuda_route_under_grad_runs_k1_then_k1b(rng, monkeypatch, dtype):
    """A CUDA map that requires grad goes through the autograd Function:
    one K1 forward (in the output dtype asked for), one K1b backward in
    the map's dtype, whose result is the map's gradient unchanged; boxes
    and mask get none. The counters count one launch each."""
    calls = _fake_kernels(monkeypatch)
    feat, boxes, mask = _edge_case(rng)
    f = T(feat).to(dtype).requires_grad_()
    out = troi.roi_align(f, T(boxes), T(mask), sampling_ratio=1,
                         out_dtype=dtype)
    assert out.requires_grad and out.dtype == dtype
    g = T(rng.normal(size=out.shape).astype(np.float32)).to(dtype)
    out.backward(g)
    assert calls == ["K1", ("K1b", tuple(feat.shape), dtype, dtype)]
    assert (troi.roi_align.launches, troi.roi_align.bwd_launches) == (1, 1)
    want = troi.roi_align_bwd_plain(f.detach(), T(boxes), T(mask), g,
                                    sampling_ratio=1)
    assert f.grad.dtype == dtype and torch.equal(f.grad, want)


class _FakeBwdLib(_FakeLib):
    def roi_align_bwd(self, *args):
        self.calls.append(("bwd",) + args)
        return 0


@pytest.mark.parametrize("g_dtype,f_dtype", [
    (torch.float32, torch.float32), (BF16, BF16), (torch.float32, BF16),
    (BF16, torch.float32), (F16, F16), (torch.float32, F16),
    (F16, torch.float32)])
def test_k1b_launch_reads_g_and_the_mask_in_place(monkeypatch, g_dtype,
                                                  f_dtype):
    """K1b's wrapper hands the kernel g's own storage (a contiguous g is
    not copied), the fp32 boxes and the bool mask in place, a dF of the
    map's dtype and shape, and the forward's pooled sizes, scale and
    sampling ratio."""
    lib = _FakeBwdLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    g = torch.zeros(2, 3, 14, 14, 16, dtype=g_dtype)
    boxes = torch.zeros(2, 3, 4)
    mask = torch.tensor([[True, False, True], [True, True, False]])
    df = troi._roi_align_bwd_cuda(g, boxes, mask, (2, 5, 6, 16), f_dtype, 14,
                                  14, 1.0 / 16, 2)
    ((name, *args),) = lib.calls
    assert name == "bwd" and df.shape == (2, 5, 6, 16) and df.dtype == f_dtype
    assert args[0] == g.data_ptr() and args[1] == ops.DTYPE_CODES[g_dtype]
    assert args[2] == boxes.data_ptr() and args[3] == mask.data_ptr()
    assert args[4] == df.data_ptr() and args[5] == ops.DTYPE_CODES[f_dtype]
    assert args[6:13] == [2, 5, 6, 16, 3, 14, 14]
    assert args[13:16] == [1.0 / 16, 2, troi.MAX_GRID]


@pytest.mark.parametrize("case,exc,match", [
    ("g shape", ValueError, "g must be"),
    ("g fp64", TypeError, "fp32, bf16 or fp16"),
    ("g fp16 dF bf16", TypeError, "not mixed"),
    ("pooled 17", ValueError, "pooled sizes up to 16"),
    ("bf16 C=12", ValueError, "16 bytes of channels"),
    ("fp32 C=4100", ValueError, "at most 512"),
])
def test_k1b_refuses_what_the_kernel_cannot_take(monkeypatch, case, exc,
                                                 match):
    lib = _FakeBwdLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    C, P, dtype, shape, f_dtype = 16, 14, torch.float32, None, torch.float32
    if case == "g fp64":
        dtype = torch.float64
    if case == "g fp16 dF bf16":
        dtype, f_dtype = F16, BF16
    if case == "pooled 17":
        P = 17
    if case == "bf16 C=12":
        C, dtype = 12, BF16
    if case == "fp32 C=4100":
        C = 4100
    g = torch.zeros(1, 2, P, P, C, dtype=dtype)
    if case == "g shape":
        shape = (1, 5, 6, C + 4)
    with pytest.raises(exc, match=match):
        troi._roi_align_bwd_cuda(g, torch.zeros(1, 2, 4),
                                 torch.ones(1, 2, dtype=torch.bool),
                                 shape or (1, 5, 6, C), f_dtype, P, P,
                                 1.0 / 16, 1)
    assert lib.calls == []


# ------------------------------- K1b's design: the rois that touch a row

K1B_TILE = 4       # pixels of a map row a K1b block takes (C = 1024, bf16)


def _axis_roi(boxes, axis, scale=1.0 / 16):
    """roi::axis_roi in fp32: the roi's start and extent (at least 1) in
    map units along rows (axis 0) or columns (axis 1)."""
    a = boxes[..., 1 - axis] * np.float32(scale)
    b = boxes[..., 3 - axis] * np.float32(scale)
    return a, np.maximum(b - a, np.float32(1.0))


def _may_touch(start, size, lo, hi):
    """roi::may_touch: the kernel's test of whether a roi's samples may
    reach pixels lo..hi of one axis, from the box alone."""
    return (np.float32(hi) + 2 >= start) & (np.float32(lo) - 2
                                            <= start + size)


def k1b_model(shape, boxes, mask, g, sampling_ratio=1, tile=K1B_TILE):
    """K1b's gather as its kernel orders it, in plain PyTorch: for each map
    row h and tile of ``tile`` pixels, the live slots that may touch the
    row and the tile (_may_touch), compacted in roi order; then for each
    pixel, roi by roi, Ry[o,p,h] * sum_q Cx[o,q,w] g[o,p,q], skipping zero
    weights. Also returns how many (block, roi) pairs the compaction
    kept, of the B * H * tiles * O it tested."""
    B, H, W, C = shape
    O = boxes.shape[1]
    bt = T(boxes)
    ry, cx = troi.roi_align_weights(bt, H, W, 14, 14, 1.0 / 16,
                                    sampling_ratio)
    ys, yl = _axis_roi(boxes, 0)
    xs, xl = _axis_roi(boxes, 1)
    gt = T(g).float()
    df = torch.zeros(shape)
    kept = 0
    for b in range(B):
        for h in range(H):
            for w0 in range(0, W, tile):
                tn = min(tile, W - w0)
                hits = [o for o in range(O) if mask[b, o]
                        and _may_touch(ys[b, o], yl[b, o], h, h)
                        and _may_touch(xs[b, o], xl[b, o], w0, w0 + tn - 1)]
                kept += len(hits)
                for w in range(w0, w0 + tn):
                    acc = torch.zeros(C)
                    for o in hits:
                        for p in torch.nonzero(ry[b, o, :, h]).flatten():
                            row = torch.zeros(C)
                            for q in torch.nonzero(cx[b, o, :, w]).flatten():
                                row = row + cx[b, o, q, w] * gt[b, o, p, q]
                            acc = acc + ry[b, o, p, h] * row
                    df[b, h, w] = acc
    return df, kept, B * H * -(-W // tile) * O


def _k1b_case(rng, name):
    """(map shape, boxes, mask) of the edge cases K1b's design must keep:
    "edge", K1's edge boxes (past the map's edges, entirely outside,
    sub-pixel, the far corner) in two images with padded slots; "one_row",
    boxes whose extent is under one map row (forced to 1x1, spanning one
    row and its neighbour's taps), on a row's boundary and inside it;
    "padded", every slot padded; "portrait", the portrait map [1,63,38,
    1024] with the serve boxes transposed."""
    if name == "edge":
        feat, boxes, mask = _edge_case(rng)
        return feat.shape, boxes, mask
    if name == "one_row":
        boxes = np.array([[[0, 160, 999, 160], [10, 161, 500, 175.9],
                           [300, 592, 700, 600], [40, 0, 900, 8],
                           [0, -20, 999, -17], [5, 200.5, 6, 200.5]]],
                         np.float32)
        return (1, 38, 63, 16), boxes, np.ones((1, 6), bool)
    if name == "padded":
        feat, boxes, mask = _edge_case(rng)
        return feat.shape, boxes, np.zeros_like(mask)
    b0 = np.asarray(K1_SERVE_BOXES, np.float32)[None, :, [1, 0, 3, 2]]
    mask = np.zeros((1, len(K1_SERVE_BOXES)), bool)
    mask[0, :K1_SERVE_LIVE] = True
    return (1, 63, 38, 1024), b0, mask


@pytest.mark.parametrize("sampling_ratio", [0, 1, 2])
def test_k1b_compaction_keeps_every_roi_that_touches_a_pixel(
        rng, sampling_ratio):
    """roi::may_touch is a superset of the pixels a roi's weights reach:
    wherever Ry[o,p,h] or Cx[o,q,w] is nonzero (the plain version's
    weights, by the forward's rules), the test holds for that row or
    column. On K1's edge boxes, boxes under one map row, the portrait map,
    and 4000 random boxes of every size around and across the map."""
    sets = [_k1b_case(rng, n) for n in ("edge", "one_row", "portrait")]
    xy = rng.uniform([-200, -200], [1200, 800], (4000, 2))
    wh = rng.uniform(0, 1, (4000, 2)) * rng.choice([0.5, 8, 60, 600, 1500],
                                                   (4000, 1))
    rand = np.concatenate([xy, xy + wh], 1).astype(np.float32)[None]
    sets.append(((1, 38, 63, 16), rand, np.ones((1, 4000), bool)))
    for k, ((_, H, W, _), boxes, _) in enumerate(sets):
        ry, cx = troi.roi_align_weights(T(boxes), H, W, 14, 14, 1.0 / 16,
                                        sampling_ratio)
        for axis, wts, n in ((0, ry, H), (1, cx, W)):
            start, size = _axis_roi(boxes, axis)
            touched = (wts != 0).any(-2).numpy()          # [B, O, n]
            pix = np.arange(n, dtype=np.float32)
            test = _may_touch(start[..., None], size[..., None], pix, pix)
            assert not (touched & ~test).any()
            if k == 3:
                continue
            # and tight enough to skip rois: on the edge cases at most
            # three pixels past either end of a roi's footprint (random
            # boxes across an edge with bins wider than a pixel leave
            # wider gaps, which the test keeps)
            first = np.where(touched.any(-1), touched.argmax(-1), 0)
            last = np.where(touched.any(-1),
                            n - 1 - touched[..., ::-1].argmax(-1), -1)
            hull = (pix >= first[..., None]) & (pix <= last[..., None])
            assert (test & ~hull).sum(-1).max() <= 6


@pytest.mark.parametrize("case,sampling_ratio", [
    ("edge", 1), ("edge", 0), ("edge", 2), ("one_row", 1), ("padded", 1),
    ("portrait", 1)])
def test_k1b_model_matches_plain(rng, case, sampling_ratio):
    """K1b's design, modelled on the CPU (k1b_model: the per-tile
    compaction in roi order, then the gather), against roi_align_bwd_plain
    within K1b's fp32 tolerance on chip_smoke.py (1e-5 of the largest
    |dF|), with the padded slots' g at 1e6; pixels no roi covers are
    zeros."""
    shape, boxes, mask = _k1b_case(rng, case)
    g = rng.normal(size=(shape[0], boxes.shape[1], 14, 14, shape[3])) \
        .astype(np.float32)
    g[~mask] = 1e6
    got, kept, tested = k1b_model(shape, boxes, mask, g, sampling_ratio)
    want = troi.roi_align_bwd_plain(torch.zeros(shape), T(boxes), T(mask),
                                    T(g), sampling_ratio=sampling_ratio)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-5 * scale
    assert kept <= tested
    if case == "padded":
        assert kept == 0 and not got.any()
    else:
        assert want.abs().max() > 1.0 and kept < tested
        assert torch.equal(got == 0, want == 0)


def test_k1b_model_matches_jax_vjp(rng):
    """The same model against jax.vjp of the JAX package's roi_align
    (impl="xla": autodiff of the separable einsums) on K1's edge boxes."""
    import jax

    feat, boxes, mask = _edge_case(rng)
    g = rng.normal(size=(2, 16, 14, 14, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: j_roi_align(
        x, jnp.asarray(boxes), jnp.asarray(mask), impl="xla",
        sampling_ratio=1), jnp.asarray(feat))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got, _, _ = k1b_model(feat.shape, boxes, mask, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
