"""ROIAlign (port of vlbert_tpu/ops/roi_align.py).

Reference semantics (ROIAlign_cuda.cu of the original VL-BERT): rois are
(x1, y1, x2, y2) in image coords scaled by ``spatial_scale`` with no
rounding, forced to at least 1x1, each of the P x P bins averages a gh x gw
grid of bilinear samples (gh = ceil(roi_h / P) when ``sampling_ratio`` is 0),
samples with y < -1 or y > H contribute 0, y is clamped to 0 from below and
y_low = y_high = H-1 at the top edge. Computed in fp32.

Two versions of the forward and of the map's gradient:
  * ``roi_align_plain``: the separable formulation of the JAX package
    (row weights Ry[B,O,P,H] and column weights Cx[B,O,Q,W], two einsums) in
    plain PyTorch. It is exact, and it is the oracle for kernel K1
    (``csrc/roi_align.cu``), launched by ``roi_align`` for CUDA tensors.
  * ``roi_align_bwd_plain``: the map's gradient, the dF half of the JAX
    package's ``_sep_bwd`` (two einsums), the oracle for kernel K1b
    (``csrc/roi_align_bwd.cu``: a gather per map pixel over the rois
    that touch its row, deterministic). ``roi_align`` on a CUDA
    map that requires grad runs K1 forward and K1b backward in one
    ``torch.autograd.Function``. Boxes come from data: they get no
    gradient, and asking for one on CUDA raises.

Both take ``out_dtype`` (fp32, the JAX kernel's contract, bf16 or fp16):
the fp32 result rounded once to it, so a caller that computes in bf16 or
fp16 gets its input in one pass, with no cast after it. The kernels do not
mix the two 16-bit types: a bf16 map gives fp32 or bf16, an fp16 map fp32
or fp16 (and so for K1b's g and dF).

Layout: features are NHWC; boxes are [B, O, 4] padded per image with a
validity mask [B, O]; padded slots produce zeros.
"""

from __future__ import annotations

import torch

from vlbert_tpu_torch import ops

# Cap on the adaptive sampling grid, as in the JAX package. An explicit
# sampling_ratio above it is rejected.
MAX_GRID = 8
# the output types the kernel stores; the accumulation is fp32 in all
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the kernel moves 16 bytes of channels a thread: C must be a multiple of
# this many elements, and the map must start on a 16-byte boundary
VECTOR_ELEMENTS = {torch.float32: 4, torch.bfloat16: 8, torch.float16: 8}
# K1b keeps one roi pass's weights in shared memory for pooled sizes up to
# this, and gives a pixel at most the 8 warps of its block, 64 16-byte
# chunks of its channels each
MAX_POOLED = 16
MAX_BWD_CHUNKS = 512


def _interp_weights(start, roi_size, grid_n, pooled_size, fm_size):
    """1-D separable interpolation weights for one axis.

    start, roi_size: [*B] fp32 in feature coords; grid_n: [*B] int samples
    per bin (<= MAX_GRID). Returns [*B, P, fm_size] such that
    out_row[p] = sum_h weights[p, h] * feature_row[h] is the average of the
    grid_n bilinear samples of bin p.
    """
    dev = start.device
    bin_size = roi_size / pooled_size                       # [*B]
    p = torch.arange(pooled_size, dtype=torch.float32, device=dev)
    g = torch.arange(MAX_GRID, dtype=torch.float32, device=dev)
    grid_f = grid_n.to(torch.float32)

    # sample coordinate y = start + p*bin + (g+0.5)*bin/grid_n
    y = (start[..., None, None]
         + p[:, None] * bin_size[..., None, None]
         + (g[None, :] + 0.5) * bin_size[..., None, None]
         / grid_f[..., None, None])                         # [*B, P, G]

    valid = g[None, :] < grid_f[..., None, None]            # sample exists
    in_range = (y >= -1.0) & (y <= fm_size)
    yc = torch.clamp(y, min=0.0)
    y_low = torch.floor(yc)
    top = y_low >= fm_size - 1
    y_low = torch.where(top, torch.full_like(y_low, fm_size - 1.0), y_low)
    y_high = torch.where(top, y_low, y_low + 1.0)
    ly = torch.where(top, torch.zeros_like(yc), yc - y_low)

    contrib = torch.where(valid & in_range, 1.0 / grid_f[..., None, None],
                          torch.zeros_like(y))
    low_w = contrib * (1.0 - ly)                            # [*B, P, G]
    high_w = contrib * ly

    hh = torch.arange(fm_size, dtype=torch.int64, device=dev)
    low_oh = (y_low.to(torch.int64)[..., None] == hh)       # [*B, P, G, H]
    high_oh = (y_high.to(torch.int64)[..., None] == hh)
    w = low_w[..., None] * low_oh + high_w[..., None] * high_oh
    return w.sum(dim=-2)                                    # [*B, P, H]


def _check_sampling_ratio(sampling_ratio):
    if sampling_ratio > MAX_GRID:
        raise ValueError(
            f"sampling_ratio {sampling_ratio} exceeds the grid cap "
            f"MAX_GRID={MAX_GRID} (weights would sum to "
            f"{MAX_GRID}/{sampling_ratio}); raise MAX_GRID to support it")


def roi_align_weights(boxes, fm_h, fm_w, pooled_h, pooled_w,
                      spatial_scale, sampling_ratio=0):
    """(Ry, Cx) separable weights for padded boxes [..., 4]."""
    boxes = boxes.to(torch.float32)
    x1 = boxes[..., 0] * spatial_scale
    y1 = boxes[..., 1] * spatial_scale
    x2 = boxes[..., 2] * spatial_scale
    y2 = boxes[..., 3] * spatial_scale
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)

    _check_sampling_ratio(sampling_ratio)
    if sampling_ratio > 0:
        gh = torch.full(roi_h.shape, sampling_ratio, dtype=torch.int32,
                        device=boxes.device)
        gw = gh
    else:
        gh = torch.clamp(torch.ceil(roi_h / pooled_h), max=MAX_GRID) \
            .to(torch.int32)
        gw = torch.clamp(torch.ceil(roi_w / pooled_w), max=MAX_GRID) \
            .to(torch.int32)

    ry = _interp_weights(y1, roi_h, gh, pooled_h, fm_h)     # [..., P, H]
    cx = _interp_weights(x1, roi_w, gw, pooled_w, fm_w)     # [..., Q, W]
    return ry, cx


def _check_out_dtype(out_dtype):
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"roi_align: out_dtype must be torch.float32, "
                        f"torch.bfloat16 or torch.float16, got {out_dtype}")


def _check_kernel_dtypes(name, src, dst):
    """The kernels' types: ``src`` (the map, or K1b's g) and ``dst`` (the
    output, or dF) each fp32, bf16 or fp16, the two 16-bit types not
    mixed."""
    if src not in OUT_DTYPES or dst not in OUT_DTYPES or (
            torch.float32 not in (src, dst) and src != dst):
        raise TypeError(f"{name} takes and gives fp32, bf16 or fp16, bf16 "
                        f"and fp16 not mixed: got {src} -> {dst}")


def roi_align_plain(features, boxes, box_mask, *, pooled_h=14, pooled_w=14,
                    spatial_scale=1.0 / 16, sampling_ratio=0,
                    out_dtype=torch.float32):
    """Plain PyTorch ROIAlign: two separable einsums in fp32, then one cast.

    features [B, H, W, C] (any float), boxes [B, O, 4], box_mask [B, O]
    -> [B, O, pooled_h, pooled_w, C] in ``out_dtype``.
    """
    _, H, W, _ = features.shape
    f32 = features.to(torch.float32)
    ry, cx = roi_align_weights(boxes, H, W, pooled_h, pooled_w,
                               spatial_scale, sampling_ratio)
    mask = box_mask.to(torch.float32)[..., None, None]
    ry = ry * mask                                          # zero padded rois
    cx = cx * mask
    tmp = torch.einsum("boph,bhwc->bopwc", ry, f32)         # rows
    out = torch.einsum("boqw,bopwc->bopqc", cx, tmp)        # cols
    return out.to(out_dtype)


def roi_align(features, boxes, box_mask, *, pooled_h=14, pooled_w=14,
              spatial_scale=1.0 / 16, sampling_ratio=0,
              out_dtype=torch.float32):
    """Batched ROIAlign; launches kernel K1 for CUDA tensors.

    Args:
      features: [B, H, W, C] NHWC feature map, fp32, bf16 or fp16
        (compute fp32)
      boxes:    [B, O, 4] (x1, y1, x2, y2) image coords, padded
      box_mask: [B, O] validity (padded slots produce zeros)
      out_dtype: torch.float32 (the JAX package's contract),
        torch.bfloat16 or torch.float16: the fp32 sums rounded once, in
        the kernel's store
    Returns:
      [B, O, pooled_h, pooled_w, C] in ``out_dtype``

    A CPU tensor takes ``roi_align_plain`` (autograd differentiates it);
    a CUDA tensor launches the kernel or raises. A CUDA map that requires
    grad goes through ``_RoIAlign``: K1 forward, K1b backward.
    """
    _check_out_dtype(out_dtype)
    kind = ops.device_kind(features)
    if kind == "cpu":
        return roi_align_plain(features, boxes, box_mask, pooled_h=pooled_h,
                               pooled_w=pooled_w, spatial_scale=spatial_scale,
                               sampling_ratio=sampling_ratio,
                               out_dtype=out_dtype)
    if kind != "cuda":
        raise ValueError(f"roi_align: unsupported device {features.device}")
    if torch.is_grad_enabled() and boxes.requires_grad:
        raise NotImplementedError(
            "roi_align on CUDA gives no gradient for boxes (they come from "
            "data): detach them")
    if torch.is_grad_enabled() and features.requires_grad:
        return _RoIAlign.apply(features, boxes, box_mask, pooled_h, pooled_w,
                               spatial_scale, sampling_ratio, out_dtype)
    return _roi_align_cuda(features, boxes, box_mask, pooled_h, pooled_w,
                           spatial_scale, sampling_ratio, out_dtype)


class _RoIAlign(torch.autograd.Function):
    """K1 forward, K1b backward; the gradient reaches the map only."""

    @staticmethod
    def forward(ctx, features, boxes, box_mask, pooled_h, pooled_w,
                spatial_scale, sampling_ratio, out_dtype):
        ctx.save_for_backward(boxes, box_mask)
        ctx.args = (tuple(features.shape), features.dtype, pooled_h,
                    pooled_w, spatial_scale, sampling_ratio)
        return _roi_align_cuda(features, boxes, box_mask, pooled_h, pooled_w,
                               spatial_scale, sampling_ratio, out_dtype)

    @staticmethod
    def backward(ctx, g):
        boxes, box_mask = ctx.saved_tensors
        df = _roi_align_bwd_cuda(g, boxes, box_mask, *ctx.args)
        roi_align.bwd_launches += 1
        return df, None, None, None, None, None, None, None


def roi_align_bwd_plain(features, boxes, box_mask, g, *, pooled_h=14,
                        pooled_w=14, spatial_scale=1.0 / 16,
                        sampling_ratio=0):
    """Plain PyTorch dF of ``roi_align``: the first two einsums of the JAX
    package's ``_sep_bwd`` in fp32, cast to the features' dtype.

    features [B, H, W, C] (its shape and dtype only), boxes [B, O, 4],
    box_mask [B, O], g [B, O, pooled_h, pooled_w, C] (any float) ->
    [B, H, W, C]; padded slots contribute nothing.
    """
    _, H, W, _ = features.shape
    ry, cx = roi_align_weights(boxes, H, W, pooled_h, pooled_w,
                               spatial_scale, sampling_ratio)
    mask = box_mask.to(torch.float32)[..., None, None]
    g = g.to(torch.float32)
    gy = torch.einsum("boqw,bopqc->bopwc", cx * mask, g)
    df = torch.einsum("boph,bopwc->bhwc", ry * mask, gy)
    return df.to(features.dtype)


def _check_boxes(B, boxes, box_mask, dev):
    """Boxes [B,O,4] and mask [B,O] on ``dev``, as the kernels read them:
    fp32 boxes, the mask as bytes (a bool is read in place: a conversion
    would be a launch of its own on every call)."""
    if boxes.shape[:1] != (B,) or boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"roi_align: boxes must be [B,O,4], got "
                         f"{tuple(boxes.shape)}")
    O = boxes.shape[1]
    if tuple(box_mask.shape) != (B, O):
        raise ValueError(f"roi_align: box_mask must be [B,O]=({B},{O}), got "
                         f"{tuple(box_mask.shape)}")
    for name, t in (("boxes", boxes), ("box_mask", box_mask)):
        if t.device != dev:
            raise ValueError(f"roi_align: {name} on {t.device}, features on "
                             f"{dev}")
    mask = (box_mask.view(torch.uint8) if box_mask.dtype == torch.bool
            else box_mask.to(torch.uint8)).contiguous()
    return boxes.to(torch.float32).contiguous(), mask, O


def _roi_align_cuda(features, boxes, box_mask, pooled_h, pooled_w,
                    spatial_scale, sampling_ratio, out_dtype):
    from vlbert_tpu_torch.kernels import build

    _check_sampling_ratio(sampling_ratio)
    if features.dim() != 4:
        raise ValueError(f"roi_align: features must be [B,H,W,C], got "
                         f"{tuple(features.shape)}")
    B, H, W, C = features.shape
    _check_kernel_dtypes("roi_align kernel", features.dtype, out_dtype)
    if not features.is_contiguous():
        raise ValueError("roi_align kernel needs NHWC-contiguous features")
    vec = VECTOR_ELEMENTS[features.dtype]
    if C % vec:
        raise ValueError(f"roi_align kernel moves 16 bytes of channels a "
                         f"thread: C={C} is not a multiple of {vec} "
                         f"({features.dtype})")
    if features.data_ptr() % 16:
        raise ValueError("roi_align kernel needs features that start on a "
                         "16-byte boundary")
    dev = features.device
    boxes, mask, O = _check_boxes(B, boxes, box_mask, dev)
    out = torch.empty((B, O, pooled_h, pooled_w, C), dtype=out_dtype,
                      device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.roi_align_fwd(
        features.data_ptr(), ops.DTYPE_CODES[features.dtype],
        boxes.data_ptr(), mask.data_ptr(), out.data_ptr(),
        ops.DTYPE_CODES[out_dtype], B, H, W, C, O, pooled_h, pooled_w,
        float(spatial_scale), int(sampling_ratio), MAX_GRID, stream)
    build.check(err, "roi_align_fwd")
    roi_align.launches += 1
    return out


def _roi_align_bwd_cuda(g, boxes, box_mask, shape, dtype, pooled_h,
                        pooled_w, spatial_scale, sampling_ratio):
    """K1b: dF [B, H, W, C] in ``dtype`` from g [B, O, P, Q, C]."""
    from vlbert_tpu_torch.kernels import build

    B, H, W, C = shape
    dev = g.device
    boxes, mask, O = _check_boxes(B, boxes, box_mask, dev)
    if tuple(g.shape) != (B, O, pooled_h, pooled_w, C):
        raise ValueError(f"roi_align backward: g must be "
                         f"{(B, O, pooled_h, pooled_w, C)}, got "
                         f"{tuple(g.shape)}")
    _check_kernel_dtypes("roi_align backward kernel", g.dtype, dtype)
    if max(pooled_h, pooled_w) > MAX_POOLED:
        raise ValueError(f"roi_align backward kernel takes pooled sizes up "
                         f"to {MAX_POOLED}, got {pooled_h}x{pooled_w}")
    vec = VECTOR_ELEMENTS[g.dtype]
    if C % vec or C // vec > MAX_BWD_CHUNKS:
        raise ValueError(f"roi_align backward kernel moves 16 bytes of "
                         f"channels a thread, at most {MAX_BWD_CHUNKS} a "
                         f"pixel: C={C} ({g.dtype})")
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    df = torch.empty(shape, dtype=dtype, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.roi_align_bwd(
        g.data_ptr(), ops.DTYPE_CODES[g.dtype], boxes.data_ptr(),
        mask.data_ptr(), df.data_ptr(), ops.DTYPE_CODES[dtype], B, H,
        W, C, O, pooled_h, pooled_w, float(spatial_scale),
        int(sampling_ratio), MAX_GRID, stream)
    build.check(err, "roi_align_bwd")
    return df


roi_align.launches = 0        # K1 launches
roi_align.bwd_launches = 0    # K1b launches
