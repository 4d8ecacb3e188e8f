"""ROIAlign (port of vlbert_tpu/ops/roi_align.py).

Reference semantics (ROIAlign_cuda.cu of the original VL-BERT): rois are
(x1, y1, x2, y2) in image coords scaled by ``spatial_scale`` with no
rounding, forced to at least 1x1, each of the P x P bins averages a gh x gw
grid of bilinear samples (gh = ceil(roi_h / P) when ``sampling_ratio`` is 0),
samples with y < -1 or y > H contribute 0, y is clamped to 0 from below and
y_low = y_high = H-1 at the top edge. Computed in fp32.

Two versions of one function:
  * ``roi_align_plain``: the separable formulation of the JAX package
    (row weights Ry[B,O,P,H] and column weights Cx[B,O,Q,W], two einsums) in
    plain PyTorch. It is exact, and it is the oracle for the kernel.
  * kernel K1 (``csrc/roi_align.cu``), launched by ``roi_align`` for CUDA
    tensors.

Layout: features are NHWC; boxes are [B, O, 4] padded per image with a
validity mask [B, O]; padded slots produce zeros.
"""

from __future__ import annotations

import torch

# Cap on the adaptive sampling grid, as in the JAX package. An explicit
# sampling_ratio above it is rejected.
MAX_GRID = 8
# the kernel keeps one row of x taps per bin in shared memory
MAX_POOLED = 32


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


def roi_align_plain(features, boxes, box_mask, *, pooled_h=14, pooled_w=14,
                    spatial_scale=1.0 / 16, sampling_ratio=0):
    """Plain PyTorch ROIAlign: two separable einsums in fp32.

    features [B, H, W, C] (any float), boxes [B, O, 4], box_mask [B, O]
    -> [B, O, pooled_h, pooled_w, C] fp32.
    """
    _, H, W, _ = features.shape
    f32 = features.to(torch.float32)
    ry, cx = roi_align_weights(boxes, H, W, pooled_h, pooled_w,
                               spatial_scale, sampling_ratio)
    mask = box_mask.to(torch.float32)[..., None, None]
    ry = ry * mask                                          # zero padded rois
    cx = cx * mask
    tmp = torch.einsum("boph,bhwc->bopwc", ry, f32)         # rows
    return torch.einsum("boqw,bopwc->bopqc", cx, tmp)       # cols


def roi_align(features, boxes, box_mask, *, pooled_h=14, pooled_w=14,
              spatial_scale=1.0 / 16, sampling_ratio=0):
    """Batched ROIAlign; launches kernel K1 for CUDA tensors.

    Args:
      features: [B, H, W, C] NHWC feature map, fp32 or bf16 (compute fp32)
      boxes:    [B, O, 4] (x1, y1, x2, y2) image coords, padded
      box_mask: [B, O] validity (padded slots produce zeros)
    Returns:
      [B, O, pooled_h, pooled_w, C] fp32

    A CPU tensor takes ``roi_align_plain``; a CUDA tensor launches the
    kernel or raises.
    """
    if features.device.type == "cpu":
        return roi_align_plain(features, boxes, box_mask, pooled_h=pooled_h,
                               pooled_w=pooled_w, spatial_scale=spatial_scale,
                               sampling_ratio=sampling_ratio)
    if features.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {features.device}")
    return _roi_align_cuda(features, boxes, box_mask, pooled_h, pooled_w,
                           spatial_scale, sampling_ratio)


def _roi_align_cuda(features, boxes, box_mask, pooled_h, pooled_w,
                    spatial_scale, sampling_ratio):
    from vlbert_tpu_torch.kernels import build

    _check_sampling_ratio(sampling_ratio)
    if features.dim() != 4:
        raise ValueError(f"roi_align: features must be [B,H,W,C], got "
                         f"{tuple(features.shape)}")
    B, H, W, C = features.shape
    if boxes.shape[:1] != (B,) or boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"roi_align: boxes must be [B,O,4], got "
                         f"{tuple(boxes.shape)}")
    O = boxes.shape[1]
    if tuple(box_mask.shape) != (B, O):
        raise ValueError(f"roi_align: box_mask must be [B,O]=({B},{O}), got "
                         f"{tuple(box_mask.shape)}")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_align kernel takes fp32 or bf16 features, got "
                        f"{features.dtype}")
    if not features.is_contiguous():
        raise ValueError("roi_align kernel needs NHWC-contiguous features")
    if pooled_h > MAX_POOLED or pooled_w > MAX_POOLED:
        raise ValueError(f"roi_align kernel supports pooled sizes up to "
                         f"{MAX_POOLED}, got {pooled_h}x{pooled_w}")
    dev = features.device
    for name, t in (("boxes", boxes), ("box_mask", box_mask)):
        if t.device != dev:
            raise ValueError(f"roi_align: {name} on {t.device}, features on "
                             f"{dev}")
    boxes = boxes.to(torch.float32).contiguous()
    mask = box_mask.to(torch.uint8).contiguous()
    out = torch.empty((B, O, pooled_h, pooled_w, C), dtype=torch.float32,
                      device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.roi_align_fwd(
        features.data_ptr(), int(features.dtype == torch.bfloat16),
        boxes.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, H, W, C, O, pooled_h, pooled_w, float(spatial_scale),
        int(sampling_ratio), MAX_GRID, stream)
    build.check(err, "roi_align_fwd")
    roi_align.launches += 1
    return out


roi_align.launches = 0
