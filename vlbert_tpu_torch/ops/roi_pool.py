"""ROIPool (max-pooling variant) — API-parity op (port of
vlbert_tpu/ops/roi_pool.py).

ref: common/lib/roi_pooling/cuda/ROIPool_cuda.cu — max pool over each bin's
integer sub-window with rounded ROI coords. The reference exports it
alongside ROIAlign but FastRCNN only instantiates ROIAlign
(common/fast_rcnn.py:10-11,66), and no model path of either package calls
it: it is plain PyTorch on the tensors' device, with no kernel of its own
(the JAX op is XLA, not Pallas).

Bin rule (CUDA kernel), as the JAX op has it: roi coords are ROUNDED after
scaling — C ``round()`` is half away from zero, and coordinates are
non-negative, so ``floor(x + 0.5)`` — width / height forced >= 1, bin
boundaries the floor / ceil of linear interpolation, clamped to the map;
an empty bin is 0.
"""

from __future__ import annotations

import torch

NEG = -1e30


def roi_pool(features, boxes, box_mask, pooled_h=7, pooled_w=7,
             spatial_scale=1.0 / 16):
    """features [B, H, W, C] -> [B, O, ph, pw, C] max-pooled ROIs (fp32);
    boxes [B, O, 4] (x1, y1, x2, y2) in image pixels, box_mask [B, O]."""
    B, H, W, C = features.shape
    f = features.to(torch.float32)
    b = boxes.to(torch.float32) * spatial_scale
    x1, y1, x2, y2 = torch.floor(b + 0.5).unbind(-1)
    roi_w = torch.clamp(x2 - x1 + 1, min=1.0)
    roi_h = torch.clamp(y2 - y1 + 1, min=1.0)

    def membership(start, size, pooled, n):
        """[B, O, pooled, n]: grid index in bin p's [floor, ceil)."""
        p = torch.arange(pooled, dtype=torch.float32, device=f.device)
        # XLA compiles the JAX op's division by the bin count as a
        # product with its fp32 reciprocal, which moves some bin edges by
        # one ulp across an integer: the same product here
        inv = torch.tensor(1.0 / pooled, dtype=torch.float32,
                           device=f.device)
        lo = torch.floor(p * size[..., None] * inv + start[..., None])
        hi = torch.ceil((p + 1) * size[..., None] * inv
                        + start[..., None])
        lo, hi = lo.clamp(0, n), hi.clamp(0, n)
        idx = torch.arange(n, dtype=torch.float32, device=f.device)
        return (idx >= lo[..., None]) & (idx < hi[..., None])

    my = membership(y1, roi_h, pooled_h, H)          # [B, O, ph, H]
    mx = membership(x1, roi_w, pooled_w, W)          # [B, O, pw, W]
    neg = torch.tensor(NEG, dtype=torch.float32, device=f.device)
    # one pooled row, then one pooled column, at a time: intermediates of
    # [B, O, H, W, C] at most
    rows = torch.stack([torch.where(my[:, :, p, :, None, None],
                                    f[:, None], neg).amax(2)
                        for p in range(pooled_h)], 2)  # [B, O, ph, W, C]
    out = torch.stack([torch.where(mx[:, :, None, q, :, None], rows,
                                   neg).amax(3)
                       for q in range(pooled_w)], 3)   # [B, O, ph, pw, C]
    empty = (my.sum(3) == 0)[:, :, :, None, None] \
        | (mx.sum(3) == 0)[:, :, None, :, None]
    out = torch.where(empty | (out <= NEG / 2), 0.0, out)
    return out * box_mask[..., None, None, None].to(out.dtype)
