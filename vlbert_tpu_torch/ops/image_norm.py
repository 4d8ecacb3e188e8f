"""On-device normalization of uint8 images (port of vlbert_tpu/ops/image_norm.py).

The host may ship uint8 RGB images; this turns them into the BGR255-minus-
caffe-mean fp32 values the backbone expects and zeroes the FixPadding canvas
(x >= w or y >= h from ``im_info``) after normalization, exactly as the
host float path does.
"""

from __future__ import annotations

import torch


def normalize_uint8_image(images, im_info, pixel_means, pixel_stds,
                          to_bgr255=True):
    """[B, H, W, 3] uint8 RGB -> [B, H, W, 3] fp32 normalized, zero-padded.

    Args:
      images: [B, H, W, 3] uint8 (RGB order, as decoded).
      im_info: [B, >=2] (w, h, ...) of the valid (resized, pre-padding)
        region per image.
      pixel_means / pixel_stds: 3-tuples in BGR order (caffe means).
    """
    B, H, W, _ = images.shape
    dev = images.device
    if to_bgr255:
        x = images.flip(-1).to(torch.float32)
    else:
        # 0-1 RGB scale, whose means are 0-1-scale too
        x = images.to(torch.float32) / 255.0
    x = x - torch.tensor(pixel_means, dtype=torch.float32, device=dev)
    stds = tuple(float(s) for s in pixel_stds)
    if any(s != 1.0 for s in stds):
        x = x / torch.tensor(stds, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W, 1)
    ys = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1, 1)
    info = im_info.to(device=dev, dtype=torch.float32)
    w = info[:, 0].view(B, 1, 1, 1)
    h = info[:, 1].view(B, 1, 1, 1)
    valid = (xs < w) & (ys < h)
    return torch.where(valid, x, torch.zeros((), device=dev))
