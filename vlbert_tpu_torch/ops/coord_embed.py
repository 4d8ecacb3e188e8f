"""Sin/cos coordinate embeddings of boxes (port of vlbert_tpu/ops/coord_embed.py).

boxes [..., 6] = (x1, y1, x2, y2, w_img, h_img) become (x_c, y_c, w, h) in
percent of the image size, expanded to sin/cos features with frequency base
1000, in fp32. Returns [..., 4, 2*dim].
"""

from __future__ import annotations

import torch


def coordinate_embeddings(boxes, dim):
    boxes = boxes.to(torch.float32)
    w_img = boxes[..., 4]
    h_img = boxes[..., 5]

    xc = (boxes[..., 0] + boxes[..., 2]) / 2
    yc = (boxes[..., 1] + boxes[..., 3]) / 2
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]

    pos = torch.stack([
        xc / w_img * 100,
        yc / h_img * 100,
        bw / w_img * 100,
        bh / h_img * 100,
    ], dim=-1)                                               # [..., 4]

    dim_mat = 1000.0 ** (torch.arange(dim, dtype=torch.float32,
                                      device=boxes.device) / dim)
    arg = pos[..., None] / dim_mat                           # [..., 4, dim]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
