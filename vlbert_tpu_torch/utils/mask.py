"""Polygon -> instance-mask rasterizer (numpy).

ref: common/utils/mask.py:5-32 (skimage.draw.polygon based). Reimplemented
with a vectorized even-odd scanline fill over the mask grid — skimage is not
a dependency here; semantics match skimage.draw.polygon (vertices clamped
into the grid, integer grid-point-inside-polygon test).

Port copy of ``vlbert_tpu/utils/mask.py``, unchanged but for one thing: the
grid cache is bounded (the original's dict grows with every distinct grid
shape it is asked for). The grids are the same, so the masks are too;
``tests/test_torch_host_copies.py`` holds the copy to the original.
"""

from __future__ import annotations

import functools

import numpy as np

# distinct grid shapes kept; the instance masks use one (MASK_SIZE)
GRID_CACHE_SIZE = 8


@functools.lru_cache(maxsize=GRID_CACHE_SIZE)
def _grid(shape):
    H, W = shape
    rr, cc = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    return rr[None], cc[None]


def polygon_fill(r, c, shape):
    """Grid points inside the polygon with vertices (r[i], c[i]).

    Vectorized even-odd rule evaluated at integer grid points, matching
    skimage.draw.polygon's point-in-polygon semantics. All edges are
    evaluated in one broadcast [n_edges, H, W] pass (the per-edge Python
    loop was ~40% of VCR per-sample host cost at 8 masks/item); the edge
    pairing (i, i-1 mod n) and the crossing test are unchanged.
    """
    r = np.asarray(r, np.float64)
    c = np.asarray(c, np.float64)
    rr, cc = _grid(tuple(shape))
    rj_all, cj_all = np.roll(r, 1), np.roll(c, 1)
    H, W = shape
    # bound the [chunk, H, W] broadcast intermediate: irrelevant for the
    # 14x14 instance-mask grids this serves, but the public contract also
    # admits image-resolution grids where an all-edges cube would be tens
    # of MB per polygon
    chunk = max(1, (1 << 22) // max(H * W, 1))
    inside = np.zeros(shape, bool)
    for s in range(0, len(r), chunk):
        ri = r[s:s + chunk, None, None]
        ci = c[s:s + chunk, None, None]
        rj = rj_all[s:s + chunk, None, None]
        cj = cj_all[s:s + chunk, None, None]
        cond = ((ci > cc) != (cj > cc)) & (
            rr < (rj - ri) * (cc - ci) / (cj - ci + 1e-12) + ri)
        inside ^= np.bitwise_xor.reduce(cond, axis=0)
    return inside


def generate_instance_mask(seg_polys, box, mask_size=(14, 14)):
    """ref common/utils/mask.py:5-32: rescale polygons into the box-local
    mask grid and rasterize. seg_polys: list of [N, 2] (x, y) arrays."""
    mh, mw = mask_size
    mask = np.zeros(mask_size, np.float32)
    w_ratio = float(mh) / (box[2] - box[0] + 1)   # note: reference uses
    h_ratio = float(mw) / (box[3] - box[1] + 1)   # mask_size[0]/w, [1]/h
    for poly in seg_polys:
        poly = np.asarray(poly, np.float32)
        # clip bounds follow each axis's own scale: x lands in [0, mh]
        # (w_ratio = mh/box_w, the reference's mask_size[0]/w convention),
        # y in [0, mw] — only visible for non-square mask sizes
        x = np.clip((poly[:, 0] - box[0]) * w_ratio, 0, mh - 1)
        y = np.clip((poly[:, 1] - box[1]) * h_ratio, 0, mw - 1)
        # skimage polygon(y, x): rows = y, cols = x, even-odd fill
        mask[polygon_fill(y, x, mask_size)] = 1.0
    return mask
