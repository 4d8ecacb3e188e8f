"""COCO RLE mask codec — ctypes binding to the native C++ library, with a
pure-numpy fallback (port copy of vlbert_tpu/data/coco_mask.py, unchanged
but for the library it loads: the port's own build of
csrc/host/maskapi.cc, ``native_build.load_native_lib("maskapi")``, and
the argument types it declares for each entry point).

Native equivalent of the reference's vendored pycocotools C/Cython codec
(ref: refcoco/data/datasets/refer/external/maskApi.c, _mask.pyx — built by
refcoco/data/datasets/refer/Makefile). Supports the COCO 'counts' RLE
convention (column-major, starting with zeros) including the compressed
LEB128-style string encoding used in annotation files.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from vlbert_tpu_torch.data.native_build import load_native_lib

    lib = load_native_lib("maskapi")
    if lib is not None:
        u32, u8 = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8)
        f64, i = ctypes.POINTER(ctypes.c_double), ctypes.c_int
        for name, restype, argtypes in (
                ("rle_decode", i, [u32, i, i, i, u8]),
                ("rle_encode", i, [u8, i, i, u32, i]),
                ("rle_to_bbox", None, [u32, i, i, i, f64]),
                ("rle_area", ctypes.c_uint64, [u32, i]),
                ("rle_iou", ctypes.c_double, [u32, i, u32, i]),
                ("rle_from_poly", i, [f64, i, i, i, u32, i])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
        return lib
    _LIB = False
    return False


def _as_u32(counts):
    return np.ascontiguousarray(np.asarray(counts, np.uint32))


def decode(counts, h, w):
    """RLE counts -> [h, w] uint8 mask."""
    counts = _as_u32(counts)
    lib = _load_lib()
    if lib:
        mask = np.zeros(h * w, np.uint8)
        rc = lib.rle_decode(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(counts), h, w, mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise ValueError("invalid RLE")
        return mask.reshape(w, h).T          # column-major -> [h, w]
    # numpy fallback
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size != h * w:
        raise ValueError("invalid RLE")
    return flat.reshape(w, h).T


def encode(mask):
    """[h, w] uint8/bool mask -> RLE counts (uint32)."""
    mask = np.asarray(mask)
    h, w = mask.shape
    col = np.ascontiguousarray((mask.T != 0).astype(np.uint8)).reshape(-1)
    lib = _load_lib()
    if lib:
        buf = np.zeros(h * w + 2, np.uint32)
        n = lib.rle_encode(
            col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(buf))
        if n < 0:
            raise ValueError("RLE buffer overflow")
        return buf[:n].copy()
    # numpy fallback
    changes = np.flatnonzero(np.diff(col)) + 1
    bounds = np.concatenate([[0], changes, [col.size]])
    counts = np.diff(bounds)
    if col[0] == 1:
        counts = np.concatenate([[0], counts])
    return counts.astype(np.uint32)


def to_bbox(counts, h, w):
    """RLE -> [x, y, w, h] float bbox."""
    counts = _as_u32(counts)
    lib = _load_lib()
    if lib:
        bb = np.zeros(4, np.float64)
        lib.rle_to_bbox(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(counts), h, w, bb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return bb
    m = decode(counts, h, w)
    ys, xs = np.nonzero(m)
    if xs.size == 0:
        return np.zeros(4)
    return np.asarray([xs.min(), ys.min(),
                       xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
                      np.float64)


def area(counts):
    counts = _as_u32(counts)
    lib = _load_lib()
    if lib:
        return int(lib.rle_area(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(counts)))
    return int(counts[1::2].sum())


def iou(counts_a, counts_b):
    """IoU between two RLE masks of the same h x w.

    Fallback mirrors csrc/host/maskapi.cc rle_iou (merged run traversal, no
    mask materialization) so REFER works without a C++ toolchain
    (ref: refcoco/data/datasets/refer/external/maskApi.c rleIou).
    """
    a, b = _as_u32(counts_a), _as_u32(counts_b)
    lib = _load_lib()
    if lib:
        return float(lib.rle_iou(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(a),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(b)))
    if len(a) == 0 or len(b) == 0:
        return 0.0
    area_a = int(a[1::2].sum())
    area_b = int(b[1::2].sum())
    inter = 0
    ia = ib = 0
    pa, pb = int(a[0]), int(b[0])    # positions of the next transitions
    va = vb = False
    pos = 0
    while ia < len(a) and ib < len(b):
        nxt = min(pa, pb)
        if va and vb:
            inter += nxt - pos
        pos = nxt
        if pa == nxt:
            va = not va
            ia += 1
            if ia < len(a):
                pa += int(a[ia])
        if pb == nxt:
            vb = not vb
            ib += 1
            if ib < len(b):
                pb += int(b[ib])
    union = area_a + area_b - inter
    return inter / union if union else 0.0


def from_poly(xy, h, w):
    """[(x, y), ...] polygon -> RLE counts.

    Fallback mirrors csrc/host/maskapi.cc rle_from_poly: even-odd test at
    pixel centers (vectorized over the grid, one pass per edge), with the
    same degenerate-polygon boundary rasterization when the fill is empty
    (ref: refcoco/data/datasets/refer/external/maskApi.c rleFrPoly).
    """
    xy = np.ascontiguousarray(np.asarray(xy, np.float64).reshape(-1))
    k = xy.size // 2
    lib = _load_lib()
    if lib:
        buf = np.zeros(h * w + 2, np.uint32)
        n = lib.rle_from_poly(
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), k, h, w,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(buf))
        if n < 0:
            raise ValueError("RLE buffer overflow")
        return buf[:n].copy()
    px = np.arange(w, dtype=np.float64)[None, :] + 0.5   # [h, w]
    py = np.arange(h, dtype=np.float64)[:, None] + 0.5
    inside = np.zeros((h, w), bool)
    for i in range(k):
        j = (i - 1) % k
        xi, yi = xy[2 * i], xy[2 * i + 1]
        xj, yj = xy[2 * j], xy[2 * j + 1]
        crosses = ((yi > py) != (yj > py)) \
            & (px < (xj - xi) * (py - yi) / (yj - yi + 1e-12) + xi)
        inside ^= crosses
    if not inside.any():
        # degenerate polygon: rasterize the (densely sampled) boundary so
        # thin slivers/lines yield their outline, exactly like the native
        # path (and pycocotools' 5x upsampled boundary scan)
        for i in range(k):
            j = (i - 1) % k
            xi, yi = xy[2 * i], xy[2 * i + 1]
            xj, yj = xy[2 * j], xy[2 * j + 1]
            dx, dy = xi - xj, yi - yj
            steps = int(max(abs(dx), abs(dy)) * 5.0) + 1
            t = np.arange(steps + 1, dtype=np.float64) / steps
            bx = (xj + t * dx).astype(np.int64)   # C-cast truncation
            by = (yj + t * dy).astype(np.int64)
            ok = (bx >= 0) & (bx < w) & (by >= 0) & (by < h)
            inside[by[ok], bx[ok]] = True
    return encode(inside)


def decode_compressed(counts_str, h, w):
    """COCO compressed counts string -> mask (LEB128-ish signed-delta
    encoding used in annotation json files)."""
    counts = []
    i = 0
    s = counts_str.encode() if isinstance(counts_str, str) else counts_str
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return decode(np.asarray(counts, np.int64).clip(0), h, w)
