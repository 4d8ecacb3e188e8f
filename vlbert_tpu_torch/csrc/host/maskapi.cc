// The PyTorch port's copy of native/maskapi.cc, built with g++ by
// vlbert_tpu_torch/data/native_build.py into vlbert_tpu_torch/_build/
// at first use; tests/test_torch_host_natives.py holds it to the
// original.
//
// COCO-style RLE mask codec — C++ host-side implementation.
//
// Native equivalent of the reference's vendored pycocotools C code
// (ref: refcoco/data/datasets/refer/external/maskApi.c — rleDecode,
// rleEncode, rleToBbox, rleFrPoly, rleArea, rleIou), written fresh for this
// framework and exposed to Python via ctypes (vlbert_tpu/data/coco_mask.py).
//
// RLE convention (COCO): counts alternate runs of 0s and 1s in
// COLUMN-MAJOR (Fortran) order over an h x w mask, starting with 0s.
//
// Build: see native/Makefile (produces libmaskapi.so).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode RLE counts into a column-major uint8 mask buffer of size h*w.
// counts: array of n run lengths. Returns 0 on success, -1 on overflow.
int rle_decode(const uint32_t* counts, int n, int h, int w, uint8_t* mask) {
  const int64_t total = static_cast<int64_t>(h) * w;
  int64_t pos = 0;
  uint8_t val = 0;
  for (int i = 0; i < n; ++i) {
    int64_t run = counts[i];
    if (pos + run > total) return -1;
    std::memset(mask + pos, val, run);
    pos += run;
    val = 1 - val;
  }
  return pos == total ? 0 : -1;
}

// Encode a column-major uint8 mask into RLE counts. Writes up to max_n
// counts; returns the number written, or -1 if max_n is too small.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts,
               int max_n) {
  const int64_t total = static_cast<int64_t>(h) * w;
  int n = 0;
  uint8_t cur = 0;
  uint32_t run = 0;
  for (int64_t i = 0; i < total; ++i) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v == cur) {
      ++run;
    } else {
      if (n >= max_n) return -1;
      counts[n++] = run;
      cur = v;
      run = 1;
    }
  }
  if (n >= max_n) return -1;
  counts[n++] = run;
  return n;
}

// Bounding box [x, y, w, h] of an RLE mask (COCO rleToBbox semantics:
// zero box for an empty mask).
void rle_to_bbox(const uint32_t* counts, int n, int h, int w, double* bb) {
  int64_t pos = 0;
  uint8_t val = 0;
  int xmin = w, xmax = -1, ymin = h, ymax = -1;
  for (int i = 0; i < n; ++i) {
    int64_t run = counts[i];
    if (val && run > 0) {
      // runs are column-major: index -> (y = idx % h, x = idx / h)
      // (zero-length runs occur in real COCO RLEs — merge/frPyObjects
      // emit them; maskApi.c's rleToBbox skips them too, and processing
      // one here would compute end < start and corrupt the box)
      int64_t start = pos, end = pos + run - 1;
      int xs = static_cast<int>(start / h), xe = static_cast<int>(end / h);
      xmin = std::min(xmin, xs);
      xmax = std::max(xmax, xe);
      if (xs == xe) {
        ymin = std::min<int>(ymin, static_cast<int>(start % h));
        ymax = std::max<int>(ymax, static_cast<int>(end % h));
      } else {
        ymin = 0;
        ymax = h - 1;
      }
    }
    pos += run;
    val = 1 - val;
  }
  if (xmax < 0) {
    bb[0] = bb[1] = bb[2] = bb[3] = 0.0;
    return;
  }
  bb[0] = xmin;
  bb[1] = ymin;
  bb[2] = xmax - xmin + 1;
  bb[3] = ymax - ymin + 1;
}

// Mask area (count of 1s).
uint64_t rle_area(const uint32_t* counts, int n) {
  uint64_t a = 0;
  for (int i = 1; i < n; i += 2) a += counts[i];
  return a;
}

// IoU between two RLE masks of the same h x w (intersection via merged
// run traversal, no materialization).
double rle_iou(const uint32_t* ca, int na, const uint32_t* cb, int nb) {
  if (na <= 0 || nb <= 0) return 0.0;  // empty counts: no OOB read
  uint64_t inter = 0;
  uint64_t area_a = rle_area(ca, na), area_b = rle_area(cb, nb);
  int ia = 0, ib = 0;
  uint64_t pa = ca[0], pb = cb[0];  // positions of next transitions
  uint8_t va = 0, vb = 0;
  uint64_t pos = 0;
  while (ia < na && ib < nb) {
    uint64_t next = std::min(pa, pb);
    if (va && vb) inter += next - pos;
    pos = next;
    if (pa == next) {
      va = 1 - va;
      if (++ia < na) pa += ca[ia];
    }
    if (pb == next) {
      vb = 1 - vb;
      if (++ib < nb) pb += cb[ib];
    }
  }
  uint64_t uni = area_a + area_b - inter;
  return uni ? static_cast<double>(inter) / static_cast<double>(uni) : 0.0;
}

// Rasterize a polygon ((x, y) float pairs) into RLE counts, matching COCO's
// rleFrPoly: integer upsampled-boundary scan. Simplified exact even-odd
// fill at pixel centers + 0.5 offsets like pycocotools' behavior.
int rle_from_poly(const double* xy, int k, int h, int w, uint32_t* counts,
                  int max_n) {
  std::vector<uint8_t> mask(static_cast<size_t>(h) * w, 0);
  // even-odd test at pixel centers, column-major fill
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      double px = x + 0.5, py = y + 0.5;
      bool inside = false;
      for (int i = 0, j = k - 1; i < k; j = i++) {
        double xi = xy[2 * i], yi = xy[2 * i + 1];
        double xj = xy[2 * j], yj = xy[2 * j + 1];
        if (((yi > py) != (yj > py)) &&
            (px < (xj - xi) * (py - yi) / (yj - yi + 1e-12) + xi)) {
          inside = !inside;
        }
      }
      mask[static_cast<size_t>(x) * h + y] = inside ? 1 : 0;
    }
  }
  // Degenerate-polygon fallback: pycocotools' rleFrPoly scans the
  // 5x-upsampled integer boundary, so thin slivers and line polygons
  // rasterize to their outline instead of an empty mask. The center-point
  // even-odd fill misses them entirely — when it produced NOTHING, mark
  // the (densely sampled) boundary pixels so the mask is at least the
  // polygon's outline.
  bool any = false;
  for (size_t idx = 0; idx < mask.size() && !any; ++idx) any = mask[idx];
  if (!any) {
    for (int i = 0, j = k - 1; i < k; j = i++) {
      double xi = xy[2 * i], yi = xy[2 * i + 1];
      double xj = xy[2 * j], yj = xy[2 * j + 1];
      double dx = xi - xj, dy = yi - yj;
      int steps =
          static_cast<int>(std::max(std::abs(dx), std::abs(dy)) * 5.0) + 1;
      for (int s = 0; s <= steps; ++s) {
        double t = static_cast<double>(s) / steps;
        int px = static_cast<int>(xj + t * dx);
        int py = static_cast<int>(yj + t * dy);
        if (px >= 0 && px < w && py >= 0 && py < h)
          mask[static_cast<size_t>(px) * h + py] = 1;
      }
    }
  }
  return rle_encode(mask.data(), h, w, counts, max_n);
}

}  // extern "C"
