// ROIAlign's sampling rules and 16-byte channel moves, shared by the
// forward (K1, roi_align.cu) and the dF backward (K1b, roi_align_bwd.cu),
// so that both place every bilinear sample with the same arithmetic.
//
// The rules are those of the reference CUDA kernel as the plain version
// (ops/roi_align.py::_interp_weights) writes them: rois scaled by
// spatial_scale with no rounding and forced to at least 1x1, samples with
// y < -1 or y > size contribute 0, y clamped to 0 from below, y_low =
// y_high = size-1 at the top edge, an adaptive grid of min(ceil(roi/P),
// max_grid) samples a bin when sampling_ratio is 0. The sample coordinate
// is computed with unfused multiplies and adds, as the plain version does,
// so a sample that lands exactly on the map's edge is kept or dropped
// alike by the kernels and the plain version.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace roi {

constexpr int kMaxGrid = 8;  // == vlbert_tpu_torch.ops.roi_align.MAX_GRID

struct Tap {
  int lo, hi;
  float wlo, whi;
};

// One bilinear sample along one axis (ROIAlign_cuda.cu:15-62 rules).
__device__ __forceinline__ Tap make_tap(float y, int size, float contrib) {
  Tap t;
  if (y < -1.0f || y > (float)size) {
    t.lo = t.hi = 0;
    t.wlo = t.whi = 0.0f;
    return t;
  }
  const float yc = fmaxf(y, 0.0f);
  int lo = (int)floorf(yc);
  float l;
  if (lo >= size - 1) {
    lo = size - 1;
    t.hi = size - 1;
    l = 0.0f;
  } else {
    t.hi = lo + 1;
    l = yc - (float)lo;
  }
  t.lo = lo;
  t.wlo = contrib * (1.0f - l);
  t.whi = contrib * l;
  return t;
}

// One axis of one roi: its start and its extent (at least 1) in map units.
struct AxisRoi {
  float start, size;
};

// axis 0: rows (y), 1: columns (x); bx: the roi's (x1, y1, x2, y2)
__device__ __forceinline__ AxisRoi axis_roi(const float* bx, int axis,
                                            float scale) {
  // the plain version's arithmetic, unfused (no contraction to fma)
  const float a = __fmul_rn(bx[axis == 0 ? 1 : 0], scale);
  const float b = __fmul_rn(bx[axis == 0 ? 3 : 2], scale);
  return {a, fmaxf(__fsub_rn(b, a), 1.0f)};
}

// Samples a bin takes along one axis: kG when it is a compile-time
// constant, else sampling_ratio, else the adaptive grid.
template <int kG>
__device__ __forceinline__ int axis_grid(AxisRoi r, int pooled,
                                         int sampling_ratio, int max_grid) {
  if (kG > 0) return kG;
  if (sampling_ratio > 0) return sampling_ratio;
  return min((int)ceilf(__fdiv_rn(r.size, (float)pooled)), max_grid);
}

// Sample k of the n samples of bin `bin` along one axis of `size` pixels.
__device__ __forceinline__ Tap axis_tap(AxisRoi r, int pooled, int bin, int k,
                                        int n, int size) {
  const float bs = __fdiv_rn(r.size, (float)pooled);
  const float c = __fadd_rn(__fadd_rn(r.start, __fmul_rn((float)bin, bs)),
                            __fdiv_rn(__fmul_rn((float)k + 0.5f, bs),
                                      (float)n));
  return make_tap(c, size, __fdiv_rn(1.0f, (float)n));
}

// Whether a roi's samples along one axis may reach pixels lo..hi: a
// superset of the pixels its weights touch, for skipping rois early. Every
// sample lies in (start, start + size) up to rounding, and its taps are
// floor(max(y, 0)) and the pixel after, or size - 1 at the far edge; so a
// touched pixel x has start - 2 <= x <= start + size + 2 (a margin of one
// pixel over the taps for the rounding). Samples outside [-1, size]
// contribute 0 and are kept in the superset.
__device__ __forceinline__ bool may_touch(AxisRoi r, float lo, float hi) {
  return hi + 2.0f >= r.start && lo - 2.0f <= r.start + r.size;
}

// 16 bytes of elements of type T, widened to fp32 (V = 16 / sizeof(T))
template <typename T, int V>
__device__ __forceinline__ void widen(uint4 a, float (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(a.x), v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z), v[3] = __uint_as_float(a.w);
  } else if constexpr (std::is_same_v<T, __half>) {
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // fp16 -> fp32 is exact
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(&w[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // bf16 -> fp32 is exact: a 16-bit shift
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// V consecutive elements (16 bytes) widened to fp32
template <int V, typename T>
__device__ __forceinline__ void load_chunk(const T* p, float (&v)[V]) {
  widen<T>(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

// V fp32 values stored as V elements of the output's type (rounded to
// nearest even for bf16 and fp16, as torch's cast)
template <int V>
__device__ __forceinline__ void store_chunk(float* o, const float (&a)[V]) {
#pragma unroll
  for (int k = 0; k < V / 4; ++k)
    reinterpret_cast<float4*>(o)[k] =
        make_float4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3]);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int V>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* o,
                                            const float (&a)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(o) =
        make_uint4(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]),
                   pack_bf16(a[4], a[5]), pack_bf16(a[6], a[7]));
  } else {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]));
  }
}

__device__ __forceinline__ unsigned pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int V>
__device__ __forceinline__ void store_chunk(__half* o, const float (&a)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(o) =
        make_uint4(pack_f16(a[0], a[1]), pack_f16(a[2], a[3]),
                   pack_f16(a[4], a[5]), pack_f16(a[6], a[7]));
  } else {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack_f16(a[0], a[1]), pack_f16(a[2], a[3]));
  }
}

// The entry points' dispatch on dtype codes (common.cuh): fn(p) with p
// cast to the element type of `code` (fp32, bf16, fp16)
template <typename Fn>
int with_input(int code, const void* p, Fn fn) {
  switch (code) {
    case kF32: return fn((const float*)p);
    case kBF16: return fn((const __nv_bfloat16*)p);
    case kF16: return fn((const __half*)p);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fn(p) with the output p of an input of type Tin: fp32, or a 16-bit type
// other than Tin's other 16-bit twin (bf16 and fp16 do not mix)
template <typename Tin, typename Fn>
int with_output(int code, void* p, Fn fn) {
  if (code == kF32) return fn((float*)p);
  if (code == kBF16) {
    if constexpr (!std::is_same_v<Tin, __half>)
      return fn((__nv_bfloat16*)p);
  } else if (code == kF16) {
    if constexpr (!std::is_same_v<Tin, __nv_bfloat16>) return fn((__half*)p);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace roi
