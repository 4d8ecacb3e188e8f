// ROIAlign forward (kernel K1) for Hopper.
//
// Replaces: vlbert_tpu/ops/roi_align.py, _roi_align_pallas_fwd (the Pallas
// kernel behind roi_align(impl="pallas")). That kernel contracts dense
// separable weight matrices [P,H] x [H,W*C] on the TPU's matrix unit; here
// each output bin is evaluated directly from its bilinear taps, with the
// reference CUDA rules of _interp_weights: unrounded spatial_scale, rois of
// at least 1x1, samples with y < -1 or y > H contribute 0, clamp to 0 from
// below, y_low = y_high = H-1 at the top edge, adaptive grid
// min(ceil(roi/P), max_grid) when sampling_ratio == 0. Padded roi slots
// (box_mask == 0) are written as zeros. Accumulation is fp32; the output is
// fp32 [B,O,P,Q,C].
//
// What bounds it on the H100: memory traffic, not arithmetic. At the serve
// shape (body4 38x63x1024, 16 rois, 14x14 bins, sampling ratio 1) every
// output value costs 4 taps (8 flops) and 4 bytes of fp32 output, while the
// feature map (4.9 MB in bf16) stays resident in the 50 MB L2. The fp32
// output write and the tap reads are the cost; launch latency dominates at
// this size.
//
// Design: one block per (image, roi, output row p). Thread 0..n of the
// block first compute that row's y taps and all Q*gw x taps once into
// shared memory; then the threads walk the channels, so neighbouring
// threads read neighbouring channels of the NHWC map (coalesced) and write
// neighbouring channels of the output. bf16 maps are read as bf16 and
// widened in registers: no fp32 copy of the map is made. No [P,W,C]
// intermediate reaches device memory (the plain separable version writes
// one of 57 MB at the serve shape).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxPooled = 32;  // P, Q <= 32 (checked by the wrapper)
constexpr int kMaxGrid = 8;     // == vlbert_tpu_torch.ops.roi_align.MAX_GRID

struct Tap {
  int lo, hi;
  float wlo, whi;
};

// One bilinear sample along one axis (ROIAlign_cuda.cu:15-62 rules).
__device__ Tap make_tap(float y, int size, float contrib) {
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

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ boxes,
                                     const uint8_t* __restrict__ box_mask,
                                     float* __restrict__ out, int H, int W,
                                     int C, int O, int P, int Q, float scale,
                                     int sampling_ratio, int max_grid) {
  const int p = blockIdx.x, o = blockIdx.y, b = blockIdx.z;
  const long long bo = (long long)b * O + o;
  float* __restrict__ out_row = out + (bo * P + p) * (long long)Q * C;
  if (!box_mask[bo]) {
    for (int i = threadIdx.x; i < Q * C; i += blockDim.x) out_row[i] = 0.0f;
    return;
  }

  __shared__ Tap ytap[kMaxGrid];
  __shared__ Tap xtap[kMaxPooled * kMaxGrid];

  const float* bx = boxes + bo * 4;
  const float x1 = bx[0] * scale, y1 = bx[1] * scale;
  const float x2 = bx[2] * scale, y2 = bx[3] * scale;
  const float roi_w = fmaxf(x2 - x1, 1.0f), roi_h = fmaxf(y2 - y1, 1.0f);
  const float bin_h = roi_h / (float)P, bin_w = roi_w / (float)Q;
  int gh, gw;
  if (sampling_ratio > 0) {
    gh = gw = sampling_ratio;
  } else {
    gh = min((int)ceilf(roi_h / (float)P), max_grid);
    gw = min((int)ceilf(roi_w / (float)Q), max_grid);
  }
  for (int i = threadIdx.x; i < gh; i += blockDim.x) {
    const float y = y1 + p * bin_h + (i + 0.5f) * bin_h / (float)gh;
    ytap[i] = make_tap(y, H, 1.0f / (float)gh);
  }
  for (int i = threadIdx.x; i < Q * gw; i += blockDim.x) {
    const int q = i / gw, ix = i % gw;
    const float x = x1 + q * bin_w + (ix + 0.5f) * bin_w / (float)gw;
    xtap[i] = make_tap(x, W, 1.0f / (float)gw);
  }
  __syncthreads();

  const T* __restrict__ fb = feat + (long long)b * H * W * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int q = 0; q < Q; ++q) {
      float acc = 0.0f;
      for (int iy = 0; iy < gh; ++iy) {
        const Tap ty = ytap[iy];
        const T* rlo = fb + (long long)ty.lo * W * C + c;
        const T* rhi = fb + (long long)ty.hi * W * C + c;
        for (int ix = 0; ix < gw; ++ix) {
          const Tap tx = xtap[q * gw + ix];
          const float lo = tx.wlo * to_f(rlo[(long long)tx.lo * C]) +
                           tx.whi * to_f(rlo[(long long)tx.hi * C]);
          const float hi = tx.wlo * to_f(rhi[(long long)tx.lo * C]) +
                           tx.whi * to_f(rhi[(long long)tx.hi * C]);
          acc += ty.wlo * lo + ty.whi * hi;
        }
      }
      out_row[(long long)q * C + c] = acc;
    }
  }
}

}  // namespace

extern "C" int roi_align_fwd(const void* feat, int feat_is_bf16,
                             const void* boxes, const void* box_mask,
                             void* out, int B, int H, int W, int C, int O,
                             int P, int Q, float spatial_scale,
                             int sampling_ratio, int max_grid, void* stream) {
  if (P > kMaxPooled || Q > kMaxPooled || max_grid > kMaxGrid ||
      sampling_ratio > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || O == 0) return (int)cudaSuccess;
  const dim3 grid(P, O, B);
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (feat_is_bf16)
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (const __nv_bfloat16*)feat, (const float*)boxes,
        (const uint8_t*)box_mask, (float*)out, H, W, C, O, P, Q,
        spatial_scale, sampling_ratio, max_grid);
  else
    roi_align_fwd_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)feat, (const float*)boxes, (const uint8_t*)box_mask,
        (float*)out, H, W, C, O, P, Q, spatial_scale, sampling_ratio,
        max_grid);
  return (int)cudaGetLastError();
}
