// ROIAlign forward (kernel K1) for Hopper, with the cast to the compute
// dtype done in its store.
//
// Replaces: vlbert_tpu/ops/roi_align.py, _roi_align_pallas_fwd (the Pallas
// kernel behind roi_align(impl="pallas")), followed by the caller's cast to
// the compute dtype (vlbert_tpu/models/fast_rcnn.py: fp32 kernel output,
// then astype(self.dtype)). The Pallas kernel contracts dense separable
// weight matrices [P,H] x [H,W*C] on the TPU's matrix unit; here each
// output bin is evaluated directly from its bilinear taps, with the
// reference CUDA rules of _interp_weights: unrounded spatial_scale, rois of
// at least 1x1, samples with y < -1 or y > H contribute 0, clamp to 0 from
// below, y_low = y_high = H-1 at the top edge, adaptive grid
// min(ceil(roi/P), max_grid) when sampling_ratio == 0. Sample coordinates
// are computed with unfused multiplies and adds, as the plain version does,
// so a sample that lands exactly on the map's edge is kept or dropped alike.
// Padded roi slots (box_mask == 0) are written as zeros. Accumulation is
// fp32; the output is fp32 or bf16 [B,O,P,Q,C] (rounded to nearest even,
// as torch's cast).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; measured with
// tools/bench_k1_torch.py --probes, numbers in PERF.md section 6). At the
// serve shape (body4 38x63x1024 bf16, 16 slots of which 14 live, 14x14
// bins, sampling ratio 1) a call must move 4.9 MB of map and 6.4 MB of
// bf16 output: 3.4 us at 3.35 TB/s; it takes 6.0 us warm. The taps'
// gathers are not the limit, though they pull 22.5 MB from L2 (4 x 2 KB a
// live output pixel): with one-pixel boxes, whose gathers hit L1, a call
// takes the same 6.0 us. Nor is the map's read from HBM: the map stays in
// L2 from the backbone's last conv (with L2 flushed first it takes 7.9
// us). The floor is the output's stores and the launch: a call whose
// slots are all padded, so that it only stores zeros, takes 3.7 us (and
// 9.2 us for fp32 out), a call with one padded slot 1.8 us. The live
// taps add about 2.3 us: each block's chain of dependent steps (mask and
// box loads, taps, barrier, tap loads, store) over two waves of blocks.
// Giving each thread 2 or 4 chunks, so that their loads are in flight
// together and the grid is one wave, did not shorten it (6.3 and 6.2 us);
// nor did every thread computing its pixel's taps in its own registers,
// with no shared memory and no barrier (7.0 us: each thread then does the
// divisions of the tap arithmetic itself). The old design (one block per
// pixel row, scalar 2-byte loads, fp32 out only) took 26-28 us.
//
// Design: a work item is one output pixel (b, o, p, q) across all C
// channels. Each thread moves one 16-byte chunk of channels (8 bf16 or 4
// fp32): per tap one 16-byte load through the read-only path, neighbouring
// threads on neighbouring chunks of one NHWC pixel (coalesced), and one
// 16-byte (or, for fp32 out from bf16 in, two) store of the output in the
// output's type. A block of 256 threads takes 256 / (C / chunk) pixels
// (2 at C = 1024 bf16; at most kMaxPix), so the grid has one block per few
// pixels (1568 at the serve shape), not one heavy block per pixel row. The
// block first computes its pixels' taps (row, column, two weights per axis
// and sample) once into shared memory, one thread per tap; then every
// thread reuses them across its channels. sampling_ratio == 1 (the main
// path) is a compile-time instance with exactly 4 taps a pixel and no grid
// loops; 0 (adaptive, up to 8x8 samples a bin) and 2-8 share a general
// instance. Padded slots take no tap arithmetic, only zero stores. The
// sampling rules and the 16-byte moves live in roi_align.cuh, shared with
// the dF backward (K1b, roi_align_bwd.cu).

#include <algorithm>
#include <cstdint>

#include "roi_align.cuh"

namespace {

using roi::kMaxGrid;
using roi::Tap;

constexpr int kThreads = 256;
constexpr int kAlign = 16;   // bytes per vector load
constexpr int kMaxPix = 32;  // pixels a block takes at most (small C)

// The taps of one output pixel; kG samples per axis (0: up to kMaxGrid,
// counted in gh, gw).
template <int kG>
struct PixelTaps {
  static constexpr int G = kG > 0 ? kG : kMaxGrid;
  Tap y[G], x[G];
  long long image;  // offset of the pixel's image in the map
  int gh, gw, live;
};

template <typename Tin, typename Tout, int kG>
__global__ void __launch_bounds__(kThreads)
    roi_align_fwd_kernel(const Tin* __restrict__ feat,
                         const float* __restrict__ boxes,
                         const uint8_t* __restrict__ box_mask,
                         Tout* __restrict__ out, int H, int W, int C, int O,
                         int P, int Q, float scale, int sampling_ratio,
                         int max_grid, long long npix, int ppb) {
  constexpr int V = kAlign / sizeof(Tin);  // channels a thread moves
  constexpr int G = PixelTaps<kG>::G;
  __shared__ PixelTaps<kG> px[kMaxPix];
  const long long pix0 = (long long)blockIdx.x * ppb;
  const int chunks = C / V;

  // the block's taps, one thread per (pixel, axis, sample)
  for (int i = threadIdx.x; i < ppb * 2 * G; i += kThreads) {
    const int j = i / (2 * G), r = i % (2 * G), axis = r / G, k = r % G;
    const long long pix = pix0 + j;
    if (pix >= npix) continue;
    const int q = (int)(pix % Q);
    const long long t = pix / Q;
    const int p = (int)(t % P);
    const long long bo = t / P;
    PixelTaps<kG>& s = px[j];
    const bool live = box_mask[bo] != 0;
    if (r == 0) {
      s.live = live;
      s.image = bo / O * H * W * (long long)C;
    }
    if (!live) continue;
    const roi::AxisRoi ar = roi::axis_roi(boxes + bo * 4, axis, scale);
    const int pooled = axis == 0 ? P : Q;
    const int n = roi::axis_grid<kG>(ar, pooled, sampling_ratio, max_grid);
    if (k == 0) *(axis == 0 ? &s.gh : &s.gw) = n;
    if (k >= n) continue;
    Tap* taps = axis == 0 ? s.y : s.x;
    taps[k] = roi::axis_tap(ar, pooled, axis == 0 ? p : q, k, n,
                            axis == 0 ? H : W);
  }
  __syncthreads();

  // one 16-byte chunk of one pixel's channels a thread
  for (int i = threadIdx.x; i < ppb * chunks; i += kThreads) {
    const int j = i / chunks;
    const long long pix = pix0 + j;
    if (pix >= npix) break;
    const int c0 = (i - j * chunks) * V;
    const PixelTaps<kG>& s = px[j];
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    if (s.live) {
      const Tin* f = feat + s.image + c0;
      // compile-time 1 x 1 for the main path: the loops unroll away
      const int gh = kG > 0 ? kG : s.gh, gw = kG > 0 ? kG : s.gw;
      for (int iy = 0; iy < gh; ++iy) {
        const Tap ty = s.y[iy];
        const Tin* rlo = f + (long long)ty.lo * W * C;
        const Tin* rhi = f + (long long)ty.hi * W * C;
        for (int ix = 0; ix < gw; ++ix) {
          const Tap tx = s.x[ix];
          float a[V], b[V], c[V], d[V];
          roi::load_chunk<V>(rlo + (long long)tx.lo * C, a);
          roi::load_chunk<V>(rlo + (long long)tx.hi * C, b);
          roi::load_chunk<V>(rhi + (long long)tx.lo * C, c);
          roi::load_chunk<V>(rhi + (long long)tx.hi * C, d);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float lo = tx.wlo * a[e] + tx.whi * b[e];
            const float hi = tx.wlo * c[e] + tx.whi * d[e];
            acc[e] += ty.wlo * lo + ty.whi * hi;
          }
        }
      }
    }
    roi::store_chunk<V>(out + pix * C + c0, acc);
  }
}

template <typename Tin, typename Tout>
int launch(const Tin* feat, const float* boxes, const uint8_t* mask,
           Tout* out, int B, int H, int W, int C, int O, int P, int Q,
           float scale, int sampling_ratio, int max_grid, cudaStream_t s) {
  constexpr int V = kAlign / sizeof(Tin);
  // a thread stores V outputs: 16 bytes, or 8 (fp32 map, bf16 out)
  const size_t out_align = std::min<size_t>(kAlign, V * sizeof(Tout));
  if (C % V != 0 || (uintptr_t)feat % kAlign != 0 ||
      (uintptr_t)out % out_align != 0)
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * O * P * Q;
  const int chunks = C / V;
  const int ppb = std::max(1, std::min(kMaxPix, kThreads / chunks));
  const long long blocks = (npix + ppb - 1) / ppb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (sampling_ratio == 1)
    roi_align_fwd_kernel<Tin, Tout, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        feat, boxes, mask, out, H, W, C, O, P, Q, scale, sampling_ratio,
        max_grid, npix, ppb);
  else
    roi_align_fwd_kernel<Tin, Tout, 0><<<(unsigned)blocks, kThreads, 0, s>>>(
        feat, boxes, mask, out, H, W, C, O, P, Q, scale, sampling_ratio,
        max_grid, npix, ppb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int roi_align_fwd(const void* feat, int feat_is_bf16,
                             const void* boxes, const void* box_mask,
                             void* out, int out_is_bf16, int B, int H, int W,
                             int C, int O, int P, int Q, float spatial_scale,
                             int sampling_ratio, int max_grid, void* stream) {
  // sampling_ratio <= 0 is the adaptive grid, as in the reference
  if (max_grid > kMaxGrid || sampling_ratio > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || O == 0 || P == 0 || Q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const float* bx = (const float*)boxes;
  const uint8_t* m = (const uint8_t*)box_mask;
  if (feat_is_bf16) {
    const __nv_bfloat16* f = (const __nv_bfloat16*)feat;
    if (out_is_bf16)
      return launch(f, bx, m, (__nv_bfloat16*)out, B, H, W, C, O, P, Q,
                    spatial_scale, sampling_ratio, max_grid, s);
    return launch(f, bx, m, (float*)out, B, H, W, C, O, P, Q, spatial_scale,
                  sampling_ratio, max_grid, s);
  }
  const float* f = (const float*)feat;
  if (out_is_bf16)
    return launch(f, bx, m, (__nv_bfloat16*)out, B, H, W, C, O, P, Q,
                  spatial_scale, sampling_ratio, max_grid, s);
  return launch(f, bx, m, (float*)out, B, H, W, C, O, P, Q, spatial_scale,
                sampling_ratio, max_grid, s);
}
