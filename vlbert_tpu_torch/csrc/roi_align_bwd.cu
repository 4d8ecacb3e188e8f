// ROIAlign dF backward (kernel K1b) for Hopper: the gradient of the
// feature map, written deterministically.
//
// Replaces: vlbert_tpu/ops/roi_align.py, the dF half of _sep_bwd (the
// custom_vjp backward of _roi_align_separable, :186-194), two XLA einsums
// over the dense separable weights,
//
//   dF[b,h,w,c] = sum_{o,p,q} Ry[b,o,p,h] Cx[b,o,q,w] g[b,o,p,q,c],
//
// which is also what JAX's autodiff of roi_align(impl="xla") computes. The
// reference CUDA backward scatters every bin's samples into dF with
// atomicAdd, so its sums change order from run to run. Here every dF
// element is written by exactly one thread, which sums its contributions
// in a fixed order (roi, then bin row p, then bin column q): a repeat on the
// same inputs is bit for bit the same. dRy and dCx are not computed: boxes
// come from data and carry no gradient. Padded slots (box_mask == 0)
// contribute nothing and cost one shared-memory read. The samples are
// placed by the forward's own rules (roi_align.cuh), so sampling_ratio 1
// (the main path, a compile-time instance), 0 (adaptive) and 2-8 agree with
// K1 and with the plain version. g is read in fp32 or bf16, sums are fp32,
// dF is stored in the features' dtype (fp32, or bf16 rounded to nearest
// even as torch's cast).
//
// What bounds it on the H100: every live slot's g read once and dF
// written once. At VCR's training shape (g [4,108,14,14,1024] bf16 with
// every slot live, dF [4,38,75,1024] bf16) that is 173 MB + 23 MB, 0.059
// ms at 3.35 TB/s; the fp32 operations (two a sample and channel) are far
// below the card's rate. At sampling ratio 1 each g element feeds the four
// map pixels around its sample, which lie in two neighbouring map rows,
// so it is read twice from L2 or HBM and twice more from L1.
//
// Design: a gather per map pixel. A block takes TW consecutive pixels of
// one map row h (TW = 256 / (C / V), V = 16 bytes of g's channels: TW = 2
// at C = 1024 bf16), and the image's rois in passes of kOC. For each pass
// it first evaluates, in shared memory, every roi's row weight Ry[o,p,h]
// for its row and column weights Cx[o,q,w] for its pixels (one thread per
// weight, each summing its bin's samples), then the nonzero range of p and
// of q per roi (the bins that touch a pixel are consecutive). Then each
// thread owns one 16-byte chunk of one pixel's channels and sums, roi by
// roi, Ry[o,p,h] * (sum_q Cx[o,q,w] g[o,p,q,chunk]) over those ranges, in
// registers; the last pass ends with one 16-byte (fp32 dF from fp32 g) or
// 8/16-byte store. Pixels no roi covers are stored as zeros.

#include <algorithm>
#include <cstdint>

#include "roi_align.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAlign = 16;      // bytes per vector load of g
constexpr int kOC = 32;         // rois a pass takes
constexpr int kMaxTW = 8;       // map pixels a block takes at most
constexpr int kMaxPooled = 16;  // P, Q
constexpr int kItems = 2;       // (pixel, chunk) items a thread owns at most

template <typename Tg, typename Tout, int kG>
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_kernel(const Tg* __restrict__ g,
                         const float* __restrict__ boxes,
                         const uint8_t* __restrict__ box_mask,
                         Tout* __restrict__ dfeat, int H, int W, int C,
                         int O, int P, int Q, float scale, int sampling_ratio,
                         int max_grid, int tw, int n_wt) {
  constexpr int V = kAlign / sizeof(Tg);  // channels a thread moves
  __shared__ float wy[kOC][kMaxPooled];
  __shared__ float wx[kMaxTW][kOC][kMaxPooled];
  __shared__ int prange[kOC];            // lo | hi << 8; -1: no bin
  __shared__ int qrange[kMaxTW][kOC];

  const int wt = blockIdx.x % n_wt;
  const int bh = blockIdx.x / n_wt;
  const int h = bh % H, b = bh / H;
  const int w0 = wt * tw;
  const int chunks = C / V;
  const int items = tw * chunks;

  float acc[kItems][V];
#pragma unroll
  for (int it = 0; it < kItems; ++it)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[it][e] = 0.0f;

  for (int o0 = 0; o0 < O; o0 += kOC) {
    const int oc = min(kOC, O - o0);
    // 1. the pass's weights: Ry[o,p,h] of the block's row ...
    for (int i = threadIdx.x; i < oc * P; i += kThreads) {
      const int ol = i / P, p = i % P;
      const long long bo = (long long)b * O + o0 + ol;
      float w = 0.0f;
      if (box_mask[bo]) {
        const roi::AxisRoi r = roi::axis_roi(boxes + bo * 4, 0, scale);
        const int n = roi::axis_grid<kG>(r, P, sampling_ratio, max_grid);
        for (int k = 0; k < n; ++k) {
          const roi::Tap t = roi::axis_tap(r, P, p, k, n, H);
          if (t.lo == h) w += t.wlo;
          if (t.hi == h) w += t.whi;
        }
      }
      wy[ol][p] = w;
    }
    // ... and Cx[o,q,w] of each of its pixels
    for (int i = threadIdx.x; i < tw * oc * Q; i += kThreads) {
      const int j = i / (oc * Q), r0 = i % (oc * Q);
      const int ol = r0 / Q, q = r0 % Q, x = w0 + j;
      const long long bo = (long long)b * O + o0 + ol;
      float w = 0.0f;
      if (x < W && box_mask[bo]) {
        const roi::AxisRoi r = roi::axis_roi(boxes + bo * 4, 1, scale);
        const int n = roi::axis_grid<kG>(r, Q, sampling_ratio, max_grid);
        for (int k = 0; k < n; ++k) {
          const roi::Tap t = roi::axis_tap(r, Q, q, k, n, W);
          if (t.lo == x) w += t.wlo;
          if (t.hi == x) w += t.whi;
        }
      }
      wx[j][ol][q] = w;
    }
    __syncthreads();
    // 2. the nonzero range of bins per roi (rows), and per pixel and roi
    // (columns)
    for (int i = threadIdx.x; i < oc * (1 + tw); i += kThreads) {
      const float* row;
      int n, *dst;
      if (i < oc) {
        row = wy[i], n = P, dst = &prange[i];
      } else {
        const int j = (i - oc) / oc, ol = (i - oc) % oc;
        row = wx[j][ol], n = Q, dst = &qrange[j][ol];
      }
      int lo = -1, hi = -1;
      for (int k = 0; k < n; ++k)
        if (row[k] != 0.0f) {
          if (lo < 0) lo = k;
          hi = k;
        }
      *dst = lo < 0 ? -1 : lo | (hi << 8);
    }
    __syncthreads();
    // 3. each thread's chunks: sum the pass's rois in a fixed order
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i >= items) break;
      const int j = i / chunks, c0 = (i - j * chunks) * V;
      if (w0 + j >= W) break;
      for (int ol = 0; ol < oc; ++ol) {
        const int pr = prange[ol], qr = qrange[j][ol];
        if (pr < 0 || qr < 0) continue;
        const Tg* go = g + ((long long)b * O + o0 + ol) * P * Q * C + c0;
        for (int p = pr & 0xff; p <= (pr >> 8); ++p) {
          const float a = wy[ol][p];
          if (a == 0.0f) continue;
          float row[V];
#pragma unroll
          for (int e = 0; e < V; ++e) row[e] = 0.0f;
          for (int q = qr & 0xff; q <= (qr >> 8); ++q) {
            const float c = wx[j][ol][q];
            if (c == 0.0f) continue;
            float v[V];
            roi::load_chunk<V>(go + ((long long)p * Q + q) * C, v);
#pragma unroll
            for (int e = 0; e < V; ++e) row[e] += c * v[e];
          }
#pragma unroll
          for (int e = 0; e < V; ++e) acc[it][e] += a * row[e];
        }
      }
    }
    __syncthreads();  // the next pass overwrites the weights
  }

#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i >= items) break;
    const int j = i / chunks, c0 = (i - j * chunks) * V;
    if (w0 + j >= W) break;
    roi::store_chunk<V>(
        dfeat + (((long long)b * H + h) * W + w0 + j) * C + c0, acc[it]);
  }
}

template <typename Tg, typename Tout>
int launch(const Tg* g, const float* boxes, const uint8_t* mask, Tout* dfeat,
           int B, int H, int W, int C, int O, int P, int Q, float scale,
           int sampling_ratio, int max_grid, cudaStream_t s) {
  constexpr int V = kAlign / sizeof(Tg);
  // a thread stores V outputs: 16 bytes, or 8 (fp32 g, bf16 dF)
  const size_t out_align = std::min<size_t>(kAlign, V * sizeof(Tout));
  const int chunks = C / V;
  const int tw = std::max(1, std::min(kMaxTW, kThreads / std::max(chunks, 1)));
  if (C % V != 0 || P > kMaxPooled || Q > kMaxPooled || P < 1 || Q < 1 ||
      tw * chunks > kItems * kThreads || (uintptr_t)g % kAlign != 0 ||
      (uintptr_t)dfeat % out_align != 0)
    return (int)cudaErrorInvalidValue;
  const int n_wt = (W + tw - 1) / tw;
  const long long blocks = (long long)B * H * n_wt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (sampling_ratio == 1)
    roi_align_bwd_kernel<Tg, Tout, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, boxes, mask, dfeat, H, W, C, O, P, Q, scale, sampling_ratio,
        max_grid, tw, n_wt);
  else
    roi_align_bwd_kernel<Tg, Tout, 0><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, boxes, mask, dfeat, H, W, C, O, P, Q, scale, sampling_ratio,
        max_grid, tw, n_wt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int roi_align_bwd(const void* g, int g_is_bf16, const void* boxes,
                             const void* box_mask, void* dfeat,
                             int dfeat_is_bf16, int B, int H, int W, int C,
                             int O, int P, int Q, float spatial_scale,
                             int sampling_ratio, int max_grid, void* stream) {
  // sampling_ratio <= 0 is the adaptive grid, as in the forward
  if (max_grid > roi::kMaxGrid || sampling_ratio > roi::kMaxGrid)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const float* bx = (const float*)boxes;
  const uint8_t* m = (const uint8_t*)box_mask;
  if (g_is_bf16) {
    const __nv_bfloat16* gp = (const __nv_bfloat16*)g;
    if (dfeat_is_bf16)
      return launch(gp, bx, m, (__nv_bfloat16*)dfeat, B, H, W, C, O, P, Q,
                    spatial_scale, sampling_ratio, max_grid, s);
    return launch(gp, bx, m, (float*)dfeat, B, H, W, C, O, P, Q,
                  spatial_scale, sampling_ratio, max_grid, s);
  }
  const float* gp = (const float*)g;
  if (dfeat_is_bf16)
    return launch(gp, bx, m, (__nv_bfloat16*)dfeat, B, H, W, C, O, P, Q,
                  spatial_scale, sampling_ratio, max_grid, s);
  return launch(gp, bx, m, (float*)dfeat, B, H, W, C, O, P, Q, spatial_scale,
                sampling_ratio, max_grid, s);
}
