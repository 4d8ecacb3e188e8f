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
// in a fixed order (roi ascending, then bin row p, then sum_q inside): a
// repeat on the same inputs is bit for bit the same. dRy and dCx are not
// computed: boxes come from data and carry no gradient. Padded slots
// (box_mask == 0) contribute nothing. The samples are placed by the
// forward's own rules (roi_align.cuh), so sampling_ratio 1 (the main path,
// a compile-time instance), 0 (adaptive) and 2-8 agree with K1 and with
// the plain version. g is read in fp32, bf16 or fp16, sums are fp32, dF is
// stored in the features' dtype (fp32, or bf16 or fp16 rounded to nearest
// even as torch's cast).
//
// What bounds it on the H100: every live slot's g read once and dF
// written once. At VCR's training shape (g [4,108,14,14,1024] bf16 with
// every slot live, dF [4,38,75,1024] bf16) that is 173 MB + 23 MB, 0.059
// ms at 3.35 TB/s; the fp32 operations (two a sample and channel) are far
// below the card's rate. At sampling ratio 1 each g element feeds the four
// map pixels around its sample, so the gather reads it four times (twice
// from L2, twice more from L1). In practice neither bytes nor operations
// bound it but chains of dependent sums: a roi under one map pixel (forced
// to 1x1) puts all its P x Q bins on the same 4 pixels, so one pixel's
// sum runs through 196 bins of that roi in order, each a load from L2 and
// then its FMAs. The time goes to the longest such chains (on the card,
// the same call with an eighth of the channels took two thirds of the
// time). Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.072 ms at
// VCR's training shape with 197 of 432 slots live (bound 0.031), 0.132
// with all live (0.059), 0.040 at RefCOCO+'s with 40 of 432 (0.011).
//
// Design: a gather per map pixel over the rois that touch it.
//  * A block takes a tile of one map row h: 8 warps, each 64 16-byte
//    chunks of one pixel's channels (2 a lane, the lanes side by side: a
//    512-byte load a warp and chunk); a pixel of more chunks takes several
//    warps, so the tile is 4 pixels at C = 1024 bf16 g, 2 for fp32 g. Two
//    blocks a SM (at most 128 registers a thread): one block's set-up
//    runs beside the other's gather.
//  * The block first compacts, in roi order (a ballot and a prefix sum over
//    the warps), the image's live slots whose samples may reach row h and
//    the tile's columns (roi::may_touch, from the box alone), keeping their
//    rows' and columns' extents. Only those rois get weights: Ry[o,p,h]
//    for the row and Cx[o,q,w] for the tile's pixels, each bin's samples
//    evaluated once and their taps added in sample order; then the nonzero
//    range of p per roi and of q per roi and pixel (the bins that touch a
//    pixel are consecutive). In the tile's work these are shared-memory
//    broadcasts: every lane of a warp follows the same rois, bins and
//    weights.
//  * Each lane sums, roi by roi, Ry[o,p,h] * (sum_q Cx[o,q,w] g[o,p,q,c])
//    in registers for its 2 chunks. The loads of a bin row's q come out
//    kQB at a time before their FMAs, so a chain takes one L2 round trip
//    for each kQB bins, not for each bin: 2 for a row of 14. The weights
//    and the order of every sum are those of the kernel this design
//    replaced (a block of 2 pixels that evaluated every slot's weights
//    itself), so dF is the same bit for bit.
//  * Pixels no roi covers are stored as zeros.

#include <algorithm>
#include <cstdint>

#include "roi_align.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;             // blocks a SM holds
constexpr int kAlign = 16;                // bytes per vector load of g
constexpr int kItems = 2;                 // a lane's chunks of its pixel
constexpr int kWarpChunks = 32 * kItems;  // a warp's chunks of its pixel
constexpr int kQB = 7;                    // bins whose loads go out together:
                                          // a row of 14 in two rounds
constexpr int kOC = 32;                   // rois a pass takes
constexpr int kMaxPooled = 16;            // P, Q
constexpr int kWS = kMaxPooled + 1;       // a roi's weights' stride: the
                                          // range scan's rois on distinct banks
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  int list[kThreads];      // the window's slots that may touch the tile
  float4 axes[kThreads];   // their rows' and columns' (start, size)
  int warp_hits[kWarps];
  float wy[kOC][kWS];            // Ry[o,p,h]
  float wx[kWarps][kOC][kWS];    // Cx[o,q,w] by pixel of the tile
  int prange[kOC];               // lo | hi << 8; -1: no bin
  int qrange[kWarps][kOC];
};

template <typename Tg, typename Tout, int kG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    roi_align_bwd_kernel(const Tg* __restrict__ g,
                         const float* __restrict__ boxes,
                         const uint8_t* __restrict__ box_mask,
                         Tout* __restrict__ dfeat, int H, int W, int C,
                         int O, int P, int Q, float scale, int sampling_ratio,
                         int max_grid, int tw, int groups, int n_wt) {
  constexpr int V = kAlign / sizeof(Tg);  // channels a chunk holds
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wt = blockIdx.x % n_wt;
  const int bh = blockIdx.x / n_wt;
  const int h = bh % H, b = bh / H;
  const int w0 = wt * tw, tn = min(tw, W - w0);  // the tile's pixels
  // this warp's pixel j of the tile and its group of chunks
  const int j = warp / groups, cg = warp % groups;
  const bool active = j < tn;
  const int chunks = C / V;
  int coff[kItems];  // the lane's channel offsets; -1: none
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int c = cg * kWarpChunks + i * 32 + lane;
    coff[i] = active && c < chunks ? c * V : -1;
  }

  float acc[kItems][V];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.0f;

  for (int o0 = 0; o0 < O; o0 += kThreads) {
    // 1. the window's live slots that may touch row h and the tile, in
    // slot order, with their rois' extents
    const int o = o0 + threadIdx.x;
    bool hit = false;
    roi::AxisRoi ry{0.0f, 0.0f}, rx{0.0f, 0.0f};
    if (o < O && box_mask[(long long)b * O + o]) {
      const float* bx = boxes + ((long long)b * O + o) * 4;
      ry = roi::axis_roi(bx, 0, scale);
      rx = roi::axis_roi(bx, 1, scale);
      hit = roi::may_touch(ry, (float)h, (float)h) &&
            roi::may_touch(rx, (float)w0, (float)(w0 + tn - 1));
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == 0) s.warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s.warp_hits[w];
      base += w < warp ? c : 0;
      n += c;
    }
    if (hit) {
      const int k = base + __popc(ballot & ((1u << lane) - 1));
      s.list[k] = o;
      s.axes[k] = make_float4(ry.start, ry.size, rx.start, rx.size);
    }
    __syncthreads();

    for (int s0 = 0; s0 < n; s0 += kOC) {
      const int oc = min(kOC, n - s0);
      // 2. the pass's weights: Ry[o,p,h] of the block's row, and Cx[o,q,w]
      // of the tile's pixels, one thread a (roi, bin) adding its samples'
      // taps in order into the pixels they fall on
      for (int i = threadIdx.x; i < oc * (P + Q); i += kThreads) {
        if (i < oc * P) {
          const int ol = i / P, p = i % P;
          const float4 ax = s.axes[s0 + ol];
          const roi::AxisRoi r{ax.x, ax.y};
          const int ns = roi::axis_grid<kG>(r, P, sampling_ratio, max_grid);
          float w = 0.0f;
          for (int k = 0; k < ns; ++k) {
            const roi::Tap t = roi::axis_tap(r, P, p, k, ns, H);
            if (t.lo == h) w += t.wlo;
            if (t.hi == h) w += t.whi;
          }
          s.wy[ol][p] = w;
        } else {
          const int ol = (i - oc * P) / Q, q = (i - oc * P) % Q;
          const float4 ax = s.axes[s0 + ol];
          const roi::AxisRoi r{ax.z, ax.w};
          const int ns = roi::axis_grid<kG>(r, Q, sampling_ratio, max_grid);
          for (int x = 0; x < tn; ++x) s.wx[x][ol][q] = 0.0f;
          for (int k = 0; k < ns; ++k) {
            const roi::Tap t = roi::axis_tap(r, Q, q, k, ns, W);
            const int xl = t.lo - w0, xh = t.hi - w0;
            if (0 <= xl && xl < tn) s.wx[xl][ol][q] += t.wlo;
            if (0 <= xh && xh < tn) s.wx[xh][ol][q] += t.whi;
          }
        }
      }
      __syncthreads();
      // 3. the nonzero range of bins per roi (rows), and per pixel and roi
      // (columns)
      for (int i = threadIdx.x; i < oc * (1 + tn); i += kThreads) {
        const float* row;
        int nb, *dst;
        if (i < oc) {
          row = s.wy[i], nb = P, dst = &s.prange[i];
        } else {
          const int x = (i - oc) / oc, ol = (i - oc) % oc;
          row = s.wx[x][ol], nb = Q, dst = &s.qrange[x][ol];
        }
        int lo = -1, hi = -1;
        for (int k = 0; k < nb; ++k)
          if (row[k] != 0.0f) {
            if (lo < 0) lo = k;
            hi = k;
          }
        *dst = lo < 0 ? -1 : lo | (hi << 8);
      }
      __syncthreads();
      // 4. the warp's pixel: sum the pass's rois in a fixed order, the
      // loads of kQB bins of a bin row out together
      if (active) {
        for (int ol = 0; ol < oc; ++ol) {
          const int pr = s.prange[ol], qr = s.qrange[j][ol];
          if (pr < 0 || qr < 0) continue;
          const Tg* go = g + ((long long)b * O + s.list[s0 + ol]) * P * Q * C;
          const float* cx = s.wx[j][ol];
          const int q1 = qr >> 8;
          for (int p = pr & 0xff; p <= (pr >> 8); ++p) {
            const float a = s.wy[ol][p];
            if (a == 0.0f) continue;
            float row[kItems][V];
#pragma unroll
            for (int i = 0; i < kItems; ++i)
#pragma unroll
              for (int e = 0; e < V; ++e) row[i][e] = 0.0f;
            for (int q0 = qr & 0xff; q0 <= q1; q0 += kQB) {
              float c[kQB];
              uint4 r[kQB][kItems];
#pragma unroll
              for (int u = 0; u < kQB; ++u) {
                c[u] = q0 + u <= q1 ? cx[q0 + u] : 0.0f;
                const Tg* gq = go + ((long long)p * Q + q0 + u) * C;
#pragma unroll
                for (int i = 0; i < kItems; ++i)
                  r[u][i] = c[u] != 0.0f && coff[i] >= 0
                                ? __ldg(reinterpret_cast<const uint4*>(
                                      gq + coff[i]))
                                : make_uint4(0u, 0u, 0u, 0u);
              }
#pragma unroll
              for (int u = 0; u < kQB; ++u) {
                if (c[u] == 0.0f) continue;
#pragma unroll
                for (int i = 0; i < kItems; ++i) {
                  float v[V];
                  roi::widen<Tg>(r[u][i], v);
#pragma unroll
                  for (int e = 0; e < V; ++e)
                    row[i][e] = fmaf(c[u], v[e], row[i][e]);
                }
              }
            }
#pragma unroll
            for (int i = 0; i < kItems; ++i)
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[i][e] = fmaf(a, row[i][e], acc[i][e]);
          }
        }
      }
      __syncthreads();  // the next pass overwrites the weights
    }
    __syncthreads();  // the next window overwrites the list and counts
  }

  if (!active) return;
  Tout* out = dfeat + (((long long)b * H + h) * W + w0 + j) * C;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (coff[i] >= 0) roi::store_chunk<V>(out + coff[i], acc[i]);
}

template <typename Tg, typename Tout>
int launch(const Tg* g, const float* boxes, const uint8_t* mask, Tout* dfeat,
           int B, int H, int W, int C, int O, int P, int Q, float scale,
           int sampling_ratio, int max_grid, cudaStream_t s) {
  constexpr int V = kAlign / sizeof(Tg);
  // a thread stores V outputs: 16 bytes, or 8 (fp32 g, 16-bit dF)
  const size_t out_align = std::min<size_t>(kAlign, V * sizeof(Tout));
  const int chunks = C / V;
  // warps a pixel takes, and the tile's pixels
  const int groups = std::max(1, (chunks + kWarpChunks - 1) / kWarpChunks);
  if (C % V != 0 || P > kMaxPooled || Q > kMaxPooled || P < 1 || Q < 1 ||
      groups > kWarps || (uintptr_t)g % kAlign != 0 ||
      (uintptr_t)dfeat % out_align != 0)
    return (int)cudaErrorInvalidValue;
  const int tw = kWarps / groups;
  const int n_wt = (W + tw - 1) / tw;
  const long long blocks = (long long)B * H * n_wt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // above 48 KB a block's shared memory must be asked for, per kernel
  auto kernel = sampling_ratio == 1 ? roi_align_bwd_kernel<Tg, Tout, 1>
                                    : roi_align_bwd_kernel<Tg, Tout, 0>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, sizeof(Smem), s>>>(
      g, boxes, mask, dfeat, H, W, C, O, P, Q, scale, sampling_ratio,
      max_grid, tw, groups, n_wt);
  return (int)cudaGetLastError();
}

}  // namespace

// g_dtype, dfeat_dtype: DtypeCodes (common.cuh), as roi_align_fwd's
extern "C" int roi_align_bwd(const void* g, int g_dtype, const void* boxes,
                             const void* box_mask, void* dfeat,
                             int dfeat_dtype, int B, int H, int W, int C,
                             int O, int P, int Q, float spatial_scale,
                             int sampling_ratio, int max_grid, void* stream) {
  // sampling_ratio <= 0 is the adaptive grid, as in the forward
  if (max_grid > roi::kMaxGrid || sampling_ratio > roi::kMaxGrid)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const float* bx = (const float*)boxes;
  const uint8_t* m = (const uint8_t*)box_mask;
  return roi::with_input(g_dtype, g, [&](auto gp) {
    using Tg = std::remove_cv_t<std::remove_pointer_t<decltype(gp)>>;
    return roi::with_output<Tg>(dfeat_dtype, dfeat, [&](auto o) {
      return launch(gp, bx, m, o, B, H, W, C, O, P, Q, spatial_scale,
                    sampling_ratio, max_grid, s);
    });
  });
}
