// Attention forward (kernel K2) for Hopper in fp32, on the CUDA cores: out =
// softmax(Q K^T / sqrt(D) + bias) V per (batch, head), with a [B,1,1,L]
// additive key bias. bf16 goes to the tensor-core kernel beside K3 in
// attention_dropout_mma.cu; the wrapper chooses by dtype. fp32 stays here,
// off the tensor cores: TF32 would break the fp32 comparisons with the
// plain version.
//
// Replaces: vlbert_tpu/ops/attention.py, _fused_attention_fwd_impl (the
// Pallas kernel _attn_kernel behind fused_attention). That kernel pads L
// and D to 128 lanes and keeps one (b, h) pair's whole [L, L] score tile in
// VMEM; here nothing is padded in memory: the kernel reads q, k and v
// through their strides (views of the fused [B, L, 3*H*D] projection need
// no copy) and masks the ragged edge of L itself.
//
// Semantics kept from the reference: scores, softmax and P.V accumulate in
// fp32; masked keys carry the additive -10000 bias and are NOT skipped, so
// a query row whose keys are all masked still produces the same finite
// values as the plain version. Keys past L (the ragged tile edge) are the
// only ones excluded. D must be 64.
//
// What bounds it on the H100: instruction issue, not bytes or launch
// latency. Each score is a 64-long dot product in one lane with two
// shared-memory reads per multiply-add, and P.V broadcasts each probability
// by a shuffle, one key at a time. Built for bf16 as well, this design ran
// 0.123 ms at B=16, L=128 (13x PyTorch's cuDNN SDPA, 32x the 0.0038 ms
// bytes bound) and 0.0069 ms at the serve shape B=1, L=41 (chip_smoke.py on
// an H100 80GB HBM3 at 700 W). Only fp32 callers reach it now: the fp32
// end-to-end check and fp32 evaluation.
//
// Design (simple, no wgmma/TMA): one block of 8 warps per (b, h, tile of
// 8 query rows), one warp per query row. The block walks the keys in tiles
// of 32 held in shared memory (fp32, K rows padded to 65 floats so the 32
// lanes hit 32 banks). For the scores each lane owns one key of the tile and
// does the 64-long dot product; for P.V each lane owns two of the 64 output
// dims and the probabilities are broadcast by warp shuffles. Softmax is the
// online (running max / running sum) form, so L is unbounded and nothing of
// size [L, L] ever reaches device memory.

#include "common.cuh"

namespace {

constexpr int kD = 64;     // head dim
constexpr int kRows = 8;   // query rows per block (one warp each)
constexpr int kKeys = 32;  // keys per shared-memory tile (one per lane)

__global__ void __launch_bounds__(kRows * 32)
    attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ out,
                         int L, int H, long long qsb, long long qsl,
                         long long qsh, long long ksb, long long ksl,
                         long long ksh, long long vsb, long long vsl,
                         long long vsh, float scale) {
  __shared__ float ks[kKeys][kD + 1];
  __shared__ float vs[kKeys][kD];
  __shared__ float qs[kRows][kD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kRows + warp;
  const bool active = row < L;

  if (active) {
    const float* qrow = q + b * qsb + row * qsl + h * qsh;
    qs[warp][lane] = qrow[lane];
    qs[warp][lane + 32] = qrow[lane + 32];
  }
  const float* brow = bias + (long long)b * L;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  float m = -INFINITY, l = 0.0f, acc0 = 0.0f, acc1 = 0.0f;
  for (int t0 = 0; t0 < L; t0 += kKeys) {
    const int n = min(kKeys, L - t0);
    __syncthreads();  // the previous tile is consumed; q rows are written
    for (int i = threadIdx.x; i < kKeys * kD; i += blockDim.x) {
      const int j = i / kD, d = i % kD;
      float kv = 0.0f, vv = 0.0f;
      if (j < n) {
        kv = kb[(long long)(t0 + j) * ksl + d];
        vv = vb[(long long)(t0 + j) * vsl + d];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (active) {
      float s = -INFINITY;
      if (lane < n) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < kD; ++d) dot += qs[warp][d] * ks[lane][d];
        s = dot * scale + brow[t0 + lane];
      }
      const float m_new = fmaxf(m, warp_max(s));  // finite: lane 0 < n
      const float pj = lane < n ? expf(s - m_new) : 0.0f;
      const float corr = expf(m - m_new);          // 0 on the first tile
      l = l * corr + warp_sum(pj);
      acc0 *= corr;
      acc1 *= corr;
      for (int j = 0; j < n; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pj, j);
        acc0 += pb * vs[j][lane];
        acc1 += pb * vs[j][lane + 32];
      }
      m = m_new;
    }
  }
  if (active) {
    float* orow = out + (((long long)b * L + row) * H + h) * kD;
    orow[lane] = acc0 / l;
    orow[lane + 32] = acc1 / l;
  }
}

}  // namespace

extern "C" int attention_fwd_f32(const void* q, const void* k,
                                 const void* v, const void* bias, void* out,
                                 int B, int L, int H, int D, long long qsb,
                                 long long qsl, long long qsh, long long ksb,
                                 long long ksl, long long ksh, long long vsb,
                                 long long vsl, long long vsh, float scale,
                                 void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return (int)cudaSuccess;
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  attention_fwd_kernel<<<grid, kRows * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, L, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale);
  return (int)cudaGetLastError();
}
