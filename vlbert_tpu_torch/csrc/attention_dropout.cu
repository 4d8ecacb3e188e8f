// Attention with attention-prob dropout for Hopper, fp32 inputs: the
// forward (kernel K3) on the CUDA cores. The bf16 K3 is on the tensor
// cores in attention_dropout_mma.cu, and K3's fp32 backward (K4) on the
// tensor cores in attention_f32_mma.cu, by a three-product TF32 split that
// keeps fp32 accuracy; the wrapper chooses by dtype. This kernel has not
// been moved to the tensor cores yet: the same split would serve it (one
// pass of TF32 alone would miss the fp32 tolerances, three do not).
//
//   P   = softmax(Q K^T / sqrt(D) + bias)           (fp32, per (b, h))
//   Pd  = keep ? P * drop_scale : 0                 (fp32 scale)
//   out = Pd V
//
// Replaces: vlbert_tpu/ops/attention.py, _fad_fwd_impl (Pallas kernel
// _attn_drop_fwd_kernel), on its fp32 route. The TPU kernel holds one
// (b, h) pair's whole [L, L] tile in VMEM and draws the mask from the
// TPU's hardware PRNG. Here the mask comes from Philox4x32-10 keyed by the
// wrapper's 64-bit seed at a counter shared by four neighbouring keys
// (attention_dropout.cuh), so the backward replays it from the seed;
// an explicit-bits mode ([B,H,L,L] uint16 zero-extended to int32, the JAX
// 'bits16' rule) serves parity tests. No [L, L] tile reaches device
// memory, and nothing but (q, k, v, bias, seed) is saved for backward.
//
// Semantics kept from the reference: scores, softmax and every
// accumulation in fp32; the -10000 additive masking is kept (masked keys
// are not skipped, so an all-masked row stays uniform); rate == 1 gives
// zeros (drop_scale 0).
//
// What bounds it on the H100: the serial per-row loops and the fp32 issue
// rate, not bandwidth (a call reads under 20 MB). Each element evaluates
// Philox once, for the word of its own key.
//
// Design (simple first): one warp per query row, 32-key tiles of K and V
// in shared memory, online softmax, the keep mask applied to the
// exponentials entering P V; the row sum l still counts every key, so
// out = drop_scale * sum(keep * e * v) / l.

#include "attention_dropout.cuh"

namespace {

constexpr int kD = 64;     // head dim
constexpr int kRows = 8;   // query rows per block
constexpr int kKeys = 32;  // keys per shared-memory tile

__device__ __forceinline__ void load_tile(float (*ks)[kD + 1],
                                          float (*vs)[kD + 1],
                                          const float* kb, const float* vb,
                                          long long ksl, long long vsl,
                                          int t0, int n) {
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
}

// One query row's forward sweep (all lanes of a warp). Returns m and l and
// the lane's two dims of sum_j keep_j exp(s_j - m) v_j (unnormalized).
__device__ void row_forward(float (*ks)[kD + 1], float (*vs)[kD + 1],
                            const float* qrow_s, const float* kb,
                            const float* vb,
                            long long ksl, long long vsl, const float* brow,
                            int L, int bh, int row, bool active, float scale,
                            const DropArgs& da, float& m, float& l,
                            float& acc0, float& acc1) {
  const int lane = threadIdx.x & 31;
  m = -INFINITY;
  l = 0.0f;
  acc0 = acc1 = 0.0f;
  for (int t0 = 0; t0 < L; t0 += kKeys) {
    const int n = min(kKeys, L - t0);
    __syncthreads();  // the previous tile is consumed
    load_tile(ks, vs, kb, vb, ksl, vsl, t0, n);
    __syncthreads();
    if (active) {
      float s = -INFINITY;
      if (lane < n) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < kD; ++d) dot += qrow_s[d] * ks[lane][d];
        s = dot * scale + brow[t0 + lane];
      }
      const float m_new = fmaxf(m, warp_max(s));  // finite: lane 0 < n
      const float pj = lane < n ? expf(s - m_new) : 0.0f;
      const float corr = expf(m - m_new);          // 0 on the first tile
      l = l * corr + warp_sum(pj);
      const bool keep = lane < n && attention_keep(da, bh, L, row, t0 + lane);
      const float pk = keep ? pj : 0.0f;
      acc0 *= corr;
      acc1 *= corr;
      for (int j = 0; j < n; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pk, j);
        acc0 += pb * vs[j][lane];
        acc1 += pb * vs[j][lane + 32];
      }
      m = m_new;
    }
  }
}

__global__ void __launch_bounds__(kRows * 32)
    attn_drop_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ out,
                         int L, int H, long long qsb, long long qsl,
                         long long qsh, long long ksb, long long ksl,
                         long long ksh, long long vsb, long long vsl,
                         long long vsh, float scale, DropArgs da) {
  __shared__ float ks[kKeys][kD + 1];
  __shared__ float vs[kKeys][kD + 1];
  __shared__ float qs[kRows][kD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int row = blockIdx.x * kRows + warp;
  const bool active = row < L;
  if (active) {
    const float* qrow = q + b * qsb + row * qsl + h * qsh;
    qs[warp][lane] = qrow[lane];
    qs[warp][lane + 32] = qrow[lane + 32];
  }
  float m, l, acc0, acc1;
  row_forward(ks, vs, qs[warp], k + b * ksb + h * ksh, v + b * vsb + h * vsh,
              ksl, vsl, bias + (long long)b * L, L, bh, row, active, scale,
              da, m, l, acc0, acc1);
  if (active) {
    float* orow = out + (((long long)b * L + row) * H + h) * kD;
    const float f = da.drop_scale / l;
    orow[lane] = acc0 * f;
    orow[lane + 32] = acc1 * f;
  }
}

}  // namespace

extern "C" int attention_dropout_fwd_f32(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int L, int H, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, float scale, const void* bits,
    unsigned thresh, float drop_scale, unsigned long long seed,
    void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return (int)cudaSuccess;
  const DropArgs da{(const int*)bits, thresh, drop_scale, seed};
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  attn_drop_fwd_kernel<<<grid, kRows * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, L, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale,
      da);
  return (int)cudaGetLastError();
}
