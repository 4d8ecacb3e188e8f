// Attention with attention-prob dropout for Hopper: forward (kernel K3) and
// its recompute backward (kernel K4).
//
//   P   = softmax(Q K^T / sqrt(D) + bias)           (fp32, per (b, h))
//   Pd  = keep ? P * drop_scale : 0                 (fp32 scale)
//   out = Pd V
//
// Replaces: vlbert_tpu/ops/attention.py, _fad_fwd_impl (Pallas kernel
// _attn_drop_fwd_kernel) and _fad_bwd_impl (_attn_drop_bwd_kernel). The
// TPU kernels hold one (b, h) pair's whole [L, L] tile in VMEM and draw the
// mask from the TPU's hardware PRNG. Here the mask comes from Philox4x32-10
// keyed by the wrapper's 64-bit seed with counter (key, query, b*H + h, 1)
// (common.cuh), so the backward replays it from the seed; an explicit-bits
// mode ([B,H,L,L] uint16 zero-extended to int32, the JAX 'bits16' rule)
// serves parity tests. No [L, L] tile reaches device memory in either
// direction, and nothing but (q, k, v, bias, seed) is saved for backward.
//
// Semantics kept from the reference: scores, softmax and every
// accumulation in fp32; the -10000 additive masking is kept (masked keys
// are not skipped, so an all-masked row stays uniform); rate == 1 gives
// zeros (drop_scale 0).
//
// What bounds it on the H100: at the VQA training shape (B=16, H=12,
// L=128, D=64) a call reads under 10 MB and does ~0.2 GFLOP (forward) /
// ~0.6 GFLOP (backward) in fp32 CUDA cores, so it is bound by the serial
// per-row loop and fp32 issue rate, not by bandwidth; the tensor cores are
// not used yet (a later PR's work).
//
// Design (simple first):
//  * K3 forward: K2's kernel (one warp per query row, 32-key tiles of K and
//    V in shared memory, online softmax) with the keep mask applied to the
//    exponentials entering P V; the row sum l still counts every key, so
//    out = drop_scale * sum(keep * e * v) / l.
//  * K4 backward, two launches per call, both deterministic (no atomics,
//    fixed summation order), so a step is bit-reproducible:
//    - rows pass (one warp per query row): recomputes the row's m, l and
//      out as K3 does, rowsum = g . out (= sum_j dPd_j Pd_j), then a second
//      sweep over the keys gives ds_j = P_j (keep_j drop_scale g.v_j -
//      rowsum) and dq = scale * sum_j ds_j k_j. Writes dq and (m, l,
//      rowsum) per row.
//    - keys pass (one block per 32 keys of one (b, h); two threads per key,
//      each owning the even or odd half of the 64 dims in registers):
//      walks all query rows in order in chunks of 32 staged in shared
//      memory, recomputes P_j and ds_j from the row statistics, and
//      accumulates dv_j += Pd_j g_q, dk_j += ds_j q_q and the per-head
//      dbias_j += ds_j. The wrapper sums dbias over heads.

#include "common.cuh"

namespace {

constexpr int kD = 64;     // head dim
constexpr int kRows = 8;   // query rows per block in the row kernels
constexpr int kKeys = 32;  // keys per shared-memory tile

struct DropArgs {
  const int* bits;         // [B,H,L,L] int32 or nullptr (Philox)
  unsigned thresh;
  float drop_scale;
  unsigned long long seed;
};

__device__ __forceinline__ bool keep_at(const DropArgs& a, int bh, int L,
                                        int row, int key) {
  return dropout_keep(a.bits, ((long long)bh * L + row) * L + key, a.thresh,
                      (unsigned)key, (unsigned)row, (unsigned)bh, 1u,
                      a.seed);
}

template <typename T>
__device__ __forceinline__ void load_tile(float (*ks)[kD + 1],
                                          float (*vs)[kD + 1], const T* kb,
                                          const T* vb, long long ksl,
                                          long long vsl, int t0, int n) {
  for (int i = threadIdx.x; i < kKeys * kD; i += blockDim.x) {
    const int j = i / kD, d = i % kD;
    float kv = 0.0f, vv = 0.0f;
    if (j < n) {
      kv = to_f(kb[(long long)(t0 + j) * ksl + d]);
      vv = to_f(vb[(long long)(t0 + j) * vsl + d]);
    }
    ks[j][d] = kv;
    vs[j][d] = vv;
  }
}

// One query row's forward sweep (all lanes of a warp). Returns m and l and
// the lane's two dims of sum_j keep_j exp(s_j - m) v_j (unnormalized).
template <typename T>
__device__ void row_forward(float (*ks)[kD + 1], float (*vs)[kD + 1],
                            const float* qrow_s, const T* kb, const T* vb,
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
      const bool keep = lane < n && keep_at(da, bh, L, row, t0 + lane);
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

template <typename T>
__global__ void __launch_bounds__(kRows * 32)
    attn_drop_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias, T* __restrict__ out,
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
    const T* qrow = q + b * qsb + row * qsl + h * qsh;
    qs[warp][lane] = to_f(qrow[lane]);
    qs[warp][lane + 32] = to_f(qrow[lane + 32]);
  }
  float m, l, acc0, acc1;
  row_forward(ks, vs, qs[warp], k + b * ksb + h * ksh, v + b * vsb + h * vsh,
              ksl, vsl, bias + (long long)b * L, L, bh, row, active, scale,
              da, m, l, acc0, acc1);
  if (active) {
    T* orow = out + (((long long)b * L + row) * H + h) * kD;
    const float f = da.drop_scale / l;
    orow[lane] = from_f<T>(acc0 * f);
    orow[lane + 32] = from_f<T>(acc1 * f);
  }
}

// K4, rows pass: dq and the per-row statistics (m, l, rowsum).
template <typename T>
__global__ void __launch_bounds__(kRows * 32)
    attn_drop_bwd_rows_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ bias,
        const T* __restrict__ g, T* __restrict__ dq,
        float* __restrict__ stats, int L, int H, long long qsb,
        long long qsl, long long qsh, long long ksb, long long ksl,
        long long ksh, long long vsb, long long vsl, long long vsh,
        float scale, DropArgs da) {
  __shared__ float ks[kKeys][kD + 1];
  __shared__ float vs[kKeys][kD + 1];
  __shared__ float qs[kRows][kD];
  __shared__ float gs[kRows][kD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int row = blockIdx.x * kRows + warp;
  const bool active = row < L;
  float g0 = 0.0f, g1 = 0.0f;
  if (active) {
    const T* qrow = q + b * qsb + row * qsl + h * qsh;
    const T* grow = g + (((long long)b * L + row) * H + h) * kD;
    qs[warp][lane] = to_f(qrow[lane]);
    qs[warp][lane + 32] = to_f(qrow[lane + 32]);
    g0 = to_f(grow[lane]);
    g1 = to_f(grow[lane + 32]);
    gs[warp][lane] = g0;
    gs[warp][lane + 32] = g1;
  }
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  const float* brow = bias + (long long)b * L;
  float m, l, acc0, acc1;
  row_forward(ks, vs, qs[warp], kb, vb, ksl, vsl, brow, L, bh, row, active,
              scale, da, m, l, acc0, acc1);
  float rowsum = 0.0f;
  if (active) {
    const float f = da.drop_scale / l;
    rowsum = warp_sum(g0 * acc0 * f + g1 * acc1 * f);
  }
  float dq0 = 0.0f, dq1 = 0.0f;
  for (int t0 = 0; t0 < L; t0 += kKeys) {
    const int n = min(kKeys, L - t0);
    __syncthreads();
    load_tile(ks, vs, kb, vb, ksl, vsl, t0, n);
    __syncthreads();
    if (active) {
      float ds = 0.0f;
      if (lane < n) {
        float dot = 0.0f, dp = 0.0f;
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          dot += qs[warp][d] * ks[lane][d];
          dp += gs[warp][d] * vs[lane][d];
        }
        const float s = dot * scale + brow[t0 + lane];
        const float p = expf(s - m) / l;
        const bool keep = keep_at(da, bh, L, row, t0 + lane);
        const float dpm = keep ? dp * da.drop_scale : 0.0f;
        ds = p * (dpm - rowsum);
      }
      for (int j = 0; j < n; ++j) {
        const float db = __shfl_sync(0xffffffffu, ds, j);
        dq0 += db * ks[j][lane];
        dq1 += db * ks[j][lane + 32];
      }
    }
  }
  if (active) {
    T* drow = dq + (((long long)b * L + row) * H + h) * kD;
    drow[lane] = from_f<T>(dq0 * scale);
    drow[lane + 32] = from_f<T>(dq1 * scale);
    float* st = stats + ((long long)bh * L + row) * 3;
    if (lane == 0) {
      st[0] = m;
      st[1] = l;
      st[2] = rowsum;
    }
  }
}

constexpr int kChunk = 32;  // query rows staged per step in the keys pass

// K4, keys pass: dk, dv and the per-head dbias.
template <typename T>
__global__ void __launch_bounds__(2 * kKeys)
    attn_drop_bwd_keys_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ bias,
        const T* __restrict__ g, const float* __restrict__ stats,
        T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbias_h,
        int L, int H, long long qsb, long long qsl, long long qsh,
        long long ksb, long long ksl, long long ksh, long long vsb,
        long long vsl, long long vsh, float scale, DropArgs da) {
  __shared__ float qs[kChunk][kD];
  __shared__ float gs[kChunk][kD];
  __shared__ float st[kChunk][3];

  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int half = threadIdx.x & 1;  // owns dims 2*i + half
  const int key = blockIdx.x * kKeys + (threadIdx.x >> 1);
  const bool active = key < L;
  float kr[kD / 2], vr[kD / 2], dkr[kD / 2], dvr[kD / 2];
  const T* krow = k + b * ksb + (long long)(active ? key : 0) * ksl + h * ksh;
  const T* vrow = v + b * vsb + (long long)(active ? key : 0) * vsl + h * vsh;
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    kr[i] = active ? to_f(krow[2 * i + half]) : 0.0f;
    vr[i] = active ? to_f(vrow[2 * i + half]) : 0.0f;
    dkr[i] = dvr[i] = 0.0f;
  }
  const float bk = active ? bias[(long long)b * L + key] : 0.0f;
  float dba = 0.0f;

  for (int r0 = 0; r0 < L; r0 += kChunk) {
    const int n = min(kChunk, L - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kD; i += blockDim.x) {
      const int r = i / kD, d = i % kD;
      float qv = 0.0f, gv = 0.0f;
      if (r < n) {
        qv = to_f(q[b * qsb + (long long)(r0 + r) * qsl + h * qsh + d]);
        gv = to_f(g[(((long long)b * L + r0 + r) * H + h) * kD + d]);
      }
      qs[r][d] = qv;
      gs[r][d] = gv;
    }
    for (int i = threadIdx.x; i < kChunk * 3; i += blockDim.x)
      st[i / 3][i % 3] =
          i / 3 < n ? stats[((long long)bh * L + r0) * 3 + i] : 0.0f;
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      float dot = 0.0f, dp = 0.0f;
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) {
        dot += qs[r][2 * i + half] * kr[i];
        dp += gs[r][2 * i + half] * vr[i];
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      if (active) {
        const float s = dot * scale + bk;
        const float p = expf(s - st[r][0]) / st[r][1];
        const bool keep = keep_at(da, bh, L, r0 + r, key);
        const float pd = keep ? p * da.drop_scale : 0.0f;
        const float dpm = keep ? dp * da.drop_scale : 0.0f;
        const float ds = p * (dpm - st[r][2]);
        dba += ds;
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) {
          dvr[i] += pd * gs[r][2 * i + half];
          dkr[i] += ds * qs[r][2 * i + half];
        }
      }
    }
  }
  if (active) {
    const long long o = (((long long)b * L + key) * H + h) * kD;
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) {
      dk[o + 2 * i + half] = from_f<T>(dkr[i] * scale);
      dv[o + 2 * i + half] = from_f<T>(dvr[i]);
    }
    if (half == 0) dbias_h[(long long)bh * L + key] = dba;
  }
}

}  // namespace

extern "C" int attention_dropout_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int is_bf16, int B, int L, int H, int D, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, float scale,
    const void* bits, unsigned thresh, float drop_scale,
    unsigned long long seed, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return (int)cudaSuccess;
  const DropArgs da{(const int*)bits, thresh, drop_scale, seed};
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    attn_drop_fwd_kernel<__nv_bfloat16><<<grid, kRows * 32, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const float*)bias, (__nv_bfloat16*)out, L,
        H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale, da);
  else
    attn_drop_fwd_kernel<float><<<grid, kRows * 32, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)bias, (float*)out, L, H, qsb, qsl, qsh, ksb, ksl, ksh,
        vsb, vsl, vsh, scale, da);
  return (int)cudaGetLastError();
}

// g, dq, dk, dv: contiguous [B, L, H, D]; stats: [B*H*L*3] fp32 scratch;
// dbias_h: [B, H, L] fp32 (summed over H by the caller).
extern "C" int attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, void* dbias_h, void* stats,
    int is_bf16, int B, int L, int H, int D, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, float scale,
    const void* bits, unsigned thresh, float drop_scale,
    unsigned long long seed, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return (int)cudaSuccess;
  const DropArgs da{(const int*)bits, thresh, drop_scale, seed};
  const dim3 rows((L + kRows - 1) / kRows, H, B);
  const dim3 keys((L + kKeys - 1) / kKeys, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    using T = __nv_bfloat16;
    attn_drop_bwd_rows_kernel<T><<<rows, kRows * 32, 0, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dq, (float*)stats, L, H, qsb, qsl, qsh, ksb, ksl,
        ksh, vsb, vsl, vsh, scale, da);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    attn_drop_bwd_keys_kernel<T><<<keys, 2 * kKeys, 0, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (const float*)stats, (T*)dk, (T*)dv, (float*)dbias_h,
        L, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale, da);
  } else {
    using T = float;
    attn_drop_bwd_rows_kernel<T><<<rows, kRows * 32, 0, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dq, (float*)stats, L, H, qsb, qsl, qsh, ksb, ksl,
        ksh, vsb, vsl, vsh, scale, da);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    attn_drop_bwd_keys_kernel<T><<<keys, 2 * kKeys, 0, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (const float*)stats, (T*)dk, (T*)dv, (float*)dbias_h,
        L, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale, da);
  }
  return (int)cudaGetLastError();
}
