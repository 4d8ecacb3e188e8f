// Attention on Hopper's tensor cores, bf16 and fp16: the forward without
// dropout (kernel K2), and with attention-prob dropout the forward (kernel
// K3) and its deterministic recompute backward (kernel K4). One source for
// both 16-bit types: the element type T is a template parameter, and the
// fp16 MMA (m16n8k16 .f16) has the bf16 one's fragment layout, so only the
// instruction, the packs and the stores differ; the masks, tiles and
// sweeps are the same code.
//
//   P   = softmax(Q K^T / sqrt(D) + bias)           (fp32, per (b, h))
//   Pd  = keep ? P * drop_scale : 0                 (fp32 scale; K2: Pd = P)
//   out = Pd V
//
// Replaces: vlbert_tpu/ops/attention.py, _fused_attention_fwd_impl (Pallas
// kernel _attn_kernel), _fad_fwd_impl (_attn_drop_fwd_kernel) and
// _fad_bwd_impl (_attn_drop_bwd_kernel). The fp32 routes are
// attention_f32_mma.cu's: K2, K3 and K4 on the tensor cores by a
// three-product TF32 split; the wrappers choose by dtype. K2 is K3's kernel with the mask compiled out:
// one body, a compile-time kDrop, so K3's code is the same with or without
// K2.
//
// Semantics, the same as the fp32 kernels': scores, softmax, row sums and
// every accumulator in fp32; the -10000 additive bias is kept (masked keys
// are not skipped, so an all-masked row stays uniform over the L real
// keys); keys >= L are excluded outright (score -inf), not padded with
// -10000; rate == 1 gives zeros (drop_scale 0). The operands of the
// products are bf16: q, k, v and g as given, P * keep rounded to bf16 for
// P V (the rounding of p.astype(q.dtype) in the JAX package's XLA path),
// dS and Pd rounded to bf16 for dQ, dK and dV (in fp16 all of it
// likewise in fp16: fp16 holds 3 more bits of mantissa and a narrower
// range, 65504, which an fp16 caller's values stay within; the
// accumulators and the statistics stay fp32). K2 rounds P to bf16 for P V
// too, one MMA per product: the TPU kernel multiplies fp32 P by fp32 V, but
// the rounding moves the output by at most 2^-9 of max |v| (about 8e-3 at
// |v| <= 4), under chip_smoke.py's bf16 tolerance of 2e-2 and the same as
// K3's; a bf16 high and low split of P (two MMAs) would buy digits the
// bf16 output then rounds away. The mask is
// attention_dropout.cuh's: one Philox4x32-10 evaluation feeds four
// neighbouring keys, or explicit bits for parity tests.
//
// What bounds it on the H100: at the VQA training shape (B=16, H=12,
// L=128, D=64, bf16) the forward moves 12.6 MB (3.8 us at 3.35 TB/s) and
// does 0.8 GFLOP (0.8 us on the tensor cores); K2, the same work without
// the mask, also serves one query at B=1, L=41, where its 12 blocks (one a
// head, a quarter of each idle) are all latency. The backward moves 22.1 MB
// (6.6 us) and does 2.0 GFLOP (2.0 us). Both are bytes-bound on paper;
// what holds them above that is latency: each (b, h) has only two 64-row
// tiles, so a block runs two short steps of its pipeline. Philox costs
// about 50 integer instructions an evaluation (chip_smoke.py counts them
// from the SASS); at a quarter of an evaluation per element per pass the
// forward's floor is about 2.4 us, the backward's (three passes) 7 us.
//
// Design:
//  * Tiles of 64 rows x 64 dims in shared memory, row stride 72 bf16 (144
//    bytes: 16-byte aligned for cp.async, and the 8 rows an ldmatrix reads
//    fall on 8 distinct groups of 4 banks). Tiles are filled by 16-byte
//    cp.async copies straight from the strided q, k, v views (the fused
//    QKV projection's row stride is 2304 elements, so every row is 16-byte
//    aligned; the entry points check) and double-buffered: tile j + 1 is in
//    flight while tile j is computed. Rows >= L are zero-filled.
//  * Products with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), operands
//    by ldmatrix (.trans where the tile's rows are the reduction). Each of
//    the 4 warps of a block owns 16 rows, as an online-softmax flash kernel.
//    Grids are (L / 64, H, B): 384 blocks of 128 threads at the VQA shape,
//    one wave at three blocks per SM (the backward kernels are held to 168
//    registers for it).
//  * K3 and K2: one block per (64 query rows, h, b). The Q tile goes into
//    registers once; each key tile gives S = Q K^T, scale and bias, the
//    running max and row sum (all keys, kept or not), then P * keep in bf16
//    times V into the fp32 accumulator. out = drop_scale * acc / l (K2:
//    no keep, drop_scale 1).
//  * K4, two launches, deterministic (no atomics, every sum in a fixed
//    order), so a training step is bit-reproducible:
//    - rows pass, one block per 64 query rows: a forward sweep as K3's
//      gives m, l and the fp32 out, so D = g . out per row (= sum_j dPd_j
//      Pd_j); a second sweep gives dP = g V^T, dS = P (keep drop_scale dP -
//      D) and dQ += dS K. Writes dq and the row statistics (m in the log2
//      domain, l, D) to a [B, H, L, 3] fp32 scratch.
//    - keys pass, one block per 64 keys: each warp holds its 16 keys' K and
//      V in registers and walks the query tiles in order, 32 rows at a
//      time: S^T = K Q^T and dP^T = V g^T, P from the row statistics, then
//      dV += Pd^T g, dK += dS^T Q and the per-head dbias row sums. The
//      wrapper sums dbias over heads.
//    Nothing is saved between forward and backward but (q, k, v, bias,
//    seed or bits): the row statistics need D, and D needs g, so the rows
//    pass recomputes them rather than K3 storing them.
//  * The mask in registers, one Philox evaluation per four elements of a
//    C fragment: keep_rows_q where rows are queries (K3, rows pass),
//    keep_rows_k where rows are keys (keys pass). They, the cp.async
//    helpers and the quad reductions are attention_dropout.cuh's, shared
//    with the fp32 kernels.

#include <cstdint>
#include <type_traits>

#include "attention_dropout.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kD = 64;          // head dim
constexpr int kT = 64;          // rows per tile: query rows, keys
constexpr int kS = kD + 8;      // shared-memory row stride, 16-bit elements
constexpr int kThreads = 128;   // 4 warps x 16 rows
// the backward kernels' blocks per SM: at most 168 registers a thread, so
// the 384 blocks of the VQA training shape run in one wave on 132 SMs
// (unbounded, ptxas takes ~240 and two blocks fit)
constexpr int kBwdBlocksPerSM = 3;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
using Tile = T[kT][kS];

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, T) b (16 x 8, T)
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  if constexpr (std::is_same_v<T, bf16>)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to a T pair (nearest even), as one 32-bit word
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, bf16>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(unsigned u) {
  if constexpr (std::is_same_v<T, bf16>) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
    return make_float2(__low2float(v), __high2float(v));
  } else {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
}

// stores two fp32 values as a T pair at o
template <typename T>
__device__ __forceinline__ void store2(T* o, float lo, float hi) {
  if constexpr (std::is_same_v<T, bf16>)
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(lo, hi);
  else
    *reinterpret_cast<__half2*>(o) = __floats2half2_rn(lo, hi);
}

// ---------------------------------------------------------------- tiles

// Rows r0 .. r0 + 63 of one (b, h) slice (base, row stride sl elements)
// into a tile, 16 bytes per copy; rows >= L are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(Tile<T>& s, const T* base,
                                          long long sl, int r0, int L) {
#pragma unroll
  for (int it = 0; it < kT * kD / 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = r0 + r < L;
    cp_async16(&s[r][c], base + (ok ? (long long)(r0 + r) * sl : 0) + c, ok);
  }
}

// A fragments of a warp's 16 tile rows from row0, over the 64 dims: a[ks]
// covers dims 16 ks .. 16 ks + 15.
template <typename T>
__device__ __forceinline__ void load_a(unsigned (&a)[4][4], const Tile<T>& s,
                                       int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(a[ks], &s[row0 + (lane & 15)][16 * ks + 8 * (lane >> 4)]);
}

// c[n] = A B^T for n-tile n (n < NT): A is 16 rows x 64 dims in fragments,
// B the tile's rows row0 + 8 n .. row0 + 8 n + 7 (64 dims each). S = Q K^T
// and its kin.
template <int NT, typename T>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4],
                                        const unsigned (&a)[4][4],
                                        const Tile<T>& s, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldsm_x4(b, &s[row0 + 16 * np + (lane & 7) + 8 * (lane >> 4)]
                   [16 * ks + 8 * ((lane >> 3) & 1)]);
      mma16<T>(c[2 * np], a[ks], b[0], b[1]);
      mma16<T>(c[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// acc (16 rows x 64 dims, C layout) += P T: P is 16 rows x 16 KS columns
// in C layout (2 KS n-tiles, rounded to T here), the tile's rows
// row0 .. row0 + 16 KS - 1.
template <int KS, typename T>
__device__ __forceinline__ void mma_pt(float (&acc)[8][4],
                                       const float (&p)[2 * KS][4],
                                       const Tile<T>& s, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const unsigned a[4] = {pack2<T>(p[2 * kk][0], p[2 * kk][1]),
                           pack2<T>(p[2 * kk][2], p[2 * kk][3]),
                           pack2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      unsigned b[4];
      ldsm_x4_t(b, &s[row0 + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)]
                     [16 * dp + 8 * (lane >> 4)]);
      mma16<T>(acc[2 * dp], a, b[0], b[1]);
      mma16<T>(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------- sweeps

// Key tiles double-buffered: K, V and the tile's bias (times log2 e, -inf
// past L).
template <typename T>
struct KV {
  Tile<T> k[2], v[2];
  float bias[2][kT];
};

template <typename T>
struct Slice {  // one (b, h): k and v rows and the batch row's bias
  const T* k;
  const T* v;
  long long ksl, vsl;
  const float* bias;
};

template <typename T>
__device__ __forceinline__ void load_kv(KV<T>& s, int j, const Slice<T>& sl,
                                        int L) {
  const int buf = j & 1, k0 = j * kT;
  load_tile(s.k[buf], sl.k, sl.ksl, k0, L);
  load_tile(s.v[buf], sl.v, sl.vsl, k0, L);
  if (threadIdx.x < kT) {
    const int key = k0 + threadIdx.x;
    s.bias[buf][threadIdx.x] = key < L ? sl.bias[key] * kLog2e : -INFINITY;
  }
}

// Tile j of nt: issue tile j + 1's copies into the other buffer (free
// since the barrier that ended tile j - 1), then wait for tile j's.
template <typename T>
__device__ __forceinline__ void next_kv(KV<T>& s, int j, int nt,
                                        const Slice<T>& sl, int L) {
  if (j + 1 < nt) {
    load_kv(s, j + 1, sl, L);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

// One warp's 16 query rows (qa = its lane's first row) against every key:
// m, the running max in the log2 domain; l, this lane's share of the row
// sum (the quad sums it); acc = sum_j keep_j 2^(x_j - m) v_j in C layout,
// unnormalized (kDrop false: every keep_j is 1 and da is not read). Tile
// 0's copies must have been issued and committed.
template <bool kDrop, typename T>
__device__ __forceinline__ void forward_sweep(
    KV<T>& s, const unsigned (&qf)[4][4], const Slice<T>& sl, int L, int mh,
    int qa, float scale_log2, const DropArgs& da, float (&m)[2],
    float (&l)[2], float (&acc)[8][4]) {
  const int t = threadIdx.x & 3, nt = (L + kT - 1) / kT;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (int j = 0; j < nt; ++j) {
    next_kv(s, j, nt, sl, L);
    const int buf = j & 1;
    float sc[8][4];
    mma_abt<8>(sc, qf, s.k[buf], 0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            sc[n][e] * scale_log2 + s.bias[buf][8 * n + 2 * t + (e & 1)];
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);      // finite: tile j holds key j * 64 < L
      corr[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const unsigned keep =
          kDrop ? keep_rows_q(da, mh, L, qa, j * kT + 8 * n + 2 * t) : 0xfu;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[n][e] = (keep >> e) & 1 ? p : 0.0f;
      }
    }
    mma_pt<4>(acc, sc, s.v[buf], 0);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- kernels

template <typename T>
__device__ __forceinline__ Slice<T> slice_of(const T* k, const T* v,
                                             const float* bias,
                                             const Strides& st, int b, int h,
                                             int L) {
  return Slice<T>{k + b * st.ksb + h * st.ksh, v + b * st.vsb + h * st.vsh,
                  st.ksl, st.vsl, bias + (long long)b * L};
}

// K3 (kDrop) and K2 (no mask; da.drop_scale 1): one block per (64 query
// rows, h, b); kSplit: the launch holds part of the layer's heads.
template <bool kDrop, typename T, bool kSplit = false>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, int L, int H, Strides st, float scale,
                 DropArgs da) {
  __shared__ __align__(16) Tile<T> qs;
  __shared__ __align__(16) KV<T> kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kT;
  const Slice<T> sl = slice_of(k, v, bias, st, b, h, L);
  load_tile(qs, q + b * st.qsb + h * st.qsh, st.qsl, q0, L);
  load_kv(kv, 0, sl, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[4][4];
  load_a(qf, qs, 16 * warp);
  const int qa = q0 + 16 * warp + (lane >> 2);
  float m[2], l[2], acc[8][4];
  forward_sweep<kDrop>(kv, qf, sl, L, mask_head<kSplit>(da, b, H, h), qa,
                       scale * kLog2e, da, m, l, acc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float f = da.drop_scale / quad_sum(l[r]);
    const int row = qa + 8 * r;
    if (row >= L) continue;
    T* o = out + (((long long)b * L + row) * H + h) * kD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store2(o + 8 * n, acc[n][2 * r] * f, acc[n][2 * r + 1] * f);
  }
}

// K4, rows pass: one block per (64 query rows, h, b); dq and the row
// statistics (m in the log2 domain, l, D).
template <typename T, bool kSplit>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
    attn_drop_bwd_rows_mma(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ bias,
                           const T* __restrict__ g, T* __restrict__ dq,
                           float* __restrict__ stats, int L, int H,
                           Strides st, float scale, DropArgs da) {
  __shared__ __align__(16) Tile<T> qg;  // the Q tile, then the g tile
  __shared__ __align__(16) KV<T> kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int mh = mask_head<kSplit>(da, b, H, h);
  const int q0 = blockIdx.x * kT;
  const Slice<T> sl = slice_of(k, v, bias, st, b, h, L);
  const long long gsl = (long long)H * kD;  // g is contiguous [B, L, H, D]
  load_tile(qg, q + b * st.qsb + h * st.qsh, st.qsl, q0, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[4][4], gf[4][4];
  load_a(qf, qg, 16 * warp);
  __syncthreads();
  load_tile(qg, g + ((long long)b * L * H + h) * kD, gsl, q0, L);
  load_kv(kv, 0, sl, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a(gf, qg, 16 * warp);

  const int qa = q0 + 16 * warp + (lane >> 2);
  const float scale_log2 = scale * kLog2e;
  float m[2], l[2], acc[8][4];
  forward_sweep<true>(kv, qf, sl, L, mh, qa, scale_log2, da, m, l, acc);
  // D = g . out, from g's A fragments: they hold the C layout's elements
  // (n-tile n is word 2 (n % 2) + r of k-step n / 2)
  float inv_l[2], dd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv_l[r] = 1.0f / l[r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 gv = unpack2<T>(gf[n >> 1][2 * (n & 1) + r]);
      dd[r] += gv.x * acc[n][2 * r] + gv.y * acc[n][2 * r + 1];
    }
    dd[r] = quad_sum(dd[r]) * da.drop_scale * inv_l[r];
  }

  float dqa[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.0f;
  const int nt = (L + kT - 1) / kT;
  load_kv(kv, 0, sl, L);  // the forward sweep's last barrier freed both
  cp_async_commit();
  for (int j = 0; j < nt; ++j) {
    next_kv(kv, j, nt, sl, L);
    const int buf = j & 1;
    float sc[8][4], dp[8][4];
    mma_abt<8>(sc, qf, kv.k[buf], 0);
    mma_abt<8>(dp, gf, kv.v[buf], 0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const unsigned keep =
          keep_rows_q(da, mh, L, qa, j * kT + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x =
            sc[n][e] * scale_log2 + kv.bias[buf][8 * n + 2 * t + (e & 1)];
        const float p = exp2f(x - m[r]) * inv_l[r];
        const float dpm = (keep >> e) & 1 ? dp[n][e] * da.drop_scale : 0.0f;
        sc[n][e] = p * (dpm - dd[r]);
      }
    }
    mma_pt<4>(dqa, sc, kv.k[buf], 0);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    if (row >= L) continue;
    T* o = dq + (((long long)b * L + row) * H + h) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store2(o + 8 * n, dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
    if (t == 0) {
      float* s = stats + ((long long)mh * L + row) * 3;
      s[0] = m[r];
      s[1] = l[r];
      s[2] = dd[r];
    }
  }
}

// Query tiles double-buffered for the keys pass: Q, g and each row's
// statistics (m, 1 / l, D; zeros past L).
template <typename T>
struct QG {
  Tile<T> q[2], g[2];
  float4 st[2][kT];
};

// K4, keys pass: one block per (64 keys, h, b); dk, dv and the per-head
// dbias.
template <typename T, bool kSplit>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
    attn_drop_bwd_keys_mma(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ bias,
                           const T* __restrict__ g,
                           const float* __restrict__ stats,
                           T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ dbias_h, int L, int H,
                           Strides st, float scale, DropArgs da) {
  __shared__ __align__(16) QG<T> s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int mh = mask_head<kSplit>(da, b, H, h);
  const int k0 = blockIdx.x * kT;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* gb = g + ((long long)b * L * H + h) * kD;
  const long long gsl = (long long)H * kD;
  const float* sbh = stats + (long long)mh * L * 3;

  auto load_qg = [&](int j) {
    const int buf = j & 1, r0 = j * kT;
    load_tile(s.q[buf], qb, st.qsl, r0, L);
    load_tile(s.g[buf], gb, gsl, r0, L);
    if (threadIdx.x < kT) {
      const int row = r0 + threadIdx.x;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < L)
        x = make_float4(sbh[3 * row], 1.0f / sbh[3 * row + 1],
                        sbh[3 * row + 2], 0.0f);
      s.st[buf][threadIdx.x] = x;
    }
  };

  // this block's K and V rows go through buffer 1, query tile 0 into 0
  load_tile(s.q[1], k + b * st.ksb + h * st.ksh, st.ksl, k0, L);
  load_tile(s.g[1], v + b * st.vsb + h * st.vsh, st.vsl, k0, L);
  load_qg(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned kf[4][4], vf[4][4];
  load_a(kf, s.q[1], 16 * warp);
  load_a(vf, s.g[1], 16 * warp);
  __syncthreads();

  const int ka = k0 + 16 * warp + (lane >> 2);
  const float* brow = bias + (long long)b * L;
  const float bk[2] = {ka < L ? brow[ka] * kLog2e : -INFINITY,
                       ka + 8 < L ? brow[ka + 8] * kLog2e : -INFINITY};
  const float scale_log2 = scale * kLog2e;
  float dka[8][4], dva[8][4], dba[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  const int nt = (L + kT - 1) / kT;
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) {
      load_qg(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = j & 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = 32 * half;
      float sc[4][4], dp[4][4];
      mma_abt<4>(sc, kf, s.q[buf], r0);  // S^T: keys x queries
      mma_abt<4>(dp, vf, s.g[buf], r0);  // dP^T
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int qq = r0 + 8 * n + 2 * t;  // the lane's first query
        const unsigned keep = keep_rows_k(da, mh, L, ka, j * kT + qq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = e & 1;
          const float4 sq = s.st[buf][qq + c];
          const float x = sc[n][e] * scale_log2 + bk[r];
          const float p = j * kT + qq + c < L ? exp2f(x - sq.x) * sq.y : 0.0f;
          const bool kp = (keep >> e) & 1;
          const float ds = p * ((kp ? dp[n][e] * da.drop_scale : 0.0f) - sq.z);
          dba[r] += ds;
          sc[n][e] = kp ? p * da.drop_scale : 0.0f;
          dp[n][e] = ds;
        }
      }
      mma_pt<2>(dva, sc, s.g[buf], r0);  // dV += Pd^T g
      mma_pt<2>(dka, dp, s.q[buf], r0);  // dK += dS^T Q
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float db = quad_sum(dba[r]);
    const int key = ka + 8 * r;
    if (key >= L) continue;
    const long long o = (((long long)b * L + key) * H + h) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store2(dk + o + 8 * n, dka[n][2 * r] * scale,
             dka[n][2 * r + 1] * scale);
      store2(dv + o + 8 * n, dva[n][2 * r], dva[n][2 * r + 1]);
    }
    if (t == 0) dbias_h[(long long)mh * L + key] = db;
  }
}

// cp.async copies 16 bytes: every row of q, k, v must start on a 16-byte
// boundary
bool aligned16(const void* q, const void* k, const void* v,
               const Strides& st) {
  const uintptr_t p = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const long long s = st.qsb | st.qsl | st.qsh | st.ksb | st.ksl | st.ksh |
                      st.vsb | st.vsl | st.vsh;
  return p % 16 == 0 && s % 8 == 0;
}

// K2 and K3: one block per (64 query rows, h, b)
template <bool kDrop, typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               void* out, int B, int L, int H, int D, const Strides& st,
               float scale, const DropArgs& da, void* stream) {
  if (D != kD || !aligned16(q, k, v, st)) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return (int)cudaSuccess;
  const dim3 grid((L + kT - 1) / kT, H, B);
  auto kernel = attn_fwd_mma<kDrop, T>;
  if constexpr (kDrop)
    if (split_heads(da, H)) kernel = attn_fwd_mma<true, T, true>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, L,
      H, st, scale, da);
  return (int)cudaGetLastError();
}

// K4: the rows pass, then the keys pass
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* bias,
               const void* g, void* dq, void* dk, void* dv, void* dbias_h,
               void* stats, int B, int L, int H, int D, const Strides& st,
               float scale, const DropArgs& da, void* stream) {
  if (D != kD || !aligned16(q, k, v, st) || (uintptr_t)g % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return (int)cudaSuccess;
  const dim3 grid((L + kT - 1) / kT, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  const bool split = split_heads(da, H);
  auto rows = split ? attn_drop_bwd_rows_mma<T, true>
                    : attn_drop_bwd_rows_mma<T, false>;
  auto keys = split ? attn_drop_bwd_keys_mma<T, true>
                    : attn_drop_bwd_keys_mma<T, false>;
  rows<<<grid, kThreads, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const T*)g, (T*)dq, (float*)stats, L, H, st, scale, da);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  keys<<<grid, kThreads, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const T*)g, (const float*)stats, (T*)dk, (T*)dv, (float*)dbias_h, L,
      H, st, scale, da);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points: bf16, then fp16 with the same arguments

extern "C" int attention_fwd_bf16(const void* q, const void* k,
                                  const void* v, const void* bias, void* out,
                                  int B, int L, int H, int D, long long qsb,
                                  long long qsl, long long qsh, long long ksb,
                                  long long ksl, long long ksh, long long vsb,
                                  long long vsl, long long vsh, float scale,
                                  void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  return launch_fwd<false, bf16>(q, k, v, bias, out, B, L, H, D, st, scale,
                                DropArgs{nullptr, 0u, 1.0f, 0ull}, stream);
}

extern "C" int attention_dropout_fwd_bf16(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int L, int H, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, float scale, const void* bits,
    unsigned thresh, float drop_scale, unsigned long long seed,
    int head_offset, int heads_total, void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  return launch_fwd<true, bf16>(
      q, k, v, bias, out, B, L, H, D, st, scale,
      DropArgs{(const int*)bits, thresh, drop_scale, seed, head_offset,
               heads_total}, stream);
}

// g, dq, dk, dv: contiguous [B, L, H, D]; stats: [B*heads_total*L*3] fp32
// scratch; dbias_h: [B, heads_total, L] fp32, the launch's heads' rows
// written (summed over them by the caller).
extern "C" int attention_dropout_bwd_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, void* dbias_h, void* stats,
    int B, int L, int H, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, float scale, const void* bits,
    unsigned thresh, float drop_scale, unsigned long long seed,
    int head_offset, int heads_total, void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  return launch_bwd<bf16>(
      q, k, v, bias, g, dq, dk, dv, dbias_h, stats, B, L, H, D, st, scale,
      DropArgs{(const int*)bits, thresh, drop_scale, seed, head_offset,
               heads_total}, stream);
}

extern "C" int attention_fwd_fp16(const void* q, const void* k,
                                  const void* v, const void* bias, void* out,
                                  int B, int L, int H, int D, long long qsb,
                                  long long qsl, long long qsh, long long ksb,
                                  long long ksl, long long ksh, long long vsb,
                                  long long vsl, long long vsh, float scale,
                                  void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  return launch_fwd<false, f16>(q, k, v, bias, out, B, L, H, D, st, scale,
                                DropArgs{nullptr, 0u, 1.0f, 0ull}, stream);
}

extern "C" int attention_dropout_fwd_fp16(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int L, int H, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, float scale, const void* bits,
    unsigned thresh, float drop_scale, unsigned long long seed,
    int head_offset, int heads_total, void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  return launch_fwd<true, f16>(
      q, k, v, bias, out, B, L, H, D, st, scale,
      DropArgs{(const int*)bits, thresh, drop_scale, seed, head_offset,
               heads_total}, stream);
}

// g, dq, dk, dv: contiguous [B, L, H, D]; stats: [B*heads_total*L*3] fp32
// scratch; dbias_h: [B, heads_total, L] fp32, the launch's heads' rows
// written (summed over them by the caller).
extern "C" int attention_dropout_bwd_fp16(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, void* dbias_h, void* stats,
    int B, int L, int H, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, float scale, const void* bits,
    unsigned thresh, float drop_scale, unsigned long long seed,
    int head_offset, int heads_total, void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  return launch_bwd<f16>(
      q, k, v, bias, g, dq, dk, dv, dbias_h, stats, B, L, H, D, st, scale,
      DropArgs{(const int*)bits, thresh, drop_scale, seed, head_offset,
               heads_total}, stream);
}
