// Attention in fp32 on Hopper's tensor cores, by a three-product TF32
// split: the forward without dropout (kernel K2), and with attention-prob
// dropout the forward (kernel K3) and its deterministic recompute backward
// (kernel K4).
//
//   P   = softmax(Q K^T / sqrt(D) + bias)           (fp32, per (b, h))
//   Pd  = keep ? P * drop_scale : 0                 (fp32 scale; K2: Pd = P)
//   out = Pd V
//
// Replaces: vlbert_tpu/ops/attention.py, _fused_attention_fwd_impl (Pallas
// kernel _attn_kernel), _fad_fwd_impl (_attn_drop_fwd_kernel) and
// _fad_bwd_impl (_attn_drop_bwd_kernel), on their fp32 route: the Pallas
// kernels cast their tiles to fp32, so under TPU.COMPUTE_DTYPE float32
// they compute in fp32 throughout. The bf16 routes are
// attention_dropout_mma.cu's; the wrappers choose by dtype. K2 is K3's
// kernel with the mask compiled out (a compile-time kDrop), as in bf16.
//
// Semantics, the same as the bf16 kernels': scores, softmax, row sums and
// every accumulator in fp32; the -10000 additive bias is kept (masked keys
// are not skipped, so an all-masked row stays uniform over the L real
// keys); keys >= L are excluded outright (score -inf); rate == 1 gives
// zeros (drop_scale 0). Unlike the bf16 kernels, scores stay in the
// natural domain: s = fmaf(q.k, scale, bias) is the plain version's
// q.k / sqrt(D) + bias rounded once (q.k / 8 is exact), and p = expf(s -
// m). On an all-masked row s is about -10000, where an fp32 step is
// 2^-10; a detour through log2 e would round s again there and move p by
// ~3e-4.
//
// The split. Each fp32 operand x becomes big = cvt.rna.tf32.f32(x) (11
// significant bits) and small = cvt.rna.tf32.f32(x - big) (x - big is
// exact in fp32), and each product a b is three mma.sync.m16n8k8 TF32 MMAs
// into one fp32 accumulator, small terms first: a_small b_big + a_big
// b_small + a_big b_big. This is CUTLASS's OpMultiplyAddFastF32, the
// arithmetic of the fp32 memory-efficient attention that PyTorch's SDPA
// runs on sm80+. What it drops, a_small b_small and the residue of small's
// own rounding, is about 2^-22 of |a b|: some 4x fp32's rounding, far
// inside the 1e-5 (forward) and 1e-4 relative (backward) that
// chip_smoke.py holds these kernels to. One pass (big b_big alone) is off
// by 2^-11 of |a b|: scores off by ~1e-3 miss 1e-5 (tests/
// test_torch_attention_tf32.py emulates both). Both products are split,
// P V too: P rounded once to TF32 would cost the same 2^-11. On
// chip_smoke.py's exact-score inputs (q, k on a 2^-6 grid in (-4, 4): at
// most 8 significant bits) small is 0 for q and k, every q_d k_d is exact
// (16 bits), and their sums (multiples of 2^-12 below 2^11) fit fp32's 24
// bits, so the scores are exact in any order, as the plain version's.
//
// What bounds it on the H100: at the VQA training shape (B=16, H=12,
// L=128, D=64, fp32) the forward (K2, K3) moves 25.2 MB (7.5 us at 3.35
// TB/s) and does 0.81 GFLOP, 4.9 us as three TF32 products at 494.7
// TFLOP/s (12 us on the CUDA cores at 67); K3 adds one Philox evaluation
// per four scores (2.6 us of integer issue); the backward moves 44.1 MB
// (13.2 us) and does 2.01 GFLOP, 12.2 us as three TF32 products. On paper
// both are bound by their bytes. In practice latency bounds them: each product costs about
// 15 us at this shape, its MMAs issuing at roughly a third of mma.sync's
// rate (estimated from instruction counts, not from a stall profile),
// at 12 warps a SM; around each MMA sit the split of its
// B elements (two cvt and a subtract, repeated by every warp that reads
// them) and one expf per score and pass. The backward recomputes S and
// dP twice, so it issues 9 products where 5 are needed. Measured
// (chip_smoke.py, H100 80GB HBM3 at 700 W): K2 0.0278 ms at B=16 L=128
// (SDPA fp32 0.0337), 0.0605 at B=16 L=173 (0.0837); K3 0.0298 ms at
// B=16 L=128 (SDPA fp32 with dropout 0.0394), 0.0655 at B=16 L=173
// (0.1005); K4 0.142 ms at B=16 L=128 (SDPA fp32's backward 0.139), 0.308
// at B=16 L=173 (0.258). At B=1 L=41 the 12 blocks (one a head) make K2
// latency: 0.0073 ms.
//
// Design (attention_dropout_mma.cu's, in fp32, with the fragments of the
// block's own rows read from shared memory):
//  * A block owns 64 rows (4 warps x 16: queries in K2 and K4's rows
//    pass, keys in its keys pass), kept in shared memory for the whole
//    kernel, and streams the other side in chunks of 32 rows, double-
//    buffered: chunk j + 1 is in flight while chunk j is computed. Rows
//    are 64 floats at a stride of 68 (272 bytes: 16-byte aligned for
//    cp.async; every fragment load hits 32 distinct banks, see below),
//    filled by 16-byte cp.async copies straight from the strided q, k, v
//    views; rows >= L are zero-filled. 52 KB (K2) or 70 KB (K4) of dynamic
//    shared memory: four or three blocks a SM, so the 384 blocks of the
//    VQA shape run in one wave on 132 SMs. The own rows' A fragments are
//    read from shared memory at each use, not held in registers: held,
//    their splits are loop-invariant, the compiler hoists all of them out
//    of the loops, and the backward spills 1-2 KB a thread at 168
//    registers (ptxas -v).
//  * Grids are (L / 64, H, B). A operands are split once per k-step; B
//    operands are split as read, by every warp that reads them. In A B^T
//    (S = Q K^T and its kin) k runs over dims and lane (g, t) reads B at
//    [8 n + g][8 ks + t (+4)]: bank 4 g + t, conflict-free, and A the
//    same way. In P T (P V and its kin) k runs over the chunk's rows, and
//    k slots t and t + 4 stand for rows 2 t and 2 t + 1: then P's C
//    fragment is already its A fragment (no shuffles), and lane (g, t)
//    reads T at [2 t (+1)][8 n + g]: bank 8 t + g (+4), conflict-free too.
//  * K2 and K3: one block per (64 query rows, h, b); for each chunk of 32
//    keys S = Q K^T, scale and bias, the running max and the row sum over
//    every key (kept or not), then P * keep V into the fp32 accumulator;
//    out = acc / l (K2) or acc * (drop_scale / l) (K3).
//  * K4, two launches, deterministic (no atomics, every sum in a fixed
//    order), so a training step is bit-reproducible:
//    - rows pass, one block per 64 query rows (Q and g resident): a
//      first sweep, S = Q K^T and dP = g V^T, gives m, l and D = sum_j P_j
//      keep_j drop_scale dP_j online (= g . out); a second sweep gives the
//      same dP again, dS = P (keep drop_scale dP - D) and dQ += dS K.
//      Writes dq and the row statistics (m, l, D) to a [B, H, L, 3] fp32
//      scratch. D is taken from the very dP values dS uses, as the plain
//      version takes it, so sum_j dS_j = D (1 - sum_j P_j) cancels to
//      rounding: the key bias's gradient, 0 in exact arithmetic, stays at
//      the plain version's noise. Taken instead as g . out from K3's saved
//      output (one product fewer), it did not: chip_smoke.py's fp32 VQA
//      step on an H100 then moved the key biases by 1.7e-4 of their
//      floored scale (limit 1e-4).
//    - keys pass, one block per 64 keys (K and V resident): walks the
//      query chunks in order: S^T = K Q^T and dP^T = V g^T, P from the row
//      statistics, then dV += Pd^T g, dK += dS^T Q and the per-head dbias
//      row sums. The wrapper sums dbias over heads.
//    Nothing is saved between forward and backward but (q, k, v, bias,
//    seed or bits).
//  * The mask: one Philox4x32-10 evaluation at counter (key / 4, query,
//    b*heads_total + head_offset + h, 1) whose word key % 4 decides (the
//    layer's head: attention_dropout.cuh's mask_head), or explicit bits,
//    drawn one evaluation per four elements of a C fragment by
//    attention_dropout.cuh's keep_rows_q (K3, rows pass) and keep_rows_k
//    (keys pass), the bf16 kernels' own (the m16n8k8 C layout is the
//    m16n8k16 one): K3 and K4 draw the same words in both dtypes.

#include <cstdint>

#include "attention_dropout.cuh"

namespace {

constexpr int kD = 64;          // head dim
constexpr int kT = 64;          // a block's own rows: query rows, keys
constexpr int kC = 32;          // rows of a streamed chunk
constexpr int kS = kD + 4;      // shared-memory row stride, floats
constexpr int kThreads = 128;   // 4 warps x 16 rows
// blocks per SM, as many as shared memory holds (52 KB, 70 KB of 227 KB);
// the register cap that follows (128, 168 a thread) leaves no spill
constexpr int kFwdBlocksPerSM = 4;
constexpr int kDropFwdBlocksPerSM = 4;
constexpr int kBwdBlocksPerSM = 3;

typedef float Row[kS];
typedef Row Tile[kT];
typedef Row Chunk[kC];

// ---------------------------------------------------------------- PTX

// x rounded to TF32 (10 stored mantissa bits; the low 13 bits of the
// result are 0): to nearest, ties away from zero
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// An A fragment (4 elements a lane) split into its big and small TF32
// parts
struct Frag {
  unsigned big[4], small[4];
};

__device__ __forceinline__ Frag split4(float a0, float a1, float a2,
                                       float a3) {
  const float a[4] = {a0, a1, a2, a3};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.big[i] = to_tf32(a[i]);
    f.small[i] = to_tf32(a[i] - __uint_as_float(f.big[i]));
  }
  return f;
}

// c (16 x 8, fp32) += a (16 x 8, tf32) b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to fp32 accuracy: b's two elements split here, then three
// MMAs, small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const Frag& a, float b0,
                                     float b1) {
  const unsigned b0big = to_tf32(b0), b1big = to_tf32(b1);
  const unsigned b0small = to_tf32(b0 - __uint_as_float(b0big));
  const unsigned b1small = to_tf32(b1 - __uint_as_float(b1big));
  mma_tf32(c, a.small, b0big, b1big);
  mma_tf32(c, a.big, b0small, b1small);
  mma_tf32(c, a.big, b0big, b1big);
}

// ---------------------------------------------------------------- tiles

// R rows from r0 of one (b, h) slice (base, row stride sl elements) into
// shared memory, 16 bytes per copy; rows >= L are zero-filled.
template <int R>
__device__ __forceinline__ void load_rows(Row* s, const float* base,
                                          long long sl, int r0, int L) {
#pragma unroll
  for (int it = 0; it < R * kD / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> 4, c = (i & 15) * 4;
    const bool ok = r0 + r < L;
    cp_async16(&s[r][c], base + (ok ? (long long)(r0 + r) * sl : 0) + c, ok);
  }
}

// c[n] = A B^T for n-tile n (n < NT): A is a warp's 16 rows a[0..15] of a
// shared-memory tile over the 64 dims, B the rows b[8 n .. 8 n + 7]. S =
// Q K^T and its kin.
template <int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const Row* a,
                                        const Row* b) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int d = 8 * ks + t;
    const Frag f = split4(a[g][d], a[g + 8][d], a[g][d + 4], a[g + 8][d + 4]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma3(c[n], f, b[8 * n + g][d], b[8 * n + g][d + 4]);
  }
}

// acc (16 rows x 64 dims, C layout) += P T: P is 16 rows x 8 KS columns in
// C layout (KS n-tiles), T the rows s[0 .. 8 KS - 1]. k slot t of n-tile
// kk is row 8 kk + 2 t and slot t + 4 row 8 kk + 2 t + 1, so P's C
// fragment (columns 2 t, 2 t + 1) is its A fragment.
template <int KS>
__device__ __forceinline__ void mma_pt(float (&acc)[8][4],
                                       const float (&p)[KS][4],
                                       const Row* s) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const Frag f = split4(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);
    const float* r0 = s[8 * kk + 2 * t];
    const float* r1 = s[8 * kk + 2 * t + 1];
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      mma3(acc[dn], f, r0[8 * dn + g], r1[8 * dn + g]);
  }
}

// ---------------------------------------------------------------- sweeps

// Key chunks double-buffered: K, V and the chunk's bias (-inf past L).
struct KV {
  Chunk k[2], v[2];
  float bias[2][kC];
};

struct Slice {  // one (b, h): k and v rows and the batch row's bias
  const float* k;
  const float* v;
  long long ksl, vsl;
  const float* bias;
};

__device__ __forceinline__ Slice slice_of(const float* k, const float* v,
                                          const float* bias,
                                          const Strides& st, int b, int h,
                                          int L) {
  return Slice{k + b * st.ksb + h * st.ksh, v + b * st.vsb + h * st.vsh,
               st.ksl, st.vsl, bias + (long long)b * L};
}

__device__ __forceinline__ void load_kv(KV& s, int j, const Slice& sl,
                                        int L) {
  const int buf = j & 1, k0 = j * kC;
  load_rows<kC>(s.k[buf], sl.k, sl.ksl, k0, L);
  load_rows<kC>(s.v[buf], sl.v, sl.vsl, k0, L);
  if (threadIdx.x < kC) {
    const int key = k0 + threadIdx.x;
    s.bias[buf][threadIdx.x] = key < L ? sl.bias[key] : -INFINITY;
  }
}

// Chunk j of nc: issue chunk j + 1's copies into the other buffer (free
// since the barrier that ended chunk j - 1), then wait for chunk j's.
__device__ __forceinline__ void next_kv(KV& s, int j, int nc,
                                        const Slice& sl, int L) {
  if (j + 1 < nc) {
    load_kv(s, j + 1, sl, L);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

// One warp's 16 query rows (q, in shared memory; qa = its lane's first
// row) against every key: m, the running max; l, this lane's share of the
// row sum over every key, kept or not (the quad sums it); acc = sum_j
// keep_j exp(s_j - m) v_j in C layout, unnormalized (kDrop false: every
// keep_j is 1 and da is not read). Chunk 0's copies must have been issued
// and committed.
template <bool kDrop>
__device__ __forceinline__ void forward_sweep(KV& s, const Row* q,
                                              const Slice& sl, int L, int mh,
                                              int qa, float scale,
                                              const DropArgs& da,
                                              float (&m)[2], float (&l)[2],
                                              float (&acc)[8][4]) {
  const int t = threadIdx.x & 3, nc = (L + kC - 1) / kC;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (int j = 0; j < nc; ++j) {
    next_kv(s, j, nc, sl, L);
    const int buf = j & 1;
    float sc[4][4];
    mma_abt<4>(sc, q, s.k[buf]);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            fmaf(sc[n][e], scale, s.bias[buf][8 * n + 2 * t + (e & 1)]);
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);     // finite: chunk j holds key j * 32 < L
      corr[r] = expf(m[r] - mx[r]);  // 0 on the first chunk
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
    for (int n = 0; n < 4; ++n) {
      const unsigned keep =
          kDrop ? keep_rows_q(da, mh, L, qa, j * kC + 8 * n + 2 * t) : 0xfu;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[n][e] = (keep >> e) & 1 ? p : 0.0f;
      }
    }
    mma_pt<4>(acc, sc, s.v[buf]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- kernels

struct FwdSmem {
  Tile q;
  KV kv;
};

// K3 (kDrop) and K2 (no mask): one block per (64 query rows, h, b). K2's
// out = acc / l; K3's out = acc * (drop_scale / l). kSplit: the launch
// holds part of the layer's heads.
template <bool kDrop, bool kSplit = false>
__global__ void __launch_bounds__(kThreads,
                                  kDrop ? kDropFwdBlocksPerSM : kFwdBlocksPerSM)
    attn_fwd_f32_mma(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int L, int H, Strides st, float scale, DropArgs da) {
  extern __shared__ __align__(16) unsigned char smem[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kT;
  const Slice sl = slice_of(k, v, bias, st, b, h, L);
  load_rows<kT>(s.q, q + b * st.qsb + h * st.qsh, st.qsl, q0, L);
  load_kv(s.kv, 0, sl, L);
  cp_async_commit();
  const int qa = q0 + 16 * warp + (lane >> 2);
  float m[2], l[2], acc[8][4];
  forward_sweep<kDrop>(s.kv, s.q + 16 * warp, sl, L,
                       mask_head<kSplit>(da, b, H, h), qa, scale, da, m, l,
                       acc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int row = qa + 8 * r;
    if (row >= L) continue;
    float* o = out + (((long long)b * L + row) * H + h) * kD + 2 * (lane & 3);
    const float f = da.drop_scale / lsum;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          kDrop ? make_float2(acc[n][2 * r] * f, acc[n][2 * r + 1] * f)
                : make_float2(acc[n][2 * r] / lsum, acc[n][2 * r + 1] / lsum);
  }
}

struct RowsSmem {
  Tile q, g;
  KV kv;
};

// K4, rows pass: one block per (64 query rows, h, b); dq and the row
// statistics (m, l, D).
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
    attn_drop_bwd_rows_f32_mma(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ bias,
                               const float* __restrict__ g,
                               float* __restrict__ dq,
                               float* __restrict__ stats, int L, int H,
                               Strides st, float scale, DropArgs da) {
  extern __shared__ __align__(16) unsigned char smem[];
  RowsSmem& s = *reinterpret_cast<RowsSmem*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int mh = mask_head<kSplit>(da, b, H, h);
  const int q0 = blockIdx.x * kT;
  const Slice sl = slice_of(k, v, bias, st, b, h, L);
  const long long gsl = (long long)H * kD;  // g is contiguous [B, L, H, D]
  load_rows<kT>(s.q, q + b * st.qsb + h * st.qsh, st.qsl, q0, L);
  load_rows<kT>(s.g, g + ((long long)b * L * H + h) * kD, gsl, q0, L);
  load_kv(s.kv, 0, sl, L);
  cp_async_commit();

  const Row* qw = s.q + 16 * warp;
  const Row* gw = s.g + 16 * warp;
  const int qa = q0 + 16 * warp + (lane >> 2);
  const int nc = (L + kC - 1) / kC;
  // first sweep: m, l and D = sum_j P_j keep_j drop_scale dP_j (= g .
  // out), online; D from the same dP values as dS below, so that
  // sum_j dS_j = D (1 - sum_j P_j) cancels as in the plain version
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float dd[2] = {0.0f, 0.0f};
  for (int j = 0; j < nc; ++j) {
    next_kv(s.kv, j, nc, sl, L);
    const int buf = j & 1;
    float sc[4][4], dp[4][4];
    mma_abt<4>(sc, qw, s.kv.k[buf]);
    mma_abt<4>(dp, gw, s.kv.v[buf]);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            fmaf(sc[n][e], scale, s.kv.bias[buf][8 * n + 2 * t + (e & 1)]);
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);     // finite: chunk j holds key j * 32 < L
      const float corr = expf(m[r] - mx[r]);  // 0 on the first chunk
      m[r] = mx[r];
      l[r] *= corr;
      dd[r] *= corr;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const unsigned keep = keep_rows_q(da, mh, L, qa, j * kC + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        if ((keep >> e) & 1) dd[e >> 1] += p * dp[n][e];
      }
    }
    __syncthreads();
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv_l[r] = 1.0f / l[r];
    dd[r] = quad_sum(dd[r]) * da.drop_scale * inv_l[r];
  }

  float dqa[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.0f;
  load_kv(s.kv, 0, sl, L);  // the first sweep's last barrier freed both
  cp_async_commit();
  for (int j = 0; j < nc; ++j) {
    next_kv(s.kv, j, nc, sl, L);
    const int buf = j & 1;
    float sc[4][4], dp[4][4];
    mma_abt<4>(sc, qw, s.kv.k[buf]);
    mma_abt<4>(dp, gw, s.kv.v[buf]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c0 = 8 * n + 2 * t;  // the lane's first key in the chunk
      const unsigned keep = keep_rows_q(da, mh, L, qa, j * kC + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = fmaf(sc[n][e], scale, s.kv.bias[buf][c0 + (e & 1)]);
        const float p = expf(x - m[r]) * inv_l[r];
        const float dpm = (keep >> e) & 1 ? dp[n][e] * da.drop_scale : 0.0f;
        sc[n][e] = p * (dpm - dd[r]);
      }
    }
    mma_pt<4>(dqa, sc, s.kv.k[buf]);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    if (row >= L) continue;
    float* o = dq + (((long long)b * L + row) * H + h) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
    if (t == 0) {
      float* sp = stats + ((long long)mh * L + row) * 3;
      sp[0] = m[r];
      sp[1] = l[r];
      sp[2] = dd[r];
    }
  }
}

// The keys pass's shared memory: the block's K and V rows, and query
// chunks double-buffered: Q, g and each row's statistics (m, 1 / l, D;
// zeros past L).
struct KeysSmem {
  Tile k, v;
  Chunk q[2], g[2];
  float4 st[2][kC];
};

// K4, keys pass: one block per (64 keys, h, b); dk, dv and the per-head
// dbias.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
    attn_drop_bwd_keys_f32_mma(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ bias,
                               const float* __restrict__ g,
                               const float* __restrict__ stats,
                               float* __restrict__ dk, float* __restrict__ dv,
                               float* __restrict__ dbias_h, int L, int H,
                               Strides st, float scale, DropArgs da) {
  extern __shared__ __align__(16) unsigned char smem[];
  KeysSmem& s = *reinterpret_cast<KeysSmem*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int mh = mask_head<kSplit>(da, b, H, h);
  const int k0 = blockIdx.x * kT;
  const float* qb = q + b * st.qsb + h * st.qsh;
  const float* gb = g + ((long long)b * L * H + h) * kD;
  const long long gsl = (long long)H * kD;
  const float* sbh = stats + (long long)mh * L * 3;

  auto load_qg = [&](int j) {
    const int buf = j & 1, r0 = j * kC;
    load_rows<kC>(s.q[buf], qb, st.qsl, r0, L);
    load_rows<kC>(s.g[buf], gb, gsl, r0, L);
    if (threadIdx.x < kC) {
      const int row = r0 + threadIdx.x;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < L)
        x = make_float4(sbh[3 * row], 1.0f / sbh[3 * row + 1],
                        sbh[3 * row + 2], 0.0f);
      s.st[buf][threadIdx.x] = x;
    }
  };

  load_rows<kT>(s.k, k + b * st.ksb + h * st.ksh, st.ksl, k0, L);
  load_rows<kT>(s.v, v + b * st.vsb + h * st.vsh, st.vsl, k0, L);
  load_qg(0);
  cp_async_commit();

  const Row* kw = s.k + 16 * warp;
  const Row* vw = s.v + 16 * warp;
  const int ka = k0 + 16 * warp + (lane >> 2);
  const float* brow = bias + (long long)b * L;
  const float bk[2] = {ka < L ? brow[ka] : -INFINITY,
                       ka + 8 < L ? brow[ka + 8] : -INFINITY};
  float dka[8][4], dva[8][4], dba[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  const int nc = (L + kC - 1) / kC;
  for (int j = 0; j < nc; ++j) {
    if (j + 1 < nc) {
      load_qg(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = j & 1;
    float sc[4][4], dp[4][4];
    mma_abt<4>(sc, kw, s.q[buf]);  // S^T: keys x queries
    mma_abt<4>(dp, vw, s.g[buf]);  // dP^T
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int qq = 8 * n + 2 * t;  // the lane's first query in the chunk
      const unsigned keep = keep_rows_k(da, mh, L, ka, j * kC + qq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = e & 1;
        const float4 sq = s.st[buf][qq + c];
        const float x = fmaf(sc[n][e], scale, bk[r]);
        const float p = j * kC + qq + c < L ? expf(x - sq.x) * sq.y : 0.0f;
        const bool kp = (keep >> e) & 1;
        const float ds = p * ((kp ? dp[n][e] * da.drop_scale : 0.0f) - sq.z);
        dba[r] += ds;
        sc[n][e] = kp ? p * da.drop_scale : 0.0f;
        dp[n][e] = ds;
      }
    }
    mma_pt<4>(dva, sc, s.g[buf]);  // dV += Pd^T g
    mma_pt<4>(dka, dp, s.q[buf]);  // dK += dS^T Q
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
      *reinterpret_cast<float2*>(dk + o + 8 * n) =
          make_float2(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + o + 8 * n) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
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
  return p % 16 == 0 && s % 4 == 0;
}

// Above 48 KB a block's shared memory must be asked for, per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K2 and K3: one block per (64 query rows, h, b)
template <bool kDrop>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               void* out, int B, int L, int H, int D, const Strides& st,
               float scale, const DropArgs& da, void* stream) {
  if (D != kD || !aligned16(q, k, v, st)) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return (int)cudaSuccess;
  auto kernel = attn_fwd_f32_mma<kDrop>;
  if constexpr (kDrop)
    if (split_heads(da, H)) kernel = attn_fwd_f32_mma<true, true>;
  const cudaError_t err = allow_smem(kernel, sizeof(FwdSmem));
  if (err) return (int)err;
  const dim3 grid((L + kT - 1) / kT, H, B);
  kernel<<<grid, kThreads, sizeof(FwdSmem), (cudaStream_t)stream>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)bias, (float*)out, L, H, st, scale, da);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attention_fwd_f32(const void* q, const void* k,
                                 const void* v, const void* bias, void* out,
                                 int B, int L, int H, int D, long long qsb,
                                 long long qsl, long long qsh, long long ksb,
                                 long long ksl, long long ksh, long long vsb,
                                 long long vsl, long long vsh, float scale,
                                 void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  return launch_fwd<false>(q, k, v, bias, out, B, L, H, D, st, scale,
                           DropArgs{nullptr, 0u, 1.0f, 0ull}, stream);
}

extern "C" int attention_dropout_fwd_f32(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int L, int H, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, float scale, const void* bits,
    unsigned thresh, float drop_scale, unsigned long long seed,
    int head_offset, int heads_total, void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  return launch_fwd<true>(q, k, v, bias, out, B, L, H, D, st, scale,
                          DropArgs{(const int*)bits, thresh, drop_scale, seed,
                                   head_offset, heads_total},
                          stream);
}

// g, dq, dk, dv: contiguous [B, L, H, D]; stats: [B*heads_total*L*3] fp32
// scratch; dbias_h: [B, heads_total, L] fp32, the launch's heads' rows
// written (summed over them by the caller).
extern "C" int attention_dropout_bwd_f32(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, void* dbias_h, void* stats,
    int B, int L, int H, int D, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, float scale, const void* bits,
    unsigned thresh, float drop_scale, unsigned long long seed,
    int head_offset, int heads_total, void* stream) {
  const Strides st{qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  if (D != kD || !aligned16(q, k, v, st) || (uintptr_t)g % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return (int)cudaSuccess;
  const DropArgs da{(const int*)bits, thresh, drop_scale, seed,
                    head_offset, heads_total};
  const bool split = split_heads(da, H);
  auto rows = split ? attn_drop_bwd_rows_f32_mma<true>
                    : attn_drop_bwd_rows_f32_mma<false>;
  auto keys = split ? attn_drop_bwd_keys_f32_mma<true>
                    : attn_drop_bwd_keys_f32_mma<false>;
  cudaError_t err = allow_smem(rows, sizeof(RowsSmem));
  if (!err) err = allow_smem(keys, sizeof(KeysSmem));
  if (err) return (int)err;
  const dim3 grid((L + kT - 1) / kT, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  rows<<<grid, kThreads, sizeof(RowsSmem), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (const float*)g, (float*)dq, (float*)stats, L, H, st, scale, da);
  err = cudaGetLastError();
  if (err) return (int)err;
  keys<<<grid, kThreads, sizeof(KeysSmem), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (const float*)g, (const float*)stats, (float*)dk, (float*)dv,
      (float*)dbias_h, L, H, st, scale, da);
  return (int)cudaGetLastError();
}
