// Device code shared by the attention kernels on the tensor cores: the bf16
// K2, K3 and K4 (attention_dropout_mma.cu) and the fp32 ones, a three-
// product TF32 split (attention_f32_mma.cu): the cp.async helpers, the quad
// reductions and the keep mask. One copy, so that every kernel draws the
// same mask.
//
// The keep mask of attention-prob dropout (kernels K3 and K4). Philox mode
// (bits == nullptr): one Philox4x32-10 evaluation per four neighbouring
// keys of one query row, counter (key / 4, query, b*heads_total +
// head_offset + h, 1) and the call's 64-bit seed; key k takes word k % 4,
// and is kept iff the word >= thresh (thresh = min(round(rate * 2^32),
// 2^32 - 1)). A launch over heads head_offset .. head_offset + H - 1 of a
// layer of heads_total (tensor parallelism: a rank's heads) draws their
// masks as the launch over all of them does; a launch over the whole layer
// passes 0 and H. The plain twin is ops/attention.py::attention_bits.
// Explicit-bits mode: bits holds this launch's [B, H, L, L] uint16 values
// zero-extended to int32 and thresh = round(rate * 65536), the JAX
// package's 'bits16' rule; the launch passes 0 and H (the bits are its
// own heads'). One index, mask_head, places a head everywhere: the Philox
// counter, the explicit bits and K4's per-head scratch (row statistics and
// dbias), which the host sizes [B, heads_total, L] and of which a launch
// writes its own heads' rows. The kernels are instantiated twice: a launch
// over the whole layer (0, H) takes the kSplit = false copy, whose index
// b*H + h reads no head field, so that it keeps the registers and the time
// of a kernel that has none; a launch over part of the layer the other.
//
// In a C fragment of mma.sync (m16n8k16 bf16 and m16n8k8 TF32 alike) a lane
// holds rows g and g + 8 and columns 2t, 2t + 1 of each 8-column n-tile
// (g = lane / 4, t = lane % 4). keep_rows_q and keep_rows_k below give a
// fragment's four keep bits for one Philox evaluation per four elements:
// where rows are queries, lanes t and t ^ 1 cover the four keys of one
// evaluation, each evaluates one of its two rows and the pair trades two
// words by shuffle; where rows are keys, the four lanes with the same t
// and g / 4 need word g % 4 of four evaluations (two queries x two key
// groups), each evaluates one and four rotating shuffles transpose the
// words.
#pragma once

#include "common.cuh"

struct DropArgs {
  const int* bits;         // [B,H,L,L] int32 or nullptr (Philox)
  unsigned thresh;
  float drop_scale;        // 1 / (1 - rate) in fp32, 0 at rate 1
  unsigned long long seed;
  int head_offset;         // the launch's first head in the layer (0
  int heads_total;         // with bits) and the layer's heads (H)
};

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Strides {  // element strides of q, k, v over (b, l, h); unit on d
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh;
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte async copy to shared memory; zero-fills (reads nothing) when
// !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

// ---------------------------------------------------------------- mask

// The place of head h of batch row b in a layer of which a launch holds H
// heads: b*heads_total + head_offset + h, which is b*H + h when the launch
// holds the whole layer (kSplit false)
template <bool kSplit>
__device__ __forceinline__ int mask_head(const DropArgs& da, int b, int H,
                                         int h) {
  return kSplit ? b * da.heads_total + da.head_offset + h : b * H + h;
}

// True when a launch of H heads holds part of its layer
inline bool split_heads(const DropArgs& da, int H) {
  return da.head_offset != 0 || da.heads_total != H;
}

// Keep bits of a C fragment whose rows are queries: bit e of the result is
// element e, i.e. (qa, key), (qa, key + 1), (qa + 8, key), (qa + 8, key + 1)
// with key = the lane's first column (key % 4 is 0 on even lanes, 2 on odd
// ones); mh is the head's mask_head. All lanes of the warp must call it
// together.
__device__ __forceinline__ unsigned keep_rows_q(const DropArgs& da, int mh,
                                                int L, int qa, int key) {
  unsigned m = 0;
  if (da.bits != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = qa + 8 * (e >> 1), k = key + (e & 1);
      if (q < L && k < L &&
          (unsigned)da.bits[((long long)mh * L + q) * L + k] >= da.thresh)
        m |= 1u << e;
    }
    return m;
  }
  // lanes t and t ^ 1 share the evaluation of keys key & ~3 .. + 3: the
  // even lane evaluates row qa, the odd one row qa + 8, and each passes
  // the other the two words it needs (even: words 0, 1; odd: 2, 3)
  const bool odd = threadIdx.x & 1;
  const uint4 w = philox4((unsigned)key >> 2, (unsigned)(odd ? qa + 8 : qa),
                          (unsigned)mh, 1u, da.seed);
  const unsigned r0 = __shfl_xor_sync(kFull, odd ? w.x : w.z, 1);
  const unsigned r1 = __shfl_xor_sync(kFull, odd ? w.y : w.w, 1);
  const unsigned word[4] = {odd ? r0 : w.x, odd ? r1 : w.y,
                            odd ? w.z : r0, odd ? w.w : r1};
#pragma unroll
  for (int e = 0; e < 4; ++e) m |= (unsigned)(word[e] >= da.thresh) << e;
  return m;
}

// Keep bits of a C fragment whose rows are keys: bit e is element e, i.e.
// (ka, q), (ka, q + 1), (ka + 8, q), (ka + 8, q + 1) in (key, query) order,
// with ka = the lane's first row (ka % 4 == g % 4, ka + 8 in the next key
// group but one); mh is the head's mask_head. All lanes of the warp must
// call it together.
__device__ __forceinline__ unsigned keep_rows_k(const DropArgs& da, int mh,
                                                int L, int ka, int q) {
  unsigned m = 0;
  if (da.bits != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = ka + 8 * (e >> 1), qq = q + (e & 1);
      if (qq < L && k < L &&
          (unsigned)da.bits[((long long)mh * L + qq) * L + k] >= da.thresh)
        m |= 1u << e;
    }
    return m;
  }
  // the four lanes with this lane's t and g / 4 need word i = g % 4 of the
  // same four evaluations e_0..e_3 (element e's); lane i evaluates e_i and
  // in round r passes word (i - r) % 4 to the lane that reads it
  const int lane = threadIdx.x & 31, i = (lane >> 2) & 3;
  const uint4 w = philox4((unsigned)(ka + 8 * (i >> 1)) >> 2,
                          (unsigned)(q + (i & 1)), (unsigned)mh, 1u, da.seed);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int src = (i + r) & 3;
    const unsigned v = __shfl_sync(kFull, philox_word(w, (i - r) & 3),
                                   (lane & ~12) | (src << 2));
    m |= (unsigned)(v >= da.thresh) << src;
  }
  return m;
}

}  // namespace
