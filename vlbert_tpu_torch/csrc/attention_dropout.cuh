// The keep mask of attention-prob dropout (kernels K3 and K4), shared by
// the fp32 kernels (attention_dropout.cu) and the bf16 tensor-core kernels
// (attention_dropout_mma.cu).
//
// Philox mode (bits == nullptr): one Philox4x32-10 evaluation per four
// neighbouring keys of one query row, counter (key / 4, query, b*H + h, 1)
// and the call's 64-bit seed; key k takes word k % 4, and is kept iff the
// word >= thresh (thresh = min(round(rate * 2^32), 2^32 - 1)). The plain
// twin is ops/attention.py::attention_bits. Explicit-bits mode: bits holds
// [B, H, L, L] uint16 values zero-extended to int32 and thresh =
// round(rate * 65536), the JAX package's 'bits16' rule.
#pragma once

#include "common.cuh"

struct DropArgs {
  const int* bits;         // [B,H,L,L] int32 or nullptr (Philox)
  unsigned thresh;
  float drop_scale;        // 1 / (1 - rate) in fp32, 0 at rate 1
  unsigned long long seed;
};

// Keep decision of one (query row, key) element of head bh.
static __device__ __forceinline__ bool attention_keep(const DropArgs& a,
                                                      int bh, int L, int row,
                                                      int key) {
  if (a.bits != nullptr)
    return (unsigned)a.bits[((long long)bh * L + row) * L + key] >= a.thresh;
  const uint4 w = philox4((unsigned)key >> 2, (unsigned)row, (unsigned)bh,
                          1u, a.seed);
  return philox_word(w, key & 3) >= a.thresh;
}
