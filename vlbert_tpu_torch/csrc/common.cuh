// Small device helpers shared by the kernels of this package.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// Element types of the C entry points' dtype codes (the wrappers pass
// 0 for fp32, 1 for bf16, 2 for fp16)
enum DtypeCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

static __device__ __forceinline__ float to_f(float x) { return x; }
static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
static __device__ __forceinline__ float to_f(__half x) {
  return __half2float(x);
}

template <typename T>
static __device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);  // round to nearest even, as torch's cast
}

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011): a counter-based generator, so any element's bits come from
// (key, counter) alone and the backward pass replays the forward's mask
// without storing it. Returns the 4-word block. The plain PyTorch twin is
// ops/dropout.py::philox4x32; the two agree bit for bit.
static __device__ __forceinline__ uint4 philox4(unsigned c0, unsigned c1,
                                               unsigned c2, unsigned c3,
                                               unsigned long long seed) {
  unsigned k0 = (unsigned)seed, k1 = (unsigned)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Word i (0..3) of a block.
static __device__ __forceinline__ unsigned philox_word(uint4 w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
