// Hidden dropout (kernel K5) for Hopper: out[i] = keep(i) ? x[i] * scale : 0,
// elementwise over a contiguous tensor, forward and backward alike (the
// backward applies the same map to the cotangent).
//
// Replaces: vlbert_tpu/ops/dropout.py, _pallas_apply (the Pallas kernel
// _dropout_kernel behind hw_dropout). That kernel draws its bits from the
// TPU's hardware PRNG, which no other device reproduces; here each element's
// bits come from Philox4x32-10 with the wrapper's 64-bit seed as key and the
// element's flat index as counter (common.cuh), so the backward regenerates
// the forward's mask from the seed and no mask is stored. An explicit-bits
// mode (uint16 bits zero-extended to int32, the JAX 'bits16' rule) exists
// for parity tests against the JAX package.
//
// Semantics kept: scale is passed already rounded to x's dtype (in bf16,
// 1/(1-0.1) is 1.109375), and the product is rounded to x's dtype, as
// `x * jnp.asarray(scale, x.dtype)` does.
//
// What bounds it on the H100: memory. At the VQA training shapes
// ([16,128,768] and [16,95,4096] bf16) a call moves 3-12 MB; Philox costs
// ~20 integer multiplies per element, well under the bytes' time at
// 3.35 TB/s. Design: a grid-stride loop, one element per thread per step,
// no shared memory; adjacent threads touch adjacent elements.

#include "common.cuh"

namespace {

template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                               long long n, const int* __restrict__ bits,
                               unsigned thresh, float scale,
                               unsigned long long seed) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const bool keep = dropout_keep(bits, i, thresh, (unsigned)i,
                                   (unsigned)(i >> 32), 0u, 0u, seed);
    out[i] = keep ? from_f<T>(to_f(x[i]) * scale) : from_f<T>(0.0f);
  }
}

}  // namespace

extern "C" int dropout_fwd(const void* x, void* out, long long n,
                           int is_bf16, const void* bits, unsigned thresh,
                           float scale, unsigned long long seed,
                           void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    dropout_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, n, (const int*)bits,
        thresh, scale, seed);
  else
    dropout_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)x, (float*)out, n, (const int*)bits, thresh, scale,
        seed);
  return (int)cudaGetLastError();
}
