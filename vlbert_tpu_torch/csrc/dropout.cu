// Hidden dropout (kernel K5) for Hopper: out[i] = keep(i) ? x[i] * scale : 0,
// elementwise over a contiguous tensor, forward and backward alike (the
// backward applies the same map to the cotangent).
//
// Replaces: vlbert_tpu/ops/dropout.py, _pallas_apply (the Pallas kernel
// _dropout_kernel behind hw_dropout). That kernel draws its bits from the
// TPU's hardware PRNG, which no other device reproduces; here the bits come
// from Philox4x32-10 keyed by the wrapper's 64-bit seed, so the backward
// regenerates the forward's mask from the seed and no mask is stored. One
// evaluation feeds four consecutive elements: element i takes word i % 4 of
// the evaluation at counter (g & 0xffffffff, g >> 32, 0, 0), g = i / 4
// (c3 = 0 keeps these counters apart from K3/K4's, whose c3 is 1). The
// plain twin is ops/dropout.py::flat_index_bits. An explicit-bits mode
// (uint16 bits zero-extended to int32, the JAX 'bits16' rule) exists for
// parity tests against the JAX package.
//
// Semantics kept: scale is passed already rounded to x's dtype (in bf16,
// 1/(1-0.1) is 1.109375, in fp16 1.111328125), and the product is rounded
// to x's dtype, as `x * jnp.asarray(scale, x.dtype)` does: one IEEE
// multiply per kept element (the product of two bf16 or two fp16 values
// is exact in fp32, so one rounding after the fp32 multiply gives it).
//
// What bounds it on the H100: at the VQA training shape [16,128,768] bf16
// a call moves 6.3 MB (1.9 us at 3.35 TB/s). One Philox evaluation of all
// four words is about 55 SASS instructions (chip_smoke.py counts them);
// drawn once per element, its integer issue would take 2.5x the bytes'
// time, so the kernel would be bound by integer issue. One evaluation per
// four elements puts that floor at 1.3 us, under the bytes.
//
// Design: each thread of a grid-stride loop moves one 16-byte chunk of x
// (8 bf16 or fp16, or 4 fp32 elements), and of the explicit bits 16 bytes at a
// time, with one Philox evaluation per four elements; no shared memory.
// A contiguous view keeps its storage offset, so x may start anywhere: the
// chunks start at x's first 16-byte boundary, and the wrapper allocates
// out and copies the bits so that their 16-byte boundaries fall at the
// same flat index. The elements before it (the head) and after the last
// whole chunk (the tail), fewer than 8 each, take one thread each. Where
// the head is not a multiple of 4 a chunk straddles three groups of four
// (the kernel is instantiated for each first-element phase), so the mask
// stays a function of the flat index alone.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAlign = 16;  // bytes per vector access

__device__ __forceinline__ uint4 group_words(unsigned long long g,
                                             unsigned long long seed) {
  return philox4((unsigned)g, (unsigned)(g >> 32), 0u, 0u, seed);
}

// Keep bits of the V elements i0 .. i0 + V - 1 (i0 % 4 == S): bit e is
// element i0 + e.
template <int V, int S>
__device__ __forceinline__ unsigned chunk_keep(const int* __restrict__ bits,
                                               long long i0, unsigned thresh,
                                               unsigned long long seed) {
  unsigned m = 0;
  if (bits != nullptr) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const int4 b = reinterpret_cast<const int4*>(bits + i0)[j];
      m |= ((unsigned)((unsigned)b.x >= thresh) << (4 * j)) |
           ((unsigned)((unsigned)b.y >= thresh) << (4 * j + 1)) |
           ((unsigned)((unsigned)b.z >= thresh) << (4 * j + 2)) |
           ((unsigned)((unsigned)b.w >= thresh) << (4 * j + 3));
    }
    return m;
  }
  constexpr int kGroups = (S + V + 3) / 4;  // groups of four the chunk meets
  const unsigned long long g0 = (unsigned long long)i0 >> 2;
  uint4 w[kGroups];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) w[j] = group_words(g0 + j, seed);
#pragma unroll
  for (int e = 0; e < V; ++e)
    m |= (unsigned)(philox_word(w[(S + e) >> 2], (S + e) & 3) >= thresh)
         << e;
  return m;
}

// One 32-bit word of a chunk: its element (fp32) or two elements (bf16,
// fp16) times scale where kept, else 0; bit 0 (and 1) of keep are its
// elements.
__device__ __forceinline__ unsigned scale_word(unsigned w, unsigned keep,
                                               float scale, float) {
  return keep & 1 ? __float_as_uint(__uint_as_float(w) * scale) : 0u;
}

__device__ __forceinline__ unsigned scale_word(unsigned w, unsigned keep,
                                               float scale, __nv_bfloat16) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(keep & 1 ? __low2float(h) * scale : 0.0f,
                            keep & 2 ? __high2float(h) * scale : 0.0f);
  return *reinterpret_cast<const unsigned*>(&r);
}

__device__ __forceinline__ unsigned scale_word(unsigned w, unsigned keep,
                                               float scale, __half) {
  const __half2 h = *reinterpret_cast<const __half2*>(&w);
  const __half2 r =
      __floats2half2_rn(keep & 1 ? __low2float(h) * scale : 0.0f,
                        keep & 2 ? __high2float(h) * scale : 0.0f);
  return *reinterpret_cast<const unsigned*>(&r);
}

// x * scale where bit e of keep is set, else 0, over one 16-byte chunk
template <typename T>
__device__ __forceinline__ uint4 apply(uint4 v, unsigned keep, float scale) {
  constexpr int E = 4 / sizeof(T);  // elements a word
  return make_uint4(scale_word(v.x, keep, scale, T()),
                    scale_word(v.y, keep >> E, scale, T()),
                    scale_word(v.z, keep >> (2 * E), scale, T()),
                    scale_word(v.w, keep >> (3 * E), scale, T()));
}

// S: the flat index of the first chunk's first element (head), mod 4.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                   long long head, long long chunks,
                   const int* __restrict__ bits, unsigned thresh,
                   float scale, unsigned long long seed) {
  constexpr int V = kAlign / sizeof(T);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = tid; c < chunks; c += stride) {
    const long long i0 = head + c * V;
    const unsigned keep = chunk_keep<V, S>(bits, i0, thresh, seed);
    const uint4 v = *reinterpret_cast<const uint4*>(x + i0);
    *reinterpret_cast<uint4*>(out + i0) = apply<T>(v, keep, scale);
  }
  // the head and the tail, one element a thread
  const long long tail = n - head - chunks * V;
  if (tid < head + tail) {
    const long long i = tid < head ? tid : n - tail + (tid - head);
    const unsigned b =
        bits != nullptr
            ? (unsigned)bits[i]
            : philox_word(group_words((unsigned long long)i >> 2, seed),
                          (int)(i & 3));
    out[i] = b >= thresh ? from_f<T>(to_f(x[i]) * scale) : from_f<T>(0.0f);
  }
}

template <typename T>
int launch(const T* x, T* out, long long n, const int* bits,
           unsigned thresh, float scale, unsigned long long seed,
           cudaStream_t s) {
  constexpr int V = kAlign / sizeof(T);
  const uintptr_t px = (uintptr_t)x;
  const long long head = std::min(
      n, (long long)((kAlign - px % kAlign) % kAlign / sizeof(T)));
  // out, and the bits, must meet a 16-byte boundary at the same element
  if (px % sizeof(T) != 0 || (uintptr_t)out % kAlign != px % kAlign ||
      (bits != nullptr && ((uintptr_t)bits + 4 * head) % kAlign != 0))
    return (int)cudaErrorInvalidValue;
  const long long chunks = (n - head) / V;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one thread per chunk up to a full wave (2048 threads an SM); the head
  // and tail need at most 2 V - 2 threads
  const long long want = (chunks + kThreads - 1) / kThreads;
  const int blocks =
      (int)std::max(1LL, std::min(want, (long long)sms * 2048 / kThreads));
  switch (head & 3) {
    case 0:
      dropout_kernel<T, 0><<<blocks, kThreads, 0, s>>>(
          x, out, n, head, chunks, bits, thresh, scale, seed);
      break;
    case 1:
      dropout_kernel<T, 1><<<blocks, kThreads, 0, s>>>(
          x, out, n, head, chunks, bits, thresh, scale, seed);
      break;
    case 2:
      dropout_kernel<T, 2><<<blocks, kThreads, 0, s>>>(
          x, out, n, head, chunks, bits, thresh, scale, seed);
      break;
    default:
      dropout_kernel<T, 3><<<blocks, kThreads, 0, s>>>(
          x, out, n, head, chunks, bits, thresh, scale, seed);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: the DtypeCode of x and out (common.cuh)
extern "C" int dropout_fwd(const void* x, void* out, long long n, int dtype,
                           const void* bits, unsigned thresh, float scale,
                           unsigned long long seed, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch((const float*)x, (float*)out, n, (const int*)bits,
                    thresh, scale, seed, s);
    case kBF16:
      return launch((const __nv_bfloat16*)x, (__nv_bfloat16*)out, n,
                    (const int*)bits, thresh, scale, seed, s);
    case kF16:
      return launch((const __half*)x, (__half*)out, n, (const int*)bits,
                    thresh, scale, seed, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
