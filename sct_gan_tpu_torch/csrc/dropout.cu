// Hash dropout for Hopper (sm_90a): y = keep ? x * scale : 0, f32 or bf16.
//
// Replaces the TPU kernel sct_gan_tpu/ops/dropout.py::_kernel (via
// _dropout_raw / _dropout2d), which draws its keep mask from the TPU's own
// PRNG. This kernel draws the JAX package's default hash stream instead
// (hash_dropout.cuh; _hash_apply), keyed by the flat element index of the
// contiguous tensor, so it reproduces the JAX package bit for bit. The
// backward is this kernel applied to the incoming gradient with the same
// seed: the mask is regenerated, never stored.
//
// What bounds it on an H100: one read and one write per element and ~12
// integer ops for the hash, so it is bandwidth-bound (a bf16 (8, 1024, 2048)
// pass moves 64 MB: ~20 us at 3.35 TB/s). The design does one pass with
// 16-byte loads and stores per thread (8 bf16 or 4 f32), the ragged tail
// element by element.
//
// scale is 1 / (1 - rate) already rounded to x's dtype by the caller, and the
// product is rounded once to x's dtype, as _hash_apply computes it.
//
// Under a mesh x is a shard of the tensor the single-card step drops, and
// the mask is keyed by the global flat index: local element i of a last axis
// of row_len elements sits at origin + (i / row_len) * row_stride + i %
// row_len (row_stride = row_len for a shard cut along rows only, the shard's
// column origin folded into origin). All of it is uint32 and wraps, as the
// JAX index does; the caller checks that the global indices stay below 2^32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct ShardIndex {     // local flat index -> global flat index
  uint32_t origin, row_len, row_stride;
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    if (row_stride == row_len) return origin + i;
    return origin + (i / row_len) * row_stride + i % row_len;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, uint32_t n,
               uint32_t seed, uint32_t threshold, float scale, ShardIndex at) {
  constexpr int VEC = 16 / sizeof(T);
  const uint32_t base = (blockIdx.x * NTHREADS + threadIdx.x) * VEC;
  if (base >= n) return;
  if (base + VEC <= n) {
    uint4 in = *reinterpret_cast<const uint4*>(x + base);
    uint4 out;
    const T* xi = reinterpret_cast<const T*>(&in);
    T* yo = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      yo[i] = hash_keep(at(base + i), seed, threshold) ? from_f<T>(to_f(xi[i]) * scale)
                                                       : from_f<T>(0.f);
    *reinterpret_cast<uint4*>(y + base) = out;
  } else {
    for (uint32_t i = base; i < n; ++i)
      y[i] = hash_keep(at(i), seed, threshold) ? from_f<T>(to_f(x[i]) * scale)
                                               : from_f<T>(0.f);
  }
}

template <typename T>
int launch(const void* x, void* y, uint32_t n, uint32_t seed, uint32_t threshold,
           float scale, ShardIndex at, cudaStream_t stream) {
  constexpr uint32_t VEC = 16 / sizeof(T);
  const uint32_t per_block = NTHREADS * VEC;
  const uint32_t blocks = (n + per_block - 1) / per_block;
  dropout_kernel<T><<<blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, seed, threshold, scale, at);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous, 16-byte aligned, n < 2^32 elements; is_bf16 selects the
// element type (else f32). origin, row_len, row_stride: where the shard's
// elements sit in the global index (origin 0 and row_stride == row_len for a
// whole tensor). Returns cudaGetLastError() after the launch.
extern "C" int hash_dropout(const void* x, void* y, uint32_t n, int is_bf16,
                            uint32_t seed, uint32_t threshold, float scale,
                            uint32_t origin, uint32_t row_len, uint32_t row_stride,
                            void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShardIndex at{origin, row_len, row_stride};
  return is_bf16 ? launch<__nv_bfloat16>(x, y, n, seed, threshold, scale, at, s)
                 : launch<float>(x, y, n, seed, threshold, scale, at, s);
}
