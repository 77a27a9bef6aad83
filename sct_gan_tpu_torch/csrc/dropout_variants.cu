// Variants of the dropout draw for Hopper (sm_90a), bf16 in and out, to
// price the random draw of the dropout kernel (K6) against a copy.
//
// Replaces the TPU kernel of tools/time_dropout_kernel.py (its pallas_call at
// :76). Over an (N, C) tensor x at rate r, with scale = 1/(1-r) rounded to
// bf16 (the host passes it):
//
//   copy   y = x * c, c = 1.0001 rounded to bf16 (so 1): read and write only
//   drop   y = keep ? x * scale : 0 with one 32-bit draw per element, the
//          hash of the flat index r*C + c: K6's formula (dropout.cu)
//   byte4  one draw per 4 elements: element (r, c) takes byte c / (C/4) of
//          word (r, c % (C/4)) and is kept iff that byte >= int(r * 256)
//   half2  one draw per 2 elements: element (r, c) takes half c / (C/2) of
//          word (r, c % (C/2)), kept iff >= int(r * 65536)
//
// byte4 and half2 compute y = x * (keep ? scale : 0) as the TPU tool does,
// so a dropped negative x gives -0. The TPU tool drew its words from the
// TPU's own PRNG, which no other device has. A word here is the JAX
// package's murmur3 hash (hash_dropout.cuh) of its flat word index
// (r * C/4 + w, or r * C/2 + w) plus the seed, which the plain version and
// the JAX package reproduce bit for bit.
//
// What bounds it on an H100: one read and one write of every element; at
// (8192, 768) that is 25.2 MB, 0.0075 ms at 3.35 TB/s. A draw is about 10
// integer operations.
//
// Design: every mode has the same grid and the same loads and stores. A
// thread owns word columns w .. w+7 (w a multiple of 8 below C/4) of one row
// and, for each, the four elements c = q*C/4 + w + i, q = 0..3: four 16-byte
// loads and four stores, each coalesced across the warp. drop draws 32 words
// a thread, half2 16 (words w + i and C/4 + w + i), byte4 8, copy none.
// C must be a multiple of 32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"

namespace {

constexpr int NTHREADS = 256;

enum Mode { COPY = 0, DROP = 1, BYTE4 = 2, HALF2 = 3 };

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
dropout_variants_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                        int N, int C, uint32_t seed, uint32_t threshold, float scale) {
  const int Q = C / 4;                       // quarter width, a multiple of 8
  const int per_row = Q / 8;
  const int tid = blockIdx.x * NTHREADS + threadIdx.x;
  if (tid >= N * per_row) return;
  const int r = tid / per_row, w = (tid % per_row) * 8;
  const size_t row = (size_t)r * C;

  uint4 buf[4];
#pragma unroll
  for (int qq = 0; qq < 4; ++qq)
    buf[qq] = *reinterpret_cast<const uint4*>(x + row + qq * Q + w);

  uint32_t word[2][8];                       // byte4: word[0]; half2: both
  if (MODE == BYTE4 || MODE == HALF2) {
    const uint32_t wrow = (uint32_t)r * (uint32_t)(MODE == BYTE4 ? Q : 2 * Q);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      word[0][i] = hash_bits(wrow + w + i, seed);
      if (MODE == HALF2) word[1][i] = hash_bits(wrow + Q + w + i, seed);
    }
  }
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) {
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&buf[qq]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xv = __bfloat162float(e[i]);
      float yv;
      if (MODE == COPY) {
        yv = xv * scale;
      } else if (MODE == DROP) {
        const uint32_t idx = (uint32_t)(row + qq * Q + w + i);
        yv = hash_bits(idx, seed) >= threshold ? xv * scale : 0.f;
      } else if (MODE == BYTE4) {
        const uint32_t b = (word[0][i] >> (8 * qq)) & 0xFFu;
        yv = xv * (b >= threshold ? scale : 0.f);
      } else {                               // quarters 0, 1 in half 0; 2, 3 in half 1
        const uint32_t hw = (word[qq & 1][i] >> (16 * (qq >> 1))) & 0xFFFFu;
        yv = xv * (hw >= threshold ? scale : 0.f);
      }
      e[i] = __float2bfloat16(yv);
    }
    *reinterpret_cast<uint4*>(y + row + qq * Q + w) = buf[qq];
  }
}

template <int MODE>
int launch(const void* x, void* y, int N, int C, uint32_t seed, uint32_t threshold,
           float scale, cudaStream_t stream) {
  const int threads = N * (C / 32);
  dropout_variants_kernel<MODE><<<(threads + NTHREADS - 1) / NTHREADS, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), N, C, seed,
      threshold, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous bf16 (N, C), 16-byte aligned, C a multiple of 32,
// N*C < 2^31; mode 0 copy, 1 drop, 2 byte4, 3 half2; threshold is the keep
// threshold of the mode's draw width (32, 8 or 16 bits); scale the bf16
// multiplier of a kept element (copy: the constant). Returns
// cudaGetLastError() after the launch.
extern "C" int dropout_variants_bf16(const void* x, void* y, int N, int C, int mode,
                                     uint32_t seed, uint32_t threshold, float scale,
                                     void* stream) {
  if (N <= 0 || C <= 0 || C % 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case COPY: return launch<COPY>(x, y, N, C, seed, threshold, scale, s);
    case DROP: return launch<DROP>(x, y, N, C, seed, threshold, scale, s);
    case BYTE4: return launch<BYTE4>(x, y, N, C, seed, threshold, scale, s);
    case HALF2: return launch<HALF2>(x, y, N, C, seed, threshold, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
