// Building blocks of the f32 attention kernels (flash_attention_fwd_f32.cu,
// flash_attention_bwd_f32.cu): products of f32 tiles on the tensor cores at
// f32 accuracy, tiles kept row-major in shared memory, loaded by cp.async.
//
// Precision: 3xTF32. One TF32 pass keeps 11 significant bits (~5e-4
// relative), which is not f32. Each operand x is split into big = tf32(x)
// and small = tf32(x - big), and a product is accumulated in f32 as
//   small_a big_b + big_a small_b + big_a big_b
// (the small terms first); the dropped small_a small_b is ~2^-22 of the
// product, and the split itself is exact to ~2^-22, so the sum is as close
// to the f32 product as an f32 FMA chain is. The products run on
// mma.sync.m16n8k8 (TF32): its fragments are loaded by each thread from
// shared memory with plain loads, so a product whose B operand is stored
// MN-major (P V, dS K, P^T dO, dS^T Q) needs no transpose in shared memory,
// which TF32 wgmma (K-major operands only) would.
//
// Fragment layouts of mma.m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, k x n): b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8, f32):  c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// A score tile in the C layout is the A operand of the next product with the
// contraction index permuted: logical k = t is key 2t and k = t + 4 is key
// 2t + 1, so a = (c0, c2, c1, c3) and B's rows are read at keys 2t, 2t + 1.
//
// Shared tiles are rows of D f32 padded to LD = D + 4 (D = 64, 96, 128:
// LD = 4 mod 32 words), so the 32 lanes of a fragment load (rows g or 2t,
// columns t or g) fall in 32 distinct banks.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace f32att {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B at f32 accuracy (3xTF32, the small terms first)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

// C[16 x N] += A[16 x D] B[N x D]^T: a warp's 16 rows of A (row stride LD)
// against N rows of B (row stride LD), both row-major in shared memory.
// Computes Q K^T, dO V^T, K Q^T and V dO^T.
template <int N, int D, int LD>
__device__ __forceinline__ void mma_nt(float (&c)[N / 8][4], const float* a, const float* b,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    const float* ar = a + g * LD + kk * 8 + t;
    uint32_t ab[4], as[4];
    split_tf32(ar[0], ab[0], as[0]);
    split_tf32(ar[8 * LD], ab[1], as[1]);
    split_tf32(ar[4], ab[2], as[2]);
    split_tf32(ar[8 * LD + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float* br = b + (n * 8 + g) * LD + kk * 8 + t;
      uint32_t bb[2], bs[2];
      split_tf32(br[0], bb[0], bs[0]);
      split_tf32(br[4], bb[1], bs[1]);
      mma3(c[n], ab, as, bb, bs);
    }
  }
}

// O[16 x D] += P[16 x K] B[K x D]: P a warp's tile in the C layout (K / 8
// blocks of 8 columns, from a product above), B row-major in shared memory
// (row stride LD). Computes P V, dS K, P^T dO and dS^T Q.
template <int K, int D, int LD>
__device__ __forceinline__ void mma_pn(float (&o)[D / 8][4], const float (&p)[K / 8][4],
                                       const float* b, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    uint32_t ab[4], as[4];
    split_tf32(p[ks][0], ab[0], as[0]);   // P[g][2t]
    split_tf32(p[ks][2], ab[1], as[1]);   // P[g + 8][2t]
    split_tf32(p[ks][1], ab[2], as[2]);   // P[g][2t + 1]
    split_tf32(p[ks][3], ab[3], as[3]);   // P[g + 8][2t + 1]
    const float* r0 = b + (ks * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bb[2], bs[2];
      split_tf32(r0[n * 8], bb[0], bs[0]);
      split_tf32(r0[LD + n * 8], bb[1], bs[1]);
      mma3(o[n], ab, as, bb, bs);
    }
  }
}

// cp.async rows [r0, r0 + ROWS) of a (rows, D) f32 matrix with row stride ss
// (elements) into shared rows of LD, zero-filling rows >= n_rows; 16 bytes
// a copy, NT threads.
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int ss, int r0,
                                          int n_rows) {
  constexpr int UNITS = D / 4;
  for (int c = threadIdx.x; c < ROWS * UNITS; c += NT) {
    const int r = c / UNITS, u = (c % UNITS) * 4;
    const bool ok = r0 + r < n_rows;
    hopper::cp_async_16(dst + r * LD + u, ok ? src + (size_t)(r0 + r) * ss + u : src, ok);
  }
}

// The first key tile at or after j (of BK keys, below n_tiles) that holds an
// attended key; n_tiles when none. Block-wide: every thread calls it alike
// (one barrier a tile looked at); threads < BK read a mask byte each.
template <int BK>
__device__ __forceinline__ int next_live(const uint8_t* mrow, int j, int n_tiles, int Sk) {
  if (mrow == nullptr) return j < n_tiles ? j : n_tiles;
  for (; j < n_tiles; ++j) {
    const int key = j * BK + static_cast<int>(threadIdx.x);
    const bool on = threadIdx.x < BK && key < Sk && mrow[key] != 0;
    if (__syncthreads_or(on)) return j;
  }
  return n_tiles;
}

__device__ __forceinline__ float quad_max(float x) {   // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace f32att
