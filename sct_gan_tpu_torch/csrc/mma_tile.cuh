// Helpers shared by the flash-attention kernels: the bf16 mma.sync tile
// product and bf16 packing.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n):      b0 = B[2t..2t+1][g],  b1 = B[2t+8..2t+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// The C layout of one product is the A layout of the next, so a score tile
// becomes a matrix-product operand without touching shared memory.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 (the low one first) as one 32-bit operand register
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
