// Building blocks of the f32 attention kernels on Hopper (sm_90a):
// flash_attention_fwd_f32.cu (K1 f32) and flash_attention_bwd_f32.cu (the
// f32 pair). TF32 wgmma at f32 accuracy, the pass that splits a landed f32
// tile into its TF32 halves in wgmma's layout, f32 tensor maps and the walk
// over the key tiles that hold an attended key; and, for head dims over
// 128, the wide route's column chunks on mma.sync (namespace wide, below).
//
// Precision: 3xTF32. One TF32 pass keeps 11 significant bits (~5e-4
// relative), which is not f32. Each operand x is split into big = x with
// its 13 low bits cleared and small = tf32(x - big) (cvt.rna), both exact
// TF32 values, so the tensor cores' handling of the bits TF32 drops (this
// card drops them: chip_smoke.py --f32-times) does not matter, and a
// product is accumulated in f32 as
//   small_a big_b + big_a small_b + big_a big_b
// (the small terms first); the dropped small_a small_b is under 2^-20 of
// the product (~2^-22 on average), and the split itself is exact to 2^-22,
// so the sum is as close to the f32 product as an f32 FMA chain is.
//
// Layout (KM: K-major, the 64-byte swizzle). A tile of R rows (wgmma's M or
// N index) and C f32 columns (its K index) is C / 16 chunks of 16 columns,
// chunk c at byte c * R * 64; in a chunk, row r at r * 64 and its 16-byte
// unit u at (u ^ ((r >> 1) & 3)) * 16. In bytes that is the bf16 kernels'
// layout (hopper_tile.cuh): a TF32 k-step of 8 columns is 32 bytes, as a
// bf16 k-step of 16 is, so k-step kk starts at chunk kk / 2, byte (kk % 2) *
// 32, with the descriptor desc_b64(p, 16, 512); and a TMA box of 16 f32
// columns x R rows with the 64-byte swizzle lands a raw tile in it. Every
// chunk base is 1024-byte aligned (R a multiple of 16).
//
// TF32 wgmma takes K-major operands only (the transpose bit exists for
// 16-bit types alone). An operand that a product contracts over its rows (V
// in P V, dO and Q in dV and dK, K in dQ) is stored transposed (T): its
// rows become the K index. Within each group of 8 rows the order is
// permuted, logical k = m (m < 4) holding row 2m and k = 4 + m row 2m + 1:
// the A operand from registers is then a score accumulator as it stands.
// An accumulator thread holds columns 2t and 2t + 1 of each 8-column block,
// and A's fragment wants k = t (registers 0, 1: rows g, g + 8) and k = t + 4
// (registers 2, 3), so a = (c0, c2, c1, c3) of block kk (a_operand).
//
// The split runs once a tile, for the whole block, in the kernels' transform
// warps: split_km for an operand read as it lands (in place for a tile that
// stays), split_t for one read transposed (and, with NATURAL, both ways from
// one read of the raw tile).
#pragma once
#include <cuda.h>            // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace f32att {

using hopper::smem_u32;

// named barriers of the f32 kernels (0 is __syncthreads)
constexpr int XF_BAR = 1;        // the transform warps
constexpr int COMBINE_BAR = 2;   // the consumer warpgroups, at the end

__device__ __forceinline__ uint32_t to_tf32(float x) {   // round to nearest, ties away
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32, as f32 bit patterns: big is x with its 13 low
// bits cleared, small the rest rounded (|small| < 2^-10 |x|, its rounding
// error under 2^-22 |x|)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float4& x, float4& big, float4& small) {
  uint32_t b, s;
  split_tf32(x.x, b, s); big.x = __uint_as_float(b); small.x = __uint_as_float(s);
  split_tf32(x.y, b, s); big.y = __uint_as_float(b); small.y = __uint_as_float(s);
  split_tf32(x.z, b, s); big.z = __uint_as_float(b); small.z = __uint_as_float(s);
  split_tf32(x.w, b, s); big.w = __uint_as_float(b); small.w = __uint_as_float(s);
}

// The A operand of k-step kk (8 keys) from an accumulator tile x (x[4j + e]:
// row g + 8 (e / 2), column 8j + 2t + (e % 2)), split: big and small.
template <int N>
__device__ __forceinline__ void a_operand(const float (&x)[N], int kk, uint32_t (&big)[4],
                                          uint32_t (&small)[4]) {
  split_tf32(x[4 * kk], big[0], small[0]);       // row g, column 2t: k = t
  split_tf32(x[4 * kk + 2], big[1], small[1]);   // row g + 8, column 2t
  split_tf32(x[4 * kk + 1], big[2], small[2]);   // row g, column 2t + 1: k = t + 4
  split_tf32(x[4 * kk + 3], big[3], small[3]);
}

// byte offset of 16-byte unit u (along the K index) of row r in a KM tile
// of `rows` rows
__device__ __forceinline__ uint32_t km_off(int rows, int r, int u) {
  return (uint32_t)((u >> 2) * rows * 64 + r * 64 + (((u & 3) ^ ((r >> 1) & 3)) << 4));
}

// descriptor of k-step kk of a KM tile of `rows` rows at p
__device__ __forceinline__ uint64_t km_desc(const unsigned char* p, int rows, int kk) {
  return hopper::desc_b64(p + (kk >> 1) * rows * 64 + (kk & 1) * 32, 16, 512);
}

// the same descriptor from the k-step's shared address (hopper::desc_b64's
// fields: address / 16, LBO 16 and SBO 512 bytes, the 64-byte swizzle)
__device__ __forceinline__ uint64_t km_desc_at(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (uint64_t)(16 >> 4) << 16 |
         (uint64_t)(512 >> 4) << 32 | (uint64_t)2 << 62;
}

// A raw KM tile (ROWS x D) into its halves at the same offsets (big or
// small may be src: in place; BIG false writes the small half only); NT
// threads, tid in [0, NT). Each thread reads its 16-byte units (up to 8 at
// once) before it writes any.
template <int ROWS, int D, int NT, bool BIG = true>
__device__ __forceinline__ void split_km(const unsigned char* src, unsigned char* big,
                                         unsigned char* small, int tid) {
  constexpr int N = ROWS * D / 4, ITER = (N + NT - 1) / NT, CH = ITER < 8 ? ITER : 8;
#pragma unroll
  for (int j0 = 0; j0 < ITER; j0 += CH) {
    float4 x[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = tid + (j0 + c) * NT;
      if (j0 + c < ITER && (N % NT == 0 || i < N))
        x[c] = *reinterpret_cast<const float4*>(src + 16 * i);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = tid + (j0 + c) * NT;
      if (j0 + c < ITER && (N % NT == 0 || i < N)) {
        float4 b, s;
        split4(x[c], b, s);
        if constexpr (BIG) *reinterpret_cast<float4*>(big + 16 * i) = b;
        *reinterpret_cast<float4*>(small + 16 * i) = s;
      }
    }
  }
}

template <int J>
__device__ __forceinline__ float comp(const float4& v) {
  return J == 0 ? v.x : J == 1 ? v.y : J == 2 ? v.z : v.w;
}

template <int J>
__device__ __forceinline__ void store_column(const float4 (&x)[4], unsigned char* tb,
                                             unsigned char* ts, uint32_t off) {
  const float4 c = make_float4(comp<J>(x[0]), comp<J>(x[1]), comp<J>(x[2]), comp<J>(x[3]));
  float4 b, s;
  split4(c, b, s);
  *reinterpret_cast<float4*>(tb + off) = b;
  *reinterpret_cast<float4*>(ts + off) = s;
}

// A raw KM tile (ROWS x D: rows are keys or queries) into the halves of its
// transpose tb, ts (KM tiles of D rows, K index = the ROWS, permuted in
// groups of 8) and, when NATURAL, into its own halves nb, ns at raw's
// offsets. An item is 4 rows 2m + par (m < 4) of a group of 8 by 4 columns:
// four 16-byte reads (bank groups (par, e ^ m) across a quarter warp: no
// conflict) and, per column, one 16-byte unit of the transpose a half
// (two-way conflicts). A thread reads its items (up to 2 at once) before
// it writes any.
template <int ROWS, int D, int NT, bool NATURAL>
__device__ __forceinline__ void split_t(const unsigned char* raw, unsigned char* tb,
                                        unsigned char* ts, unsigned char* nb,
                                        unsigned char* ns, int tid) {
  constexpr int UNITS = D / 4;                       // 16-byte units of a row
  constexpr int N = (ROWS / 8) * 2 * UNITS, ITER = (N + NT - 1) / NT;
  constexpr int CH = ITER < 2 ? ITER : 2;
#pragma unroll
  for (int j0 = 0; j0 < ITER; j0 += CH) {
    float4 x[CH][4];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int it = tid + (j0 + c) * NT;
      const int par = it & 1, e = (it >> 1) % UNITS, g8 = (it >> 1) / UNITS;
      if (j0 + c < ITER && (N % NT == 0 || it < N)) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          x[c][m] = *reinterpret_cast<const float4*>(raw + km_off(ROWS, 8 * g8 + 2 * m + par, e));
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int it = tid + (j0 + c) * NT;
      const int par = it & 1, e = (it >> 1) % UNITS, g8 = (it >> 1) / UNITS;
      if (j0 + c < ITER && (N % NT == 0 || it < N)) {
        if constexpr (NATURAL) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const uint32_t off = km_off(ROWS, 8 * g8 + 2 * m + par, e);
            float4 b, s;
            split4(x[c][m], b, s);
            *reinterpret_cast<float4*>(nb + off) = b;
            *reinterpret_cast<float4*>(ns + off) = s;
          }
        }
        const int u = 2 * g8 + par;                  // logical rows 4 par .. + 3 of group g8
        store_column<0>(x[c], tb, ts, km_off(D, 4 * e, u));
        store_column<1>(x[c], tb, ts, km_off(D, 4 * e + 1, u));
        store_column<2>(x[c], tb, ts, km_off(D, 4 * e + 2, u));
        store_column<3>(x[c], tb, ts, km_off(D, 4 * e + 3, u));
      }
    }
  }
}

// ---- TF32 wgmma (m64nNk8, f32 accumulators) ---------------------------------
// D (64 x N) += A (64 x 8) * B (8 x N), A and B from KM tiles
// (wgmma_tf32_ss) or A from registers (wgmma_tf32_rs: the fragment of
// mma.sync.m16n8k8's A per warp, a0 = (g, t), a1 = (g + 8, t), a2 = (g, t +
// 4), a3 = (g + 8, t + 4)). The accumulator layout is the bf16 wgmma's
// (hopper_tile.cuh). The overload is picked by the accumulator's size, N / 2
// f32 a thread.

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// ---- the walk over live tiles ----------------------------------------------------

// The tiles of BK keys below n_tiles that hold an attended key, in order, for
// the warp that walks them (every tile when there is no mask). Warp-wide:
// lane l looks at tile w + l of a window of 32.
template <int BK>
struct TileWalk {
  const uint8_t* mrow;                      // the batch row's mask, or null
  int Sk, n_tiles;
  int w;                                    // first tile of the window held
  uint32_t bits;                            // its live tiles not yet walked

  __device__ TileWalk(const uint8_t* m, int sk, int n)
      : mrow(m), Sk(sk), n_tiles(n), w(-32), bits(0) {}

  __device__ uint32_t window(int w0, int lane) const {
    const int j = w0 + lane;
    bool live = j < n_tiles && mrow == nullptr;
    if (j < n_tiles && mrow != nullptr) {
      const int k0 = j * BK, k1 = min(Sk, k0 + BK);
      if (k1 - k0 == BK && (reinterpret_cast<uintptr_t>(mrow + k0) & 3u) == 0) {
        for (int k = k0; k < k1; k += 4)
          live |= *reinterpret_cast<const uint32_t*>(mrow + k) != 0;
      } else {
        for (int k = k0; k < k1; ++k) live |= mrow[k] != 0;
      }
    }
    return __ballot_sync(0xffffffffu, live);
  }

  __device__ int count(int lane) const {
    int n = 0;
    for (int w0 = 0; w0 < n_tiles; w0 += 32) n += __popc(window(w0, lane));
    return n;
  }

  // the next live tile, or -1 after the last
  __device__ int next(int lane) {
    while (bits == 0) {
      w += 32;
      if (w >= n_tiles) return -1;
      bits = window(w, lane);
    }
    const int j = w + __ffs(bits) - 1;
    bits &= bits - 1;
    return j;
  }
};

// Bit i of word u: key k0 + 32u + i (of a tile of BK) is below Sk and
// attended. Warp-wide.
template <int BK>
__device__ __forceinline__ void tile_bits(uint32_t (&kb)[(BK + 31) / 32], const uint8_t* mrow,
                                          int k0, int Sk, int lane) {
#pragma unroll
  for (int u = 0; u < (BK + 31) / 32; ++u) {
    const int key = k0 + 32 * u + lane;
    kb[u] = __ballot_sync(0xffffffffu, 32 * u + lane < BK && key < Sk &&
                                           (mrow == nullptr || mrow[key] != 0));
  }
}

// whether key column c (< BK) of a tile is attended, by its tile_bits
__device__ __forceinline__ bool key_on(const uint32_t* kb, int c) {
  return (kb[c >> 5] >> (c & 31)) & 1u;
}

__device__ __forceinline__ float quad_max(float x) {   // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <class T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {   // 1024-byte aligned
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

// ---- host: f32 tensor maps ------------------------------------------------------
// A rank-4 (D, S, H, B) f32 map of a tensor with element strides (sb, sh,
// ss) and a contiguous last dim, read in boxes of 16 columns x box_rows rows
// with the 64-byte swizzle (a KM tile's chunk); rows past S read as zeros.
// Returns 0 or a cudaError_t (a stride that is not a multiple of 16 bytes, a
// base that is not 16-byte aligned, or the driver refusing the map).
inline int make_f32_map(CUtensorMap* map, const void* base, int B, int H, int S, int D,
                        long long sb, long long sh, long long ss, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {      // the driver's entry point: the .so needs no -lcuda
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  const long long el = 4;
  if (reinterpret_cast<uintptr_t>(base) % 16 || (ss * el) % 16 || (sh * el) % 16 ||
      (sb * el) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * el), (cuuint64_t)(sh * el),
                                 (cuuint64_t)(sb * el)};
  const cuuint32_t box[4] = {16, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                              const_cast<void*>(base), dims, strides, box, estr,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The TMA loads of a KM tile of `rows` rows x D columns at (row r0, h, b)
// into dst: D / 16 boxes, completing on bar (one thread).
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int r0, int h, int b) {
#pragma unroll
  for (int ch = 0; ch < D / 16; ++ch)
    hopper::tma_load_4d(dst + ch * rows * 64, map, bar, ch * 16, r0, h, b);
}

// ---- the wide route: head dims over 128, in column chunks ------------------------
// The f32 K1 and pair past head dim 128 (flash_f32_*_wide_kernel). A head
// dim D there is a multiple of the chunk CW = 64 columns, and every operand
// is read through shared memory one chunk at a time: a block owns one
// output chunk of 64 rows and walks the other operand's 64-row tiles; per
// tile it sums each score product over D chunk by chunk, then applies it to
// its own chunk of V, dO, Q or K. Tiles are row-major chunks of 64 rows x
// CW f32, rows padded to LD = CW + 4 (so the 32 lanes of a fragment load,
// rows g or 2t, columns t or g, fall in 32 distinct banks), loaded by
// cp.async. Products run on mma.sync.m16n8k8 in 3xTF32: its fragments are
// loaded by each thread with plain loads, so a B operand stored MN-major
// (V, dO, Q, K in P V, P^T dO, dS^T Q, dS K) needs no transpose in shared
// memory, which TF32 wgmma (K-major operands only) would.
//
// Fragment layouts of mma.m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, k x n): b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8, f32):  c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// A score tile in the C layout is the A operand of the next product with the
// contraction index permuted: logical k = t is column 2t and k = t + 4 is
// column 2t + 1, so a = (c0, c2, c1, c3) and B's rows are read at 2t, 2t + 1.
namespace wide {

constexpr int CW = 64;            // columns of a chunk
constexpr int LD = CW + 4;        // a chunk row in shared memory, f32
constexpr int ROWS = 64;          // rows of every tile: 4 warps of 16
constexpr int NT = 128;
constexpr int TILE = ROWS * LD;   // f32 of a tile

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

// C[16 x N] += A[16 x CW] B[N x CW]^T: a warp's 16 rows of A against N rows
// of B, both chunk tiles (row stride LD). Q K^T, dO V^T, K Q^T, V dO^T.
template <int N>
__device__ __forceinline__ void mma_nt(float (&c)[N / 8][4], const float* a, const float* b,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kk = 0; kk < CW / 8; ++kk) {   // not unrolled: as mma_pn's steps
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

// O[16 x CW] += P[16 x K] B[K x CW]: P a warp's tile in the C layout (K / 8
// blocks of 8 columns, from mma_nt), B a chunk tile (row stride LD). P V,
// dS K, P^T dO, dS^T Q. The steps are not unrolled (unrolled, ptxas loads
// every step's B ahead and spills past 255 registers), so each takes P's
// block 0 and shifts the rest down: a register array is never indexed at
// run time.
template <int K>
__device__ __forceinline__ void mma_pn(float (&o)[CW / 8][4], const float (&p)[K / 8][4],
                                       const float* b, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float x[K / 8][4];
#pragma unroll
  for (int i = 0; i < K / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = p[i][e];
#pragma unroll 1
  for (int ks = 0; ks < K / 8; ++ks) {
    uint32_t ab[4], as[4];
    split_tf32(x[0][0], ab[0], as[0]);   // P[g][2t]
    split_tf32(x[0][2], ab[1], as[1]);   // P[g + 8][2t]
    split_tf32(x[0][1], ab[2], as[2]);   // P[g][2t + 1]
    split_tf32(x[0][3], ab[3], as[3]);   // P[g + 8][2t + 1]
#pragma unroll
    for (int i = 0; i + 1 < K / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][e] = x[i + 1][e];
    const float* r0 = b + (ks * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      uint32_t bb[2], bs[2];
      split_tf32(r0[n * 8], bb[0], bs[0]);
      split_tf32(r0[LD + n * 8], bb[1], bs[1]);
      mma3(o[n], ab, as, bb, bs);
    }
  }
}

// cp.async rows [r0, r0 + R) of one chunk (CW f32 from src, a row's first
// column of it) of a matrix with row stride ss (elements) into a chunk tile
// of R rows, zero-filling rows >= n_rows; 16 bytes a copy, all NT threads.
template <int R = ROWS>
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int ss, int r0,
                                           int n_rows) {
  constexpr int UNITS = CW / 4;
#pragma unroll 4
  for (int c = threadIdx.x; c < R * UNITS; c += NT) {
    const int r = c / UNITS, u = (c % UNITS) * 4;
    const bool ok = r0 + r < n_rows;
    hopper::cp_async_16(dst + r * LD + u, ok ? src + (size_t)(r0 + r) * ss + u : src, ok);
  }
}

// The first tile at or after j (of R keys, below n_tiles) that holds an
// attended key; n_tiles when none. Block-wide: every thread calls it alike
// (one barrier a tile looked at); threads < R read a mask byte each.
template <int R = ROWS>
__device__ __forceinline__ int next_live(const uint8_t* mrow, int j, int n_tiles, int Sk) {
  if (mrow == nullptr) return j < n_tiles ? j : n_tiles;
  for (; j < n_tiles; ++j) {
    const int key = j * R + static_cast<int>(threadIdx.x);
    const bool on = threadIdx.x < R && key < Sk && mrow[key] != 0;
    if (__syncthreads_or(on)) return j;
  }
  return n_tiles;
}

}  // namespace wide

}  // namespace f32att
