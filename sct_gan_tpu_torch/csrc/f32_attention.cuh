// Building blocks of the f32 attention kernels on Hopper (sm_90a):
// flash_attention_fwd_f32.cu (K1 f32) and flash_attention_bwd_f32.cu (the
// f32 pair). TF32 wgmma at f32 accuracy, the pass that splits a landed f32
// tile into its TF32 halves in wgmma's layout, f32 tensor maps and the walk
// over the key tiles that hold an attended key; and, for head dims over
// 128, the wide route's ring of 64-column units (namespace wide, below).
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

// ---- the wide route: head dims over 128, in column groups -------------------------
// The f32 K1 and pair past head dim 128 (flash_f32_*_group_kernel,
// flash_f32_dq_split_kernel). A head dim D there is a multiple of CW = 64
// columns. A block owns 64 rows (query or key rows) and a group of DG
// output columns (the whole head dim where the registers allow: groups,
// group_width); it walks the other side's 64-row tiles and computes each
// score tile once, over the whole head dim, in 64-column k-chunks. Every
// operand reaches shared memory as a unit: one 64-row x 64-column chunk of
// one tensor, landed by TMA (four boxes of 16 columns, the KM layout above)
// in a ring of stages (Ring: warp 0 of the transform warpgroup loads,
// warps 1-3 split), and split once: as landed (split_nat: the landed chunk
// is its big half, its small half goes beside it) or transposed
// (split_t_in_place: the big half of the transpose over the landed chunk).
// The split rounds by integer arithmetic (split_int), with cvt.rna's bits.
// Every product is a 64 x 64 x 64 step of 3xTF32 m64n64k8 wgmma (prod3,
// prod3_rs): a score step reads two landed units, a gradient or output
// step P or dS (from registers, a_frags, or stored once by the consumer,
// store_a) and one transposed unit.
namespace wide {

using hopper::bar_sync;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;

constexpr int CW = 64;                     // columns of a chunk; rows of every tile
constexpr int HALF = CW * CW * 4;          // bytes of one f32 half of a unit
constexpr int STAGE = 2 * HALF;            // a unit: big (the chunk lands there), small

// split_tf32 in four integer and float operations: small rounded to TF32
// by adding half a unit of its last place to its bits and clearing the 13
// low ones (round to nearest, ties away from zero: cvt.rna's bits for any
// finite x, without the conversion unit the split would queue on).
__device__ __forceinline__ void split_int(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split4_int(const float4& x, float4& big, float4& small) {
  uint32_t b, s;
  split_int(x.x, b, s); big.x = __uint_as_float(b); small.x = __uint_as_float(s);
  split_int(x.y, b, s); big.y = __uint_as_float(b); small.y = __uint_as_float(s);
  split_int(x.z, b, s); big.z = __uint_as_float(b); small.z = __uint_as_float(s);
  split_int(x.w, b, s); big.w = __uint_as_float(b); small.w = __uint_as_float(s);
}

// The small half of a landed chunk (raw) as it lies, at `small`; the raw
// chunk serves as its big half: TF32 wgmma reads an f32 operand with its
// 13 low bits dropped (tf32_probe_kernel; chip_smoke.py holds the card to
// it), which is split_int's big, so the products' bits are those of a big
// half written out. NT threads, tid in [0, NT); each reads its 16-byte
// units (up to 8 at once) before it writes them.
template <int NT>
__device__ __forceinline__ void split_nat(const unsigned char* raw, unsigned char* small,
                                          int tid) {
  constexpr int N = CW * CW / 4, ITER = (N + NT - 1) / NT, CH = ITER < 8 ? ITER : 8;
#pragma unroll
  for (int j0 = 0; j0 < ITER; j0 += CH) {
    float4 x[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = tid + (j0 + c) * NT;
      if (j0 + c < ITER && (N % NT == 0 || i < N))
        x[c] = *reinterpret_cast<const float4*>(raw + 16 * i);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = tid + (j0 + c) * NT;
      if (j0 + c < ITER && (N % NT == 0 || i < N)) {
        float4 b, sm;                          // b: what the raw chunk already is
        split4_int(x[c], b, sm);
        *reinterpret_cast<float4*>(small + 16 * i) = sm;
      }
    }
  }
}

template <int J>
__device__ __forceinline__ void store_column_int(const float4 (&x)[4], unsigned char* tb,
                                                 unsigned char* ts, uint32_t off) {
  const float4 c = make_float4(comp<J>(x[0]), comp<J>(x[1]), comp<J>(x[2]), comp<J>(x[3]));
  float4 b, sm;
  split4_int(c, b, sm);
  *reinterpret_cast<float4*>(tb + off) = b;
  *reinterpret_cast<float4*>(ts + off) = sm;
}

// A landed chunk (64 x 64: rows are keys or queries) into the halves of its
// transpose (KM tiles of 64 rows = the chunk's columns, K index = its rows,
// permuted in groups of 8 as split_t's): big over the raw chunk, small at
// `small`. NT threads, tid in [0, NT): each reads all its items (split_t's:
// four rows 2m + par of a group of 8 by four columns), the NT meet at named
// barrier `bar`, then each writes them.
template <int NT>
__device__ __forceinline__ void split_t_in_place(unsigned char* raw, unsigned char* small,
                                                 int tid, int bar) {
  constexpr int UNITS = CW / 4, N = (CW / 8) * 2 * UNITS, ITER = (N + NT - 1) / NT;
  float4 x[ITER][4];
#pragma unroll
  for (int j = 0; j < ITER; ++j) {
    const int it = tid + j * NT;
    const int par = it & 1, e = (it >> 1) % UNITS, g8 = (it >> 1) / UNITS;
    if (N % NT == 0 || it < N) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        x[j][m] = *reinterpret_cast<const float4*>(raw + km_off(CW, 8 * g8 + 2 * m + par, e));
    }
  }
  bar_sync(bar, NT);
#pragma unroll
  for (int j = 0; j < ITER; ++j) {
    const int it = tid + j * NT;
    const int par = it & 1, e = (it >> 1) % UNITS, g8 = (it >> 1) / UNITS;
    if (N % NT == 0 || it < N) {
      const int u = 2 * g8 + par;                    // logical rows 4 par .. + 3 of group g8
      store_column_int<0>(x[j], raw, small, km_off(CW, 4 * e, u));
      store_column_int<1>(x[j], raw, small, km_off(CW, 4 * e + 1, u));
      store_column_int<2>(x[j], raw, small, km_off(CW, 4 * e + 2, u));
      store_column_int<3>(x[j], raw, small, km_off(CW, 4 * e + 3, u));
    }
  }
}

// A ring of STAGES units: full (the TMA's bytes), ready (split: one
// arrival a split warp), empty (released: one arrival a consumer warp).
// Unit u sits in stage u % STAGES, in its (u / STAGES)-th use.
template <int STAGES>
struct Ring {
  static constexpr int SPLIT_WARPS = 3;      // warps 1-3 of the transform warpgroup
  alignas(1024) unsigned char stage[STAGES][STAGE];
  int tile[STAGES];                        // first row of the walked tile (its first unit)
  uint32_t bits[STAGES][2];                // its keys' tile_bits (key walks)
  uint64_t full[STAGES], ready[STAGES], empty[STAGES];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&ready[i], SPLIT_WARPS);
      mbar_init(&empty[i], 4);
    }
  }
  __device__ static int slot(int u) { return u % STAGES; }
  __device__ static uint32_t parity(int u) { return (u / STAGES) & 1; }
  // the consumer: unit u's stage once it is split
  __device__ unsigned char* wait(int u) {
    mbar_wait(&ready[slot(u)], parity(u));
    return stage[slot(u)];
  }
  // the consumer warp, once the products reading unit u are complete
  __device__ void release(int u, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot(u)]);
  }
  // the loading warp: unit u's stage once it is free, then lane 0 notes the
  // walked tile's first row and key bits (a tile's first unit, row0 >= 0)
  // and issues the unit's four boxes (columns col .. col + 63, rows row ..
  // row + 63)
  __device__ void load(int u, const CUtensorMap* map, int col, int row, int h, int b, int lane,
                       int row0 = -1, uint32_t kb0 = 0u, uint32_t kb1 = 0u) {
    const int st = slot(u);
    mbar_wait(&empty[st], parity(u) ^ 1);
    if (lane == 0) {
      if (row0 >= 0) {
        tile[st] = row0;
        bits[st][0] = kb0;
        bits[st][1] = kb1;
      }
      mbar_arrive_expect_tx(&full[st], HALF);
#pragma unroll
      for (int i = 0; i < CW / 16; ++i)
        hopper::tma_load_4d(stage[st] + i * CW * 64, map, &full[st], col + 16 * i, row, h, b);
    }
  }
  // The transform warpgroup (tid in [0, 128)) over the walk's `total`
  // units: warp 0 loads them in turn (issue(v, lane) calls load(), which
  // waits for the stage), warps 1-3 split each once it lands (transposed
  // where trans(u), else as it lies). Each split thread makes its writes
  // visible to wgmma, then one lane a warp arrives on ready.
  template <class Issue, class Trans>
  __device__ void feed(int total, int tid, Issue issue, Trans trans) {
    constexpr int NX = 32 * SPLIT_WARPS;
    const int warp = tid / 32, lane = tid % 32;
    if (warp == 0) {
      for (int v = 0; v < total; ++v) issue(v, lane);
      return;
    }
    for (int u = 0; u < total; ++u) {
      mbar_wait(&full[slot(u)], parity(u));
      unsigned char* st = stage[slot(u)];
      if (trans(u))
        split_t_in_place<NX>(st, st + HALF, tid - 32, XF_BAR);
      else
        split_nat<NX>(st, st + HALF, tid - 32);
      hopper::fence_proxy_async();           // the halves are read by wgmma
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[slot(u)]);
    }
  }
};

// A 64 x 64 accumulator tile x (x[4j + e]: row 16 warp + g + 8 (e >> 1),
// column 8j + 2t + (e & 1)) into KM halves of 64 rows whose K index is its
// columns, permuted in groups of 8 as split_t's (column 2m + par at k = 4
// par + m): the A operand of a product over them against a transposed
// unit. Every store of a warp hits 32 banks.
__device__ __forceinline__ void store_a(const float (&x)[32], unsigned char* big,
                                        unsigned char* small, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + 8 * (e >> 1), k = 8 * j + 4 * (e & 1) + t;
      const uint32_t off = km_off(CW, row, k >> 2) + (k & 3) * 4;
      uint32_t b, sm;
      split_int(x[4 * j + e], b, sm);
      *reinterpret_cast<uint32_t*>(big + off) = b;
      *reinterpret_cast<uint32_t*>(small + off) = sm;
    }
}

// byte offset of k-step kk in a KM unit
__host__ __device__ constexpr uint32_t kstep(int kk) {
  return (kk >> 1) * CW * 64 + (kk & 1) * 32;
}

// The descriptor (km_desc_at's fields) of shared address %a, built in the
// asm block of the wgmma that reads it: ptxas keeps no 64-bit descriptor
// live beside the accumulators (made ahead of a step's 24 wgmma they cost
// ~50 registers).
#define WIDE_DESC(d, a)                                 \
  "shr.b32 " #d "lo, " a ", 4;\n"                      \
  "and.b32 " #d "lo, " #d "lo, 16383;\n"               \
  "or.b32 " #d "lo, " #d "lo, 65536;\n"                \
  "mov.b64 " #d ", {" #d "lo, hi};\n"

// D (64 x 64) += A (64 x 8) B (8 x 64): A and B k-steps of KM tiles at
// shared addresses a and b
__device__ __forceinline__ void wgmma_ss_at(float (&d)[32], uint32_t a, uint32_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      ".reg .b32 dalo, dblo, hi;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "mov.b32 hi, 0x80000020;\n"                // SBO 512 bytes, the 64-byte swizzle
      WIDE_DESC(da, "%32") WIDE_DESC(db, "%33")
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a), "r"(b), "n"(1));
}

// the same with A from registers (wgmma_tf32_rs's fragment)
__device__ __forceinline__ void wgmma_rs_at(float (&d)[32], const uint32_t (&a)[4], uint32_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      ".reg .b32 dblo, hi;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "mov.b32 hi, 0x80000020;\n"
      WIDE_DESC(db, "%36")
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "n"(1));
}
#undef WIDE_DESC

// acc (64 x 64) += A B^T over 64 columns in 3xTF32 (the small terms first):
// A and B KM units of 64 rows, each as its big and small halves' shared
// addresses; issues 24 m64n64k8 wgmma, no commit. The addresses pass an
// empty asm, so the compiler cannot hoist a loop-invariant operand's
// addresses out of the walk.
__device__ __forceinline__ void prod3(float (&acc)[32], uint32_t ab, uint32_t as, uint32_t bb,
                                      uint32_t bs) {
  asm volatile("" : "+r"(ab), "+r"(as), "+r"(bb), "+r"(bs));
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk) wgmma_ss_at(acc, as + kstep(kk), bb + kstep(kk));
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk) wgmma_ss_at(acc, ab + kstep(kk), bs + kstep(kk));
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk) wgmma_ss_at(acc, ab + kstep(kk), bb + kstep(kk));
}

// acc += A B^T with A's halves from registers (a_frag: k-step kk's
// fragment of each) and B a KM unit (its big and small halves' addresses)
__device__ __forceinline__ void prod3_rs(float (&acc)[32], const uint32_t (&ab)[8][4],
                                         const uint32_t (&as)[8][4], uint32_t bb, uint32_t bs) {
  asm volatile("" : "+r"(bb), "+r"(bs));
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk) wgmma_rs_at(acc, as[kk], bb + kstep(kk));
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk) wgmma_rs_at(acc, ab[kk], bs + kstep(kk));
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk) wgmma_rs_at(acc, ab[kk], bb + kstep(kk));
}

// The A fragments (wgmma_tf32_rs's) of a 64 x 64 accumulator tile x split
// into its halves, k-step kk of the permuted order (a_operand's)
__device__ __forceinline__ void a_frags(const float (&x)[32], uint32_t (&ab)[8][4],
                                        uint32_t (&as)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    split_int(x[4 * kk], ab[kk][0], as[kk][0]);       // row g, column 2t: k = t
    split_int(x[4 * kk + 2], ab[kk][1], as[kk][1]);   // row g + 8
    split_int(x[4 * kk + 1], ab[kk][2], as[kk][2]);   // row g, column 2t + 1: k = t + 4
    split_int(x[4 * kk + 3], ab[kk][3], as[kk][3]);
  }
}

// prod3 on two landed units (big at the stage, small HALF after it)
__device__ __forceinline__ void prod3_units(float (&acc)[32], const unsigned char* a,
                                            const unsigned char* b) {
  const uint32_t pa = smem_u32(a), pb = smem_u32(b);
  prod3(acc, pa, pa + HALF, pb, pb + HALF);
}

// This thread's index in its warpgroup and the block's grid coordinates,
// read where they are used (volatile reads are not hoisted): in the
// kernels of 384 threads (168 registers a thread) such values held across
// the walk beside the accumulators spilled.
__device__ __forceinline__ int wg_thread() {
  uint32_t x;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(x));
  return (int)(x % 128);
}
__device__ __forceinline__ void cta(uint32_t& x, uint32_t& y) {
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
}

// The column groups of head dim d (a multiple of CW) for a kernel whose
// groups are at most `widest` columns: ng groups of dg columns (dg a
// multiple of CW, the last group's columns past d read as zeros and are
// not written). The host's and the blocks' rule.
__host__ __device__ __forceinline__ int groups(int d, int widest) {
  return (d + widest - 1) / widest;
}
__host__ __device__ __forceinline__ int group_width(int d, int widest) {
  const int nc = d / CW, ng = groups(d, widest);
  return (nc + ng - 1) / ng * CW;
}
// the same with an even number of chunks a group (two warpgroups a half)
__host__ __device__ __forceinline__ int group_width_even(int d, int widest) {
  const int nc = d / CW, ng = groups(d, widest);
  return (nc + 2 * ng - 1) / (2 * ng) * 2 * CW;
}

}  // namespace wide

}  // namespace f32att
