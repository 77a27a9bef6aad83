// Single-pass softmax variants of the flash forward for Hopper (sm_90a), to
// price the softmax's parts on the card. bf16 in and out.
//
// Replaces the TPU kernel of tools/time_flash_variants.py (its pallas_call at
// :75). That kernel holds a whole (512, 1024) score block in VMEM (nk == 1):
// the row max over all keys comes before any exponent, and nothing is
// rescaled. The modes, with s = 0.1 Q K^T (times log2(e) where exp2 is used):
//
//   nk1     p = exp(s - m), l = rowsum p, O = (bf16(p) V) / l
//   exp2    nk1 with exp2
//   mxsum   exp2, with l from the tensor core: one more 8-wide n-tile of
//           ones beside V's, whose accumulator column is rowsum(bf16(p))
//   bf16p   p = exp2(bf16(s - m)), two at a time (h2exp2 on bf16 pairs)
//   masked  nk1 and then p = where(s > -1e29, p, 0): the padded path's select
//   mmonly  O = bf16(s) V: the two products alone
//
// q, k and v may be one tensor (the tool calls f(x, x, x, ones)).
//
// What bounds it on an H100: as flash_parts.cu, 25.8 GFLOP of products at
// (8, 8, 1024, 96) (0.026 ms at the bf16 peak) against 25 MB of input and
// output: operations.
//
// Design. A score row of 1024 f32 is 4 KB; 64 rows (256 KB) do not fit the
// 227 KB a block may have. A block therefore takes 32 query rows and keeps
// their f32 scores in 128 KB of dynamic shared memory. (The other choice, a
// first pass for the max and a second for the exponent and P V, computes
// Q K^T twice, so that the matrix work would differ between mmonly and the
// softmax modes; here every mode does each product once, as on the TPU.)
// 8 warps: warp w owns query rows 16 (w % 2) .. +16 and keys
// 16 (w / 2) .. +16 of every 64-key tile.
//   Pass 1 walks the K tiles: S = Q K^T by bf16 mma.sync.m16n8k16, scaled,
//   stored to shared memory, with a running max per thread; one block
//   reduction gives each row's max.
//   Pass 2 walks the V tiles (V transposed element by element through shared
//   memory, as in K1): each warp reads back the scores it wrote (the
//   accumulator layout of S is the A layout of P V, so a thread reads only
//   its own), takes the exponent, packs P to bf16 and accumulates its
//   16-key slice of P V over all D columns.
//   The four key slices of a row meet in shared memory at the end.
// One block fits an SM (146 KB at D = 96, 151 KB at D = 128). S must be a
// multiple of 64, at most 1536.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KSLICES = NWARPS / 2;   // 16-key slices of a tile
constexpr int PAD = 8;        // bf16 row padding of the K and V^T tiles
constexpr int SPAD = 8;       // f32 row padding of the scores: rows 8 banks apart
constexpr int MAX_SMEM = 232448 - 2 * KSLICES * BQ * 4;   // minus the static arrays
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t ONES = 0x3F803F80u;   // two bf16 1.0

enum Mode { NK1 = 0, EXP2 = 1, MXSUM = 2, BF16P = 3, MASKED = 4, MMONLY = 5 };

// f32 words of the score area: the scores, or at the end the partial outputs
template <int D>
int score_floats(int S) {
  const int scores = BQ * (S + SPAD), partials = KSLICES * BQ * (D + SPAD);
  return scores > partials ? scores : partials;
}

template <int D>
constexpr int tile_bytes() {
  return (BK * (D + PAD) > D * (BK + PAD) ? BK * (D + PAD) : D * (BK + PAD)) * 2;
}

template <int MODE, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_variants_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int S, int n_score, float scale) {
  constexpr int LD = D + PAD;      // K (and Q) row stride of the tile
  constexpr int LDV = BK + PAD;    // V^T row stride of the tile
  constexpr int LDP = D + SPAD;    // row stride of the partial outputs
  constexpr int KSTEPS = D / 16;
  constexpr int NT_D = D / 8;
  constexpr int CH = D / 8;        // 16-byte chunks of a row
  constexpr bool USE_EXP2 = MODE == EXP2 || MODE == MXSUM || MODE == BF16P;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sS = reinterpret_cast<float*>(smem);                     // BQ x LDS
  __nv_bfloat16* sT = reinterpret_cast<__nv_bfloat16*>(sS + n_score);
  __shared__ float sMax[KSLICES][BQ];
  __shared__ float sSum[KSLICES][BQ];
  const int LDS = S + SPAD;

  const size_t base = (size_t)blockIdx.y * S * D;   // (b, h) of a contiguous (B, H, S, D)
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ks = warp >> 1;                 // key slice
  const int r0 = (warp & 1) * 16 + g, r1 = r0 + 8;   // this thread's rows in the block
  float* srow0 = sS + r0 * LDS;
  float* srow1 = sS + r1 * LDS;

  // Q rows q0 .. q0 + 31, staged through the tile area, into registers
  for (int c = threadIdx.x; c < BQ * CH; c += NTHREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    *reinterpret_cast<uint4*>(sT + r * LD + col) =
        *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * D + col);
  }
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p = sT + r0 * LD + kk * 16 + 2 * t;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }
  const float sc = USE_EXP2 ? scale * LOG2E : scale;

  // -- pass 1: scores to shared memory, row max -------------------------------
  float mx[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();                        // Q fragments or the last tile read
    load_tile<D, LD, NTHREADS>(sT, kb, k0, S, D);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = ks * 16 + nt * 8;     // key of the tile
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* p = sT + (col + g) * LD + kk * 16 + 2 * t;
        mma_16816(c, qf[kk], ld32(p), ld32(p + 8));
      }
      const float2 a = make_float2(c[0] * sc, c[1] * sc);
      const float2 b = make_float2(c[2] * sc, c[3] * sc);
      *reinterpret_cast<float2*>(srow0 + k0 + col + 2 * t) = a;
      *reinterpret_cast<float2*>(srow1 + k0 + col + 2 * t) = b;
      if (MODE != MMONLY) {
        mx[0] = fmaxf(mx[0], fmaxf(a.x, a.y));
        mx[1] = fmaxf(mx[1], fmaxf(b.x, b.y));
      }
    }
  }
  float m[2] = {0.f, 0.f};
  if (MODE != MMONLY) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if (t == 0) {
      sMax[ks][r0] = mx[0];
      sMax[ks][r1] = mx[1];
    }
    __syncthreads();
    m[0] = sMax[0][r0];
    m[1] = sMax[0][r1];
#pragma unroll
    for (int i = 1; i < KSLICES; ++i) {
      m[0] = fmaxf(m[0], sMax[i][r0]);
      m[1] = fmaxf(m[1], sMax[i][r1]);
    }
  }

  // -- pass 2: P = exp(S - m) from shared memory, O += P V --------------------
  float acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float lacc[4] = {0.f, 0.f, 0.f, 0.f};     // mxsum: P times a tile of ones
  float rs[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();                        // the last tile fully consumed
    for (int c = threadIdx.x; c < BK * CH; c += NTHREADS) {   // V, transposed
      const int r = c / CH, col = (c % CH) * 8;
      const uint4 val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) sT[(col + i) * LDV + r] = e[i];
    }
    __syncthreads();
    const int key = k0 + ks * 16 + 2 * t;
    // A fragment order: (row g, keys 2t..), (row g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
    const float2 f[4] = {*reinterpret_cast<const float2*>(srow0 + key),
                         *reinterpret_cast<const float2*>(srow1 + key),
                         *reinterpret_cast<const float2*>(srow0 + key + 8),
                         *reinterpret_cast<const float2*>(srow1 + key + 8)};
    uint32_t pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mi = m[i & 1];
      if (MODE == MMONLY) {
        pa[i] = pack_bf16(f[i].x, f[i].y);
      } else if (MODE == BF16P) {
        const __nv_bfloat162 p = h2exp2(__floats2bfloat162_rn(f[i].x - mi, f[i].y - mi));
        pa[i] = *reinterpret_cast<const uint32_t*>(&p);
        const float2 pf = __bfloat1622float2(p);
        rs[i & 1] += pf.x + pf.y;
      } else {
        float p0 = USE_EXP2 ? exp2f(f[i].x - mi) : expf(f[i].x - mi);
        float p1 = USE_EXP2 ? exp2f(f[i].y - mi) : expf(f[i].y - mi);
        if (MODE == MASKED) {
          p0 = f[i].x > -1e29f ? p0 : 0.f;
          p1 = f[i].y > -1e29f ? p1 : 0.f;
        }
        if (MODE != MXSUM) rs[i & 1] += p0 + p1;
        pa[i] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int dt = 0; dt < NT_D; ++dt) {
      const __nv_bfloat16* p = sT + (dt * 8 + g) * LDV + ks * 16 + 2 * t;
      mma_16816(acc[dt], pa, ld32(p), ld32(p + 8));
    }
    if (MODE == MXSUM) mma_16816(lacc, pa, ONES, ONES);
  }

  // -- the four key slices of each row meet in shared memory ------------------
  if (MODE == MXSUM) {                      // every column of P times ones is l
    rs[0] = lacc[0];
    rs[1] = lacc[2];
  } else if (MODE != MMONLY) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    }
  }
  __syncthreads();                          // every warp is done with the scores
  if (MODE != MMONLY && t == 0) {
    sSum[ks][r0] = rs[0];
    sSum[ks][r1] = rs[1];
  }
  float* part = sS + ks * BQ * LDP;
#pragma unroll
  for (int dt = 0; dt < NT_D; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<float2*>(part + r0 * LDP + col) = make_float2(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<float2*>(part + r1 * LDP + col) = make_float2(acc[dt][2], acc[dt][3]);
  }
  __syncthreads();
  __nv_bfloat16* ob = o + base + (size_t)q0 * D;
  for (int c = threadIdx.x; c < BQ * D / 2; c += NTHREADS) {
    const int r = c / (D / 2), col = (c % (D / 2)) * 2;
    float x0 = 0.f, x1 = 0.f, l = 0.f;
#pragma unroll
    for (int i = 0; i < KSLICES; ++i) {
      const float2 y = *reinterpret_cast<const float2*>(sS + (i * BQ + r) * LDP + col);
      x0 += y.x;
      x1 += y.y;
      if (MODE != MMONLY) l += sSum[i][r];
    }
    // O = acc / max(l, 1e-9), as the tool's kernel; mmonly divides by nothing
    const float inv = MODE == MMONLY ? 1.f : 1.f / fmaxf(l, 1e-9f);
    *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * D + col) =
        __floats2bfloat162_rn(x0 * inv, x1 * inv);
  }
}

template <int MODE, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           float scale, cudaStream_t stream) {
  const int n_score = score_floats<D>(S);
  const int bytes = n_score * 4 + tile_bytes<D>();
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_variants_kernel<MODE, D>;
  // once per instance, at the largest size (no call inside a graph capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(S / BQ, BH), NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      n_score, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mode(int mode, const void* q, const void* k, const void* v, void* o,
                int BH, int S, float scale, cudaStream_t stream) {
  switch (mode) {
    case NK1: return launch<NK1, D>(q, k, v, o, BH, S, scale, stream);
    case EXP2: return launch<EXP2, D>(q, k, v, o, BH, S, scale, stream);
    case MXSUM: return launch<MXSUM, D>(q, k, v, o, BH, S, scale, stream);
    case BF16P: return launch<BF16P, D>(q, k, v, o, BH, S, scale, stream);
    case MASKED: return launch<MASKED, D>(q, k, v, o, BH, S, scale, stream);
    case MMONLY: return launch<MMONLY, D>(q, k, v, o, BH, S, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: contiguous bf16 (B*H, S, D), D in {96, 128}, S a multiple of
// 64 up to 1536; mode 0 nk1, 1 exp2, 2 mxsum, 3 bf16p, 4 masked, 5 mmonly;
// scale multiplies Q K^T. Returns cudaGetLastError() after the launch.
extern "C" int flash_variants_bf16(const void* q, const void* k, const void* v,
                                   void* o, int BH, int S, int D, int mode,
                                   float scale, void* stream) {
  if (BH <= 0 || S <= 0 || S % BK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 96) return launch_mode<96>(mode, q, k, v, o, BH, S, scale, s);
  if (D == 128) return launch_mode<128>(mode, q, k, v, o, BH, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
