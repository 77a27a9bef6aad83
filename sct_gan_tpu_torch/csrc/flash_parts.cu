// Flash-attention parts for Hopper (sm_90a): K1's tiling with one of three
// softmax bodies, to take K1's time apart on the card. bf16 in and out.
//
// Replaces the TPU kernel of tools/time_flash_parts.py (its pallas_call at
// :81), which timed three bodies under identical memory traffic and grid, at
// scale 0.1 with s = 0.1 Q K^T:
//
//   full    O = softmax(s) V as the online softmax: running row max and sum,
//           the accumulator rescaled by exp(m_old - m_new) at every tile
//   noexp   p = clip(s, 0, 1), l = rowsum p, O = (p V) / l: no max, no
//           exponent, no rescale
//   mmonly  O = s V: the two matrix products alone
//
// q, k and v may be one tensor (the tool calls f(x, x, x)).
//
// What bounds it on an H100: at (8, 8, 1024, 96) it does 25.8 GFLOP of
// matrix products, 0.026 ms at the bf16 peak, against 25 MB of input and
// output, so it is bound by operations. What this kernel measures is which
// operations hold it back: the products, the softmax, or the loads that
// feed them.
//
// The design is K1's (flash_attention_fwd.cu) without its key mask, causal
// branch, dropout and LSE, so that the three modes differ only in the
// softmax: one block of 4 warps per (b, h, 64-query tile), 16 query rows a
// warp; a loop over 64-key K/V tiles; bf16 mma.sync.m16n8k16 with f32
// accumulation; the Q K^T accumulators re-packed in registers as P V's A
// operand; synchronous 16-byte loads, V transposed element by element
// through shared memory. full uses exp2 with log2(e) folded into the scale,
// as K1 does. D is 96 (the model's head) or 128 (the TPU tool's lane-padded
// head). Shared memory (Q, K and V^T tiles, K1's layout) is dynamic because
// at D = 128 it passes 48 KB. S must be a multiple of 64 (the tool's is 1024).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;        // bf16 row padding, as in K1
constexpr float LOG2E = 1.4426950408889634f;

enum Mode { FULL = 0, NOEXP = 1, MMONLY = 2 };

template <int D>
constexpr int smem_bytes() {
  return ((BQ + BK) * (D + PAD) + D * (BK + PAD)) * 2;
}

template <int MODE, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_parts_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int S, float scale) {
  constexpr int LD = D + PAD;      // Q and K row stride in shared memory
  constexpr int LDV = BK + PAD;    // V^T row stride in shared memory
  constexpr int KSTEPS = D / 16;
  constexpr int NT_D = D / 8;
  constexpr int NT_K = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sVt = sK + BK * LD;

  const size_t base = (size_t)blockIdx.y * S * D;   // (b, h) of a contiguous (B, H, S, D)
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  __nv_bfloat16* ob = o + base;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_tile<D, LD, NTHREADS>(sQ, qb, q0, S, D);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p = sQ + (wr + g) * LD + kk * 16 + 2 * t;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }

  float acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // full: rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};               // full, noexp: row sums of p
  const float sc = MODE == FULL ? scale * LOG2E : scale;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();                         // previous tile fully consumed
    load_tile<D, LD, NTHREADS>(sK, kb, k0, S, D);
    constexpr int CH = D / 8;
    for (int c = threadIdx.x; c < BK * CH; c += NTHREADS) {   // V, transposed
      const int r = c / CH, col = (c % CH) * 8;
      const uint4 val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(col + i) * LDV + r] = e[i];
    }
    __syncthreads();

    float s[NT_K][4];                        // S = Q K^T, 16 x 64 per warp
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* p = sK + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[nt], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    if (MODE == FULL) {                      // K1's online softmax
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= sc;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2f(m_run[i] - mx[i]);
        m_run[i] = mx[i];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
          rs[e >> 1] += s[nt][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l_run[i] = l_run[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int dt = 0; dt < NT_D; ++dt) {
        acc[dt][0] *= alpha[0]; acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1]; acc[dt][3] *= alpha[1];
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sc;
          if (MODE == NOEXP) {               // the row sum waits for the end
            x = fminf(fmaxf(x, 0.f), 1.f);
            l_run[e >> 1] += x;
          }
          s[nt][e] = x;
        }
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {   // O += P V
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < NT_D; ++dt) {
        const __nv_bfloat16* p = sVt + (dt * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_16816(acc[dt], pa, ld32(p), ld32(p + 8));
      }
    }
  }

  if (MODE == NOEXP) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
  }
  // O = acc / max(l, 1e-9), as the tool's _fin; mmonly divides by 1
  const float inv0 = MODE == MMONLY ? 1.f : 1.f / fmaxf(l_run[0], 1e-9f);
  const float inv1 = MODE == MMONLY ? 1.f : 1.f / fmaxf(l_run[1], 1e-9f);
  const int row0 = q0 + wr + g, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < NT_D; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * D + col) =
        __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * D + col) =
        __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int MODE, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kernel = flash_parts_kernel<MODE, D>;
  if (bytes > 48 * 1024) {   // once per instance: no call inside a graph capture
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  kernel<<<dim3(S / BQ, BH), NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mode(int mode, const void* q, const void* k, const void* v, void* o,
                int BH, int S, float scale, cudaStream_t stream) {
  switch (mode) {
    case FULL: return launch<FULL, D>(q, k, v, o, BH, S, scale, stream);
    case NOEXP: return launch<NOEXP, D>(q, k, v, o, BH, S, scale, stream);
    case MMONLY: return launch<MMONLY, D>(q, k, v, o, BH, S, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: contiguous bf16 (B*H, S, D), D in {96, 128}, S a multiple of
// 64; mode 0 full, 1 noexp, 2 mmonly; scale multiplies Q K^T. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_parts_bf16(const void* q, const void* k, const void* v,
                                void* o, int BH, int S, int D, int mode,
                                float scale, void* stream) {
  if (BH <= 0 || S <= 0 || S % BK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 96) return launch_mode<96>(mode, q, k, v, o, BH, S, scale, s);
  if (D == 128) return launch_mode<128>(mode, q, k, v, o, BH, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
