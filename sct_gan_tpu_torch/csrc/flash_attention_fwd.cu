// Flash-attention forward for Hopper (sm_90a), bf16 in and out, f32 statistics.
//
// Replaces the TPU kernel sct_gan_tpu/ops/flash_attention.py::_fa_fwd_kernel
// (via _flash_forward / flash_attention), with its two training options:
//
//   O = dropout(softmax(Q K^T * scale + key-mask bias [+ causal])) V  per (b, h)
//   lse = log-sum-exp of each score row (f32), kept for the backward
//
// Dropout acts on P after the row statistics (the sum l is taken before it)
// and scales the kept weights by 1/(1-rate). Its keep mask is the JAX
// package's hash stream (hash_dropout.cuh), keyed by the flat index
// ((b*H + h)*Sq + i)*Sk + j over the true Sq and Sk, exactly the mask that
// sct_gan_tpu/ops/attention.py::mha_reference draws; the TPU kernel's own
// PRNG stream is TPU hardware and is not reproduced.
//
// What bounds it on an H100: at S = 1024, dh = 96 it does 4*S*S*dh flops per
// (b, h) against 4*S*dh*2 bytes of Q/K/V/O, so it is compute-bound, and the
// softmax (one exp per score, row max/sum shuffles) competes with the matrix
// products for issue slots.
//
// The simple design: one block of 4 warps per (b, h, 64-row query tile); each
// warp owns 16 query rows. A loop inside the block walks 64-key K/V tiles
// (the TPU's single-pass nk == 1 layout does not carry over: a 1024-wide K
// block would not fit in shared memory). Matrix products are bf16
// mma.sync.m16n8k16 with f32 accumulation, so dh = 96 is 6 k-steps with no
// padding to 128. The scores stay in registers: the accumulator layout of
// Q K^T is the A-operand layout of P V (the FlashAttention-2 register
// reuse), so P never touches shared memory. The online softmax keeps the
// running max and sum per row in registers and rescales the f32 output
// accumulator in place. Causal tiles above the diagonal are skipped. Loads
// are plain synchronous 16-byte copies; TMA, wgmma and warp specialisation
// are later work.
//
// Semantics (the JAX kernel's): a masked key gets -inf; a fully-masked row
// gives zeros and lse = -1e30 (the JAX kernel's m + log(1) with its finite
// -1e30 mask); causal means key j is visible to query i iff j <= i
// (top-left aligned when Sq != Sk).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;        // bf16 row padding: spreads fragment reads over banks
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk,
                 int q_sb, int q_sh, int q_ss, int k_sb, int k_sh, int k_ss,
                 int v_sb, int v_sh, int v_ss, int o_sb, int o_sh, int o_ss,
                 int mask_sb, int causal, float scale_log2, int dropout,
                 uint32_t seed, uint32_t threshold, float inv_keep) {
  constexpr int LD = D + PAD;      // Q and K row stride in shared memory
  constexpr int LDV = BK + PAD;    // V^T row stride in shared memory
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int NT_D = D / 8;      // 8-wide n-tiles of the output
  constexpr int NT_K = BK / 8;     // 8-wide n-tiles of the scores
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * LDV];
  __shared__ float sBias[BK];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;    // mma group / thread-in-group
  const __nv_bfloat16* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const __nv_bfloat16* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const __nv_bfloat16* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  __nv_bfloat16* ob = o + (size_t)b * o_sb + (size_t)h * o_sh;

  load_tile<D, LD, NTHREADS>(sQ, qb, q0, Sq, q_ss);
  __syncthreads();
  uint32_t qf[KSTEPS][4];                    // this warp's 16 Q rows, A layout
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
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  // flat dropout index of (b, h, row, 0) over the true Sq, Sk
  const uint32_t drop0 = ((uint32_t)blockIdx.y * (uint32_t)Sq + (uint32_t)row0) * (uint32_t)Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)Sk;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();                         // previous tile fully consumed
    load_tile<D, LD, NTHREADS>(sK, kb, k0, Sk, k_ss);
    constexpr int CH = D / 8;
    for (int c = threadIdx.x; c < BK * CH; c += NTHREADS) {   // V, transposed
      const int r = c / CH, col = (c % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk)
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * v_ss + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(col + i) * LDV + r] = e[i];
    }
    for (int c = threadIdx.x; c < BK; c += NTHREADS) {
      const int key = k0 + c;
      const bool ok = key < Sk && (mask == nullptr || mask[(size_t)b * mask_sb + key]);
      sBias[c] = ok ? 0.f : -INFINITY;
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

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale_log2 + sBias[col];
        if (causal && k0 + col > (e < 2 ? row0 : row1)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];   // all masked so far
      alpha[i] = exp2f(m_run[i] - base[i]);
      m_run[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_run[i] = l_run[i] * alpha[i] + rs[i];
    }
    if (dropout) {                           // after l: dropout acts on P only
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = (uint32_t)(k0 + nt * 8 + 2 * t + (e & 1));
          const bool keep = hash_keep((e < 2 ? drop0 : drop1) + key, seed, threshold);
          s[nt][e] = keep ? s[nt][e] * inv_keep : 0.f;
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < NT_D; ++dt) {
      acc[dt][0] *= alpha[0]; acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1]; acc[dt][3] *= alpha[1];
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

  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  if (lse != nullptr && t == 0) {            // one lane per row writes it
    float* lb = lse + (size_t)blockIdx.y * Sq;
    if (row0 < Sq)
      lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
    if (row1 < Sq)
      lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
  }
#pragma unroll
  for (int dt = 0; dt < NT_D; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * o_ss + col) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * o_ss + col) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* mask, void* o,
            void* lse, int B, int H, int Sq, int Sk, int q_sb, int q_sh, int q_ss,
            int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
            int o_sb, int o_sh, int o_ss, int mask_sb, int causal, float scale,
            int dropout, uint32_t seed, uint32_t threshold, float inv_keep,
            cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Sk, q_sb,
      q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb,
      causal, scale * LOG2E, dropout, seed, threshold, inv_keep);
}

}  // namespace

// q, k, v, o: bf16 (B, H, S, D) with element strides (sb, sh, ss) and the
// last dimension contiguous; mask: (B, Sk) uint8 (nonzero = attend) with row
// stride mask_sb, or null; lse: contiguous f32 (B, H, Sq), or null for none.
// dropout != 0 turns on attention-weight dropout with the hash keep mask
// (seed, threshold) and the scale inv_keep = 1/(1-rate). Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int H, int Sq, int Sk, int D, int q_sb, int q_sh, int q_ss,
    int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
    int o_sh, int o_ss, int mask_sb, int causal, float scale, int dropout,
    uint32_t seed, uint32_t threshold, float inv_keep, void* stream) {
  if (D != 96) return static_cast<int>(cudaErrorInvalidValue);   // dh of the model
  launch<96>(q, k, v, mask, o, lse, B, H, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh,
             k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal, scale,
             dropout, seed, threshold, inv_keep, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
