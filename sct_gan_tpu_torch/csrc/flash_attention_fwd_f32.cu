// Flash-attention forward for Hopper (sm_90a), f32 in and out: the f32
// instance of K1 (flash_attention_fwd.cu is the bf16 one).
//
// Replaces the TPU kernel sct_gan_tpu/ops/flash_attention.py::_fa_fwd_kernel
// (via _flash_forward / flash_attention) on f32 operands, where the JAX
// kernel keeps every product in its operands' dtype (P in V's dtype, line
// 120): CodeBERT in the TASC trainer, ModelConfig(compute_dtype="float32").
//
//   O = dropout(softmax(Q K^T * scale + key-mask bias [+ causal])) V  per (b, h)
//   lse = log-sum-exp of each score row, kept for the backward
//
// Dropout acts on P after the row statistics and scales the kept weights by
// 1/(1-rate); its keep bit of (b, h, i, j) is the hash of hash_dropout.cuh
// over ((b*H + h)*Sq + i)*Sk + j (a shard's place by DropShard), the bit the
// bf16 K1, K6 and the plain version draw.
//
// Bound on an H100: the products Q K^T and P V over the attended keys,
// 4*H*Sq*dh*sum_b(attended keys of row b) flops, at f32 accuracy. The card
// has 67 TFLOP/s of f32 FMA and 495 of TF32; 3xTF32 (f32_attention.cuh)
// costs three TF32 products, ~165 TFLOP/s, so the products bound it: 0.10
// ms at (8, 8, 1024, 96) under chip_smoke.py's key mask, against 0.02 ms of
// bytes (Q, O, the attended keys' K and V rows at 3.35 TB/s).
//
// Design (a simple kernel that is right; no Hopper pipeline yet):
//   * one block of 8 warps a (128 query rows, b, h), 16 rows a warp; Q stays
//     in shared memory, K and V stream in 64-key tiles through 2 stages by
//     cp.async, rows padded to D + 4 f32 (f32_attention.cuh);
//   * both products on mma.sync.m16n8k8 in 3xTF32, P from the score
//     registers (no trip through shared memory);
//   * the online softmax in f32 in the natural domain (expf, not the SFU's
//     approximate 2^x: f32 results are held at 1e-5);
//   * the block walks only the key tiles that hold an attended key (one
//     block-wide vote a tile, f32_attention.cuh::next_live) and, under
//     causal, that its rows see. A skipped tile adds exactly nothing (its
//     scores are -inf), so the skip changes no result.
// Budget: Q (128 x LD) + 2 stages x (K, V) (64 x LD) f32 + the stages' mask
// bias: 203,264 bytes at D = 128, 154,112 at 96, 104,960 at 64. Registers:
// O (D / 2 f32 a thread) and S (32), within 255: one block of 8 warps an
// SM (ptxas: 220 / 206 at 128 / 96, no spill).
//
// Semantics (the bf16 K1's and the JAX kernel's): a masked key gets -inf; a
// fully-masked row gives zeros and lse = -1e30; causal means key j is
// visible to query i iff j <= i (top-left aligned when Sq != Sk).
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_attention.cuh"
#include "hash_dropout.cuh"
#include "hopper_tile.cuh"

namespace {

using namespace f32att;

constexpr int BQ = 128, BK = 64, NWARPS = 8, NT = NWARPS * 32;

struct FwdF32Args {
  const float *q, *k, *v;
  const uint8_t* mask;   // (B, Sk), nonzero = attend, or null
  float* o;
  float* lse;            // contiguous (B*H, Sq), or null
  int H, Sq, Sk;
  int q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int mask_sb, causal;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float inv_keep;
  DropShard ds;
};

template <int D>
struct FwdF32 {
  static constexpr int LD = D + 4;
  static constexpr int SMEM = (BQ * LD + 4 * BK * LD + 2 * BK) * 4;
  static_assert(SMEM <= 232448, "shared memory over the limit");
};

// One block an SM by the launch bound at every head dim: at 64 two blocks
// would fit shared memory, but their 128 registers a thread spilled.
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_f32_fwd_kernel(const FwdF32Args a) {
  constexpr int LD = FwdF32<D>::LD;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][LD]
  float* kv = qs + BQ * LD;                      // [2 stages][K, V][BK][LD]
  float* bias = kv + 4 * BK * LD;                // [2 stages][BK]: 0 or -inf
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float* qb = a.q + (size_t)b * a.q_sb + (size_t)h * a.q_sh;
  const float* kb = a.k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const float* vb = a.v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + BQ, a.Sq) - 1) / BK + 1);

  auto issue = [&](int j, int st) {          // K, V and the mask bias of tile j
    float* kt = kv + st * 2 * BK * LD;
    load_rows<BK, D, LD, NT>(kt, kb, a.k_ss, j * BK, a.Sk);
    load_rows<BK, D, LD, NT>(kt + BK * LD, vb, a.v_ss, j * BK, a.Sk);
    if (threadIdx.x < BK) {
      const int key = j * BK + threadIdx.x;
      bias[st * BK + threadIdx.x] =
          key < a.Sk && (mrow == nullptr || mrow[key] != 0) ? 0.f : -INFINITY;
    }
  };

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // flat dropout index of (b, h, row, 0) over the true Sq, Sk
  const uint32_t drop0 =
      (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;

  int cur = next_live<BK>(mrow, 0, n_tiles, a.Sk);
  if (cur < n_tiles) {
    load_rows<BQ, D, LD, NT>(qs, qb, a.q_ss, q0, a.Sq);
    issue(cur, 0);
  }
  hopper::cp_async_commit();
  int nxt = next_live<BK>(mrow, cur + 1, n_tiles, a.Sk);
  for (int n = 0; cur < n_tiles; ++n) {
    const int st = n & 1;
    if (nxt < n_tiles) issue(nxt, st ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();                         // tile cur (and Q) landed
    const float* kt = kv + st * 2 * BK * LD;
    const float* bs = bias + st * BK;
    const int k0 = cur * BK;

    float s[BK / 8][4];
#pragma unroll
    for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n8][e] = 0.f;
    mma_nt<BK, D, LD>(s, qs + warp * 16 * LD, kt, lane);

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n8 * 8 + 2 * t + (e & 1);
        float x = s[n8][e] * a.scale + bs[col];
        if (a.causal && k0 + col > (e < 2 ? row0 : row1)) x = -INFINITY;
        s[n8][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];   // all masked so far
      alpha[i] = expf(m_run[i] - base[i]);
      m_run[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n8][e] = expf(s[n8][e] - base[e >> 1]);
        rs[e >> 1] += s[n8][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + quad_sum(rs[i]);
    if (a.dropout) {                         // after l: dropout acts on P only
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = (uint32_t)(k0 + n8 * 8 + 2 * t + (e & 1));
          const bool keep = hash_keep((e < 2 ? drop0 : drop1) + key, a.seed, a.threshold);
          s[n8][e] = keep ? s[n8][e] * a.inv_keep : 0.f;
        }
    }
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n8][e] *= alpha[e >> 1];
    mma_pn<BK, D, LD>(o, s, kt + BK * LD, lane);
    __syncthreads();                         // stage st is free for tile n + 2
    cur = nxt;
    nxt = next_live<BK>(mrow, nxt + 1, n_tiles, a.Sk);
  }
  hopper::cp_async_wait<0>();

  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  if (a.lse != nullptr && t == 0) {          // one lane a row writes it
    float* lb = a.lse + (size_t)bh * a.Sq;
    if (row0 < a.Sq) lb[row0] = l_run[0] > 0.f ? m_run[0] + logf(l_run[0]) : -1e30f;
    if (row1 < a.Sq) lb[row1] = l_run[1] > 0.f ? m_run[1] + logf(l_run[1]) : -1e30f;
  }
  float* ob = a.o + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8) {
    const int col = n8 * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<float2*>(ob + (size_t)row0 * a.o_ss + col) =
          make_float2(o[n8][0] * inv0, o[n8][1] * inv0);
    if (row1 < a.Sq)
      *reinterpret_cast<float2*>(ob + (size_t)row1 * a.o_ss + col) =
          make_float2(o[n8][2] * inv1, o[n8][3] * inv1);
  }
}

template <int D>
int launch(const FwdF32Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = FwdF32<D>::SMEM;
  static bool configured = false;            // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, B * a.H);
  flash_f32_fwd_kernel<D><<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 entry point's arguments (flash_attention_fwd.cu), for f32 q, k, v
// and o: (B, H, S, Dh) with element strides (sb, sh, ss), the last dimension
// contiguous, q/k/v 16-byte aligned with strides of whole 16-byte units (4
// f32; the cp.async copies' rule), o on 8-byte lines; Dh 64, 96 or 128.
// mask: (B, Sk) uint8 (nonzero = attend) with row stride mask_sb, or null;
// lse: contiguous f32 (B, H, Sq), or null. Returns the first error: a head
// dim with no instance, or cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int H, int Sq, int Sk, int Dh, int q_sb, int q_sh, int q_ss,
    int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
    int o_sh, int o_ss, int mask_sb, int causal, float scale, int dropout,
    uint32_t seed, uint32_t threshold, float inv_keep, int drop_b0, int drop_h0,
    int drop_hg, void* stream) {
  const FwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
                     static_cast<float*>(o), static_cast<float*>(lse), H, Sq, Sk,
                     q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                     mask_sb, causal, scale, dropout, seed, threshold, inv_keep,
                     DropShard{(uint32_t)drop_b0, (uint32_t)drop_h0, (uint32_t)drop_hg}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (Dh) {
    case 64: return launch<64>(a, B, st);
    case 96: return launch<96>(a, B, st);
    case 128: return launch<128>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);   // no instance takes it
  }
}
