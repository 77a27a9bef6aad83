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
// Head dims: one instance each for D = 64, 96 and 128 (the template
// parameter below); the wrapper pads any other D <= 128 to the next one.
// A head dim over 128, padded by the wrapper to a multiple of 128 (as the
// TPU kernel pads its lanes), runs the wide-head route at the end of this
// file: flash_fwd_wide_kernel.
//
// Bound on an H100: the products Q K^T and P V over the attended keys,
// 4*H*Sq*dh*sum_b(attended keys of row b) flops at 989 TFLOP/s, against Q and
// O and the attended keys' K and V rows at 3.35 TB/s. A masked key adds
// nothing to O, so it needs no product. At (8, 8, 1024, 96) with every key
// attended that is 0.026 ms of products, 6x the 0.004 ms of bytes:
// compute-bound. Under chip_smoke.py's key mask (5301 of 8192 keys) it is
// 0.017 ms. This kernel still walks every K/V tile up to Sk (a fully masked
// tile costs its products), so the mask's share is time it could skip.
//
// The design. The kernel-timing tools found that the first design (4 warps,
// 64 query rows, mma.sync) lost its time feeding the products, not in the
// softmax: synchronous tile loads with nothing overlapping them, V
// transposed into shared memory one element at a time, every fragment a
// separate 32-bit shared load, and the time following the warps in flight.
// This design answers each:
//   * a block takes 128 query rows: two consumer warpgroups of 64 rows and
//     one producer warp (288 threads);
//   * the producer loads Q once and streams K and V through a ring of
//     STAGES shared-memory stages by TMA (rank-4 (D, S, H, B) maps built on
//     the host from the caller's strides; rows past S read as zeros), with
//     full/empty mbarriers, so the next tiles load while this one is used.
//     It also writes each tile's key-mask bias (0 or -inf; -inf past Sk)
//     beside its K tile;
//   * both products run on wgmma: S = Q K^T as m64n64k16 (D / 16 k-steps)
//     with both operands in shared memory (K-major), O += P V as m64nDk16
//     with P from registers (the S accumulator layout is the A register
//     layout) and V read MN-major through the transpose bit, so nothing
//     transposes V and no fragment is loaded by hand. Layouts:
//     hopper_tile.cuh.
// The online softmax, the causal tile skip, the key-mask bias, dropout and
// the LSE are the first design's arithmetic.
//
// Budget, at D = 96 (64; 128). Shared memory: Q 24 (16; 32) KB + STAGES x
// (K and V 24 (16; 32) KB + 256 B of bias) + barriers + 1 KB of alignment
// slack = 98 (66; 130) KB at STAGES = 3, one block an SM. Registers: a
// consumer thread holds the O accumulator (D / 2 f32: 48, 32 or 64), the S
// tile (32 f32), P packed (16) and its row statistics, under the 224 that
// 288 threads leave each; ptxas -v must show no spills in any instance.
// setmaxnreg is not needed at this budget.
//
// Semantics (the JAX kernel's): a masked key gets -inf; a fully-masked row
// gives zeros and lse = -1e30 (the JAX kernel's m + log(1) with its finite
// -1e30 mask); causal means key j is visible to query i iff j <= i
// (top-left aligned when Sq != Sk).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"
#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;                     // query rows per block
constexpr int BK = 64;                      // keys per K/V tile
constexpr int STAGES = 3;                   // K/V ring depth
constexpr int NCONSUMERS = 8;               // warps in the two warpgroups
constexpr int NTHREADS = (NCONSUMERS + 1) * 32;
constexpr int Q_CHUNK = BQ * CHUNK_BYTES_ROW;
constexpr int KV_CHUNK = BK * CHUNK_BYTES_ROW;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int NCHUNK = D / CHUNK_COLS;   // 32-column swizzled boxes a row
  alignas(1024) unsigned char q[NCHUNK][Q_CHUNK];
  alignas(1024) unsigned char k[STAGES][NCHUNK][KV_CHUNK];
  alignas(1024) unsigned char v[STAGES][NCHUNK][KV_CHUNK];
  float bias[STAGES][BK];
  uint64_t q_full, full[STAGES], empty[STAGES];
};
template <int D>
constexpr int smem_bytes() { return sizeof(Smem<D>) + 1024; }   // + alignment slack

template <int D>
__device__ __forceinline__ Smem<D>& smem_tile(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<Smem<D>*>(raw + pad);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int o_sb,
                 int o_sh, int o_ss, int mask_sb, int causal, float scale_log2,
                 int dropout, uint32_t seed, uint32_t threshold, float inv_keep,
                 DropShard ds) {
  constexpr int NCHUNK = D / CHUNK_COLS;
  constexpr uint32_t TILE_BYTES = 2 * NCHUNK * KV_CHUNK;   // K + V of one stage
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& s = smem_tile<D>(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 32);            // the producer warp's lanes
      mbar_init(&s.empty[i], NCONSUMERS);   // one lane a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NCONSUMERS) {                 // ---- producer warp ----
    if (lane == 0) {
      mbar_arrive_expect_tx(&s.q_full, NCHUNK * Q_CHUNK);
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c)
        tma_load_4d(s.q[c], &q_map, &s.q_full, c * CHUNK_COLS, q0, h, b);
    }
    const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES, k0 = j * BK;
      const int ka = k0 + lane, kb = ka + 32;
      const bool oka = ka < Sk && (mrow == nullptr || mrow[ka]);
      const bool okb = kb < Sk && (mrow == nullptr || mrow[kb]);
      mbar_wait(&s.empty[st], ((j / STAGES) & 1) ^ 1);   // the stage is free
      s.bias[st][lane] = oka ? 0.f : -INFINITY;
      s.bias[st][lane + 32] = okb ? 0.f : -INFINITY;
      if (lane == 0) {
        mbar_arrive_expect_tx(&s.full[st], TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NCHUNK; ++c) {
          tma_load_4d(s.k[st][c], &k_map, &s.full[st], c * CHUNK_COLS, k0, h, b);
          tma_load_4d(s.v[st][c], &v_map, &s.full[st], c * CHUNK_COLS, k0, h, b);
        }
      } else {
        mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg takes rows q0 + 64 wg .. + 63 ----
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;    // accumulator group / thread-in-group
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + g, row1 = row0 + 8;
  // flat dropout index of (b, h, row, 0) over the true Sq, Sk
  const uint32_t drop0 = (drop_head(b, h, ds) * (uint32_t)Sq + (uint32_t)row0) * (uint32_t)Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)Sk;

  float acc[D / 2];                         // O, D / 8 blocks of 8 columns
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};

  mbar_wait(&s.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES, k0 = j * BK;
    mbar_wait(&s.full[st], (j / STAGES) & 1);

    float sc[32];                           // S = Q K^T, 64 x 64 per warpgroup
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks / 2, off = (ks % 2) * 32;
      const uint64_t da = desc_b64(&s.q[c][wg * 64 * CHUNK_BYTES_ROW + off], 16, 512);
      const uint64_t db = desc_b64(&s.k[st][c][off], 16, 512);
      wgmma_m64n64k16_ss(sc, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    const float* bias = s.bias[st];
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float x = sc[nt * 4 + e] * scale_log2 + bias[col];
        if (causal && k0 + col > (e < 2 ? row0 : row1)) x = -INFINITY;
        sc[nt * 4 + e] = x;
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
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2f(sc[i] - base[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_run[i] = l_run[i] * alpha[i] + rs[i];
    }
    if (dropout) {                          // after l: dropout acts on P only
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t key = (uint32_t)(k0 + (i >> 2) * 8 + 2 * t + (i & 1));
        const bool keep = hash_keep((((i >> 1) & 1) ? drop1 : drop0) + key, seed, threshold);
        sc[i] = keep ? sc[i] * inv_keep : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // O += P V, 16 keys a step
      const uint32_t pa[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                              pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                              pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                              pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
      const uint64_t db = desc_b64(&s.v[st][0][kk * 16 * CHUNK_BYTES_ROW], KV_CHUNK, 512);
      wgmma_rs(acc, pa, db);                // m64nDk16
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);   // this warp is done with the stage
  }

  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  if (lse != nullptr && t == 0) {           // one lane per row writes it
    float* lb = lse + (size_t)bh * Sq;
    if (row0 < Sq)
      lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
    if (row1 < Sq)
      lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
  }
  __nv_bfloat16* ob = o + (size_t)b * o_sb + (size_t)h * o_sh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * o_ss + col) =
          __floats2bfloat162_rn(acc[dt * 4] * inv0, acc[dt * 4 + 1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * o_ss + col) =
          __floats2bfloat162_rn(acc[dt * 4 + 2] * inv1, acc[dt * 4 + 3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o,
           void* lse, int B, int H, int Sq, int Sk, int q_sb, int q_sh, int q_ss,
           int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
           int o_sh, int o_ss, int mask_sb, int causal, float scale, int dropout,
           uint32_t seed, uint32_t threshold, float inv_keep, DropShard ds,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_head_map(&qm, q, B, H, Sq, D, q_sb, q_sh, q_ss, BQ);
  if (err == 0) err = make_head_map(&km, k, B, H, Sk, D, k_sb, k_sh, k_ss, BK);
  if (err == 0) err = make_head_map(&vm, v, B, H, Sk, D, v_sb, v_sh, v_ss, BK);
  if (err != 0) return err;
  static bool configured = false;           // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem_bytes<D>(), stream>>>(
      qm, km, vm, static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Sk, o_sb, o_sh, o_ss, mask_sb, causal,
      scale * LOG2E, dropout, seed, threshold, inv_keep, ds);
  return static_cast<int>(cudaGetLastError());
}

// ---- the wide-head route: D > 128, a multiple of 128 ----------------------
//
// The instances above keep the O accumulator of a whole head row in
// registers (D / 2 f32 a thread) and Q in shared memory; past D = 128 neither
// fits. This route cuts the output's head dim into 128-column chunks, one
// block per (b, h, 64-query tile, chunk c):
//
//   S = sum over chunks cc of Q[:, cc] K[:, cc]^T    (recomputed by every c)
//   O[:, c] = softmax(S) V[:, c]
//
// The softmax statistics are the same in every chunk's block, so the LSE is
// written by chunk 0 alone; the dropout keep mask depends only on (b, h,
// query, key), so every chunk draws the same bits. Any multiple of 128 runs
// with the same shared memory: only 128-column slabs are held.
//
// Per K/V tile of 64 keys the block walks nchunk score items (the Q and K
// slabs of chunk cc) and one value item (the V slab of its own chunk),
// through a 2-stage cp.async ring; the next item loads while this one is
// used. 4 warps, 16 query rows each; mma.sync.m16n8k16, ldmatrix operands
// from rows padded to 136 elements (272 bytes, 17 16-byte units: eight rows
// of one unit fall in eight bank groups). A thread holds O's chunk (64 f32)
// and the S tile (32 f32).
//
// Bound: as the instances' (the products over the attended keys), plus the
// recomputation: the score product runs once per chunk, so the route does
// (nchunk + 1) / 2 times the forward's products. It is right and simple,
// not fast: the wgmma instances are the fast path.
constexpr int WIDE_COLS = 128;              // a head-dim chunk
constexpr int WIDE_LD = WIDE_COLS + 8;      // shared row stride (bf16)
constexpr int WIDE_BQ = 64;                 // query rows a block, 16 a warp
constexpr int WIDE_BK = 64;                 // keys a tile
constexpr int WIDE_THREADS = 128;

struct WideFwdStage {
  __nv_bfloat16 a[WIDE_BQ * WIDE_LD];       // Q's chunk cc (score items)
  __nv_bfloat16 b[WIDE_BK * WIDE_LD];       // K's chunk cc, or V's chunk c
};
constexpr int WIDE_SMEM = 2 * sizeof(WideFwdStage);

__global__ void __launch_bounds__(WIDE_THREADS, 2)
flash_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk, int q_sb,
                      int q_sh, int q_ss, int k_sb, int k_sh, int k_ss, int v_sb,
                      int v_sh, int v_ss, int o_sb, int o_sh, int o_ss, int mask_sb,
                      int causal, float scale_log2, int dropout, uint32_t seed,
                      uint32_t threshold, float inv_keep, DropShard ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideFwdStage* stage = reinterpret_cast<WideFwdStage*>(smem_raw);
  const int nchunk = gridDim.z, c = blockIdx.z;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * WIDE_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const __nv_bfloat16* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const __nv_bfloat16* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const __nv_bfloat16* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;
  int n_tiles = (Sk + WIDE_BK - 1) / WIDE_BK;
  if (causal) n_tiles = min(n_tiles, (q0 + WIDE_BQ - 1) / WIDE_BK + 1);
  const int per_tile = nchunk + 1;          // nchunk score items, then V's
  const int n_items = n_tiles * per_tile;

  auto issue = [&](int item, WideFwdStage& st) {
    const int s = item % per_tile, k0 = (item / per_tile) * WIDE_BK;
    if (s < nchunk) {
      cp_tile<WIDE_COLS, WIDE_BQ, WIDE_THREADS>(st.a, qb + s * WIDE_COLS, q0, Sq, q_ss);
      cp_tile<WIDE_COLS, WIDE_BK, WIDE_THREADS>(st.b, kb + s * WIDE_COLS, k0, Sk, k_ss);
    } else {
      cp_tile<WIDE_COLS, WIDE_BK, WIDE_THREADS>(st.b, vb + c * WIDE_COLS, k0, Sk, v_ss);
    }
  };

  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const uint32_t drop0 = (drop_head(b, h, ds) * (uint32_t)Sq + (uint32_t)row0) * (uint32_t)Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)Sk;
  float acc[WIDE_COLS / 8][4];              // O's chunk c, rows g and g + 8
  float sc[WIDE_BK / 8][4];                 // S, 16 x 64 a warp
#pragma unroll
  for (int i = 0; i < WIDE_COLS / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < WIDE_BK / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // log2 domain
  float l_run[2] = {0.f, 0.f};

  issue(0, stage[0]);
  cp_async_commit();
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) issue(i + 1, stage[(i + 1) & 1]);   // overlaps this item
    cp_async_commit();
    cp_async_wait<1>();                     // this item landed
    __syncthreads();
    const WideFwdStage& st = stage[i & 1];
    const int s = i % per_tile, k0 = (i / per_tile) * WIDE_BK;
    if (s < nchunk) {                       // S += Q[:, s] K[:, s]^T
#pragma unroll
      for (int kk = 0; kk < WIDE_COLS / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, a_addr<WIDE_LD>(st.a, wr, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < WIDE_BK / 16; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, bn_addr<WIDE_LD>(st.b, np * 16, kk * 16, lane));
          mma_16816(sc[2 * np], qa, kf[0], kf[1]);
          mma_16816(sc[2 * np + 1], qa, kf[2], kf[3]);
        }
      }
    } else {                                // the online softmax, then O += P V
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int nt = 0; nt < WIDE_BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = key < Sk && (mrow == nullptr || mrow[key]) &&
                          !(causal && key > (e < 2 ? row0 : row1));
          const float x = ok ? sc[nt][e] * scale_log2 : -INFINITY;
          sc[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // all masked so far
        alpha[r] = exp2f(m_run[r] - base[r]);
        m_run[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < WIDE_BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = exp2f(sc[nt][e] - base[e >> 1]);
          rs[e >> 1] += sc[nt][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_run[r] = l_run[r] * alpha[r] + rs[r];
      }
      if (dropout) {                        // after l: dropout acts on P only
#pragma unroll
        for (int nt = 0; nt < WIDE_BK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t key = (uint32_t)(k0 + nt * 8 + 2 * t + (e & 1));
            const bool keep = hash_keep((e < 2 ? drop0 : drop1) + key, seed, threshold);
            sc[nt][e] = keep ? sc[nt][e] * inv_keep : 0.f;
          }
        }
      }
#pragma unroll
      for (int dt = 0; dt < WIDE_COLS / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < WIDE_BK / 16; ++kk) {   // 16 keys a step
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < WIDE_COLS / 16; ++dp2) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, bt_addr<WIDE_LD>(st.b, kk * 16, dp2 * 16, lane));
          mma_16816(acc[2 * dp2], pa, vf[0], vf[1]);
          mma_16816(acc[2 * dp2 + 1], pa, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < WIDE_BK / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    }
    __syncthreads();                        // the stage may be refilled
  }
  cp_async_wait<0>();

  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  if (lse != nullptr && c == 0 && t == 0) { // chunk 0 writes the statistics
    float* lb = lse + (size_t)bh * Sq;
    if (row0 < Sq)
      lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
    if (row1 < Sq)
      lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
  }
  __nv_bfloat16* ob = o + (size_t)b * o_sb + (size_t)h * o_sh + c * WIDE_COLS;
#pragma unroll
  for (int dt = 0; dt < WIDE_COLS / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * o_ss + col) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * o_ss + col) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

int launch_wide(const void* q, const void* k, const void* v, const void* mask, void* o,
                void* lse, int B, int H, int Sq, int Sk, int Dh, int q_sb, int q_sh,
                int q_ss, int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
                int o_sb, int o_sh, int o_ss, int mask_sb, int causal, float scale,
                int dropout, uint32_t seed, uint32_t threshold, float inv_keep,
                DropShard ds, cudaStream_t stream) {
  static bool configured = false;           // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + WIDE_BQ - 1) / WIDE_BQ, B * H, Dh / WIDE_COLS);
  flash_fwd_wide_kernel<<<grid, WIDE_THREADS, WIDE_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Sk, q_sb, q_sh,
      q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal,
      scale * LOG2E, dropout, seed, threshold, inv_keep, ds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: bf16 (B, H, S, Dh) with element strides (sb, sh, ss), the last
// dimension contiguous, q/k/v 16-byte aligned with strides of whole 16-byte
// units (the TMA maps' rule); Dh 64, 96 or 128 (one instance each), or a
// multiple of 128 above (the wide-head route, q, k, v rows on 16-byte
// lines); mask:
// (B, Sk) uint8 (nonzero = attend) with row stride mask_sb, or null; lse:
// contiguous f32 (B, H, Sq), or null for none. dropout != 0 turns on
// attention-weight dropout with the hash keep mask (seed, threshold) and the
// scale inv_keep = 1/(1-rate); the mask is keyed as if this call's (b, h) were
// (b + drop_b0, h + drop_h0) of drop_hg global heads (hash_dropout.cuh:
// DropShard). Returns the first error: a head dim without an
// instance, a refused tensor map, or cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int H, int Sq, int Sk, int Dh, int q_sb, int q_sh, int q_ss,
    int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
    int o_sh, int o_ss, int mask_sb, int causal, float scale, int dropout,
    uint32_t seed, uint32_t threshold, float inv_keep, int drop_b0, int drop_h0,
    int drop_hg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropShard ds{(uint32_t)drop_b0, (uint32_t)drop_h0, (uint32_t)drop_hg};
#define FWD_ARGS q, k, v, mask, o, lse, B, H, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh, \
    k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal, scale, dropout, seed, \
    threshold, inv_keep, ds, st
  switch (Dh) {
    case 64: return launch<64>(FWD_ARGS);
    case 96: return launch<96>(FWD_ARGS);
    case 128: return launch<128>(FWD_ARGS);
    default:
      if (Dh > 128 && Dh % WIDE_COLS == 0)   // the wide-head route
        return launch_wide(q, k, v, mask, o, lse, B, H, Sq, Sk, Dh, q_sb, q_sh, q_ss,
                           k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb,
                           causal, scale, dropout, seed, threshold, inv_keep, ds, st);
      return static_cast<int>(cudaErrorInvalidValue);   // no instance
  }
#undef FWD_ARGS
}
