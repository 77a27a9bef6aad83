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
// Head dims: one instance each for D = 64, 96, 128, 192 and 256 (the
// template parameter below); the wrapper pads any other D <= 256 to the
// next one. A head dim over 256, padded by the wrapper to a multiple of 256
// or of 192, runs the chunked route (CHUNKED below): one block per (query
// tile, column chunk c of the output), S computed over the full head dim
// by walking Q's and K's column chunks through the ring, O written for
// chunk c alone. Each chunk's block recomputes S, so the route does
// (nchunk + 1) / 2 times the forward's products: 1.5x at 384 = 2 x 192.
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
//     one producer warp (288 threads; at D = 256 warp 0 of the consumers
//     loads instead: Fwd below);
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
// Budget, at D = 96 (64; 128; 192; 256). Shared memory: Q 24 (16; 32; 48;
// 64) KB + STAGES x (K and V 24 (16; 32; 48; 64) KB + 256 B of bias) +
// barriers + 1 KB of alignment slack = 98 (66; 130; 194; 194) KB at
// STAGES = 3 (3; 3; 3; 2), one block an SM. Registers: a consumer thread
// holds the O accumulator (D / 2 f32: 48, 32, 64, 96 or 128), the S tile
// (32 f32), P packed (16) and its row statistics: under the 168 that 288
// threads leave each up to D = 192, under the 255 of 256 threads at 256
// (Fwd below). ptxas -v must show no spills in any instance.
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
constexpr int NCONSUMERS = 8;               // warps in the two warpgroups
constexpr int Q_CHUNK = BQ * CHUNK_BYTES_ROW;
constexpr int KV_CHUNK = BK * CHUNK_BYTES_ROW;
constexpr int SMEM_LIMIT = 232448;          // bytes of shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The shape of an instance: D is the head dim, or with CHUNKED the column
// chunk of a head dim over 256 (the chunked route below).
//   * native: Q (BQ x D) stays in shared memory; a ring stage holds the K
//     and V tiles (BK x D each);
//   * chunked: a ring stage holds D columns of Q and K (a score item) and,
//     on a tile's last item, V's D columns of the block's own chunk.
// STAGES is as deep as the 227 KB allow, at most 3: 3 at D <= 192, 2 at
// 256; chunked 2 at 192 and 1 at 256.
// Who loads (INLINE): up to 192 a producer warp. Its nine warps put three
// on one of the SM's four register files (16K registers each), which caps
// every thread at 168 registers: 192 fits (168, no spill), but at 256 a
// consumer thread holds the O accumulator (128 f32) and the S tile (32)
// and needs ~230. So at 256 the block is the two consumer warpgroups alone
// (256 threads, up to 255 registers a thread) and their warp 0 issues the
// loads: the first STAGES items before its first tile, then each item's
// refill once every consumer warp has released the stage. That ties
// warpgroup 0 to warpgroup 1 at each tile: at 192 the inline loads were
// slower on an H100 (0.0833 against 0.0732 ms at (8, 4, 1024, 192)), so
// 192 keeps the producer warp.
template <int D, bool CHUNKED>
struct Fwd {
  static constexpr int NCHUNK = D / CHUNK_COLS;   // 32-column swizzled boxes a row
  static constexpr int Q_BYTES = NCHUNK * Q_CHUNK, KV_BYTES = NCHUNK * KV_CHUNK;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + (CHUNKED ? Q_BYTES : 0) + BK * 4;
  static constexpr int FREE = SMEM_LIMIT - 2048 - (CHUNKED ? 0 : Q_BYTES);
  static constexpr int STAGES = FREE / STAGE_BYTES < 3 ? FREE / STAGE_BYTES : 3;
  static constexpr bool INLINE = D == 256;
  static constexpr int NTHREADS = NCONSUMERS * 32 + (INLINE ? 0 : 32);
  static_assert(STAGES >= 1, "no ring stage fits");
};

template <int D, bool CHUNKED>
struct Smem {
  using F = Fwd<D, CHUNKED>;
  alignas(1024) unsigned char q[CHUNKED ? F::STAGES : 1][F::NCHUNK][Q_CHUNK];
  alignas(1024) unsigned char k[F::STAGES][F::NCHUNK][KV_CHUNK];
  alignas(1024) unsigned char v[F::STAGES][F::NCHUNK][KV_CHUNK];
  float bias[F::STAGES][BK];
  uint64_t q_full, full[F::STAGES], empty[F::STAGES];
};
template <int D, bool CHUNKED>
constexpr int smem_bytes() { return sizeof(Smem<D, CHUNKED>) + 1024; }   // + alignment slack

template <int D, bool CHUNKED>
__device__ __forceinline__ Smem<D, CHUNKED>& smem_tile(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<Smem<D, CHUNKED>*>(raw + pad);
}

// Warp-wide: wait until the stage of ring item `item` is free, write its
// key-mask bias (0 or -inf; -inf past Sk), and (lane 0) start its loads:
// item = j * nchunk + it is score item `it` of key tile j, whose K (and,
// chunked, Q) columns are chunk (c + 1 + it) % nchunk, the block's own
// chunk c last; a tile's last item also loads V's chunk c.
template <int D, bool CHUNKED>
__device__ __forceinline__ void fwd_issue(Smem<D, CHUNKED>& s, const CUtensorMap* q_map,
                                          const CUtensorMap* k_map, const CUtensorMap* v_map,
                                          const uint8_t* mrow, int item, int nchunk, int c,
                                          int q0, int h, int b, int Sk, int lane) {
  using F = Fwd<D, CHUNKED>;
  const int it = item % nchunk, st = item % F::STAGES;
  const int k0 = item / nchunk * BK, ka = k0 + lane, kb = ka + 32;
  const bool last = it == nchunk - 1;
  const int col = ((c + 1 + it) % nchunk) * D;   // 0 when native
  mbar_wait(&s.empty[st], ((item / F::STAGES) & 1) ^ 1);   // the stage is free
  s.bias[st][lane] = ka < Sk && (mrow == nullptr || mrow[ka]) ? 0.f : -INFINITY;
  s.bias[st][lane + 32] = kb < Sk && (mrow == nullptr || mrow[kb]) ? 0.f : -INFINITY;
  if (lane == 0) {
    mbar_arrive_expect_tx(&s.full[st], F::KV_BYTES * (last ? 2 : 1) +
                                           (CHUNKED ? F::Q_BYTES : 0));
#pragma unroll
    for (int ch = 0; ch < F::NCHUNK; ++ch) {
      if constexpr (CHUNKED)
        tma_load_4d(s.q[st][ch], q_map, &s.full[st], col + ch * CHUNK_COLS, q0, h, b);
      tma_load_4d(s.k[st][ch], k_map, &s.full[st], col + ch * CHUNK_COLS, k0, h, b);
      if (last)
        tma_load_4d(s.v[st][ch], v_map, &s.full[st], c * D + ch * CHUNK_COLS, k0, h, b);
    }
  } else {
    mbar_arrive(&s.full[st]);
  }
}

template <int D, bool CHUNKED>
__global__ void __launch_bounds__(Fwd<D, CHUNKED>::NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int o_sb,
                 int o_sh, int o_ss, int mask_sb, int causal, float scale_log2,
                 int dropout, uint32_t seed, uint32_t threshold, float inv_keep,
                 DropShard ds) {
  using F = Fwd<D, CHUNKED>;
  constexpr int NCHUNK = F::NCHUNK, STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  Smem<D, CHUNKED>& s = smem_tile<D, CHUNKED>(smem_raw);
  // chunked: the head dim is nchunk chunks of D, and this block writes chunk c
  const int nchunk = CHUNKED ? gridDim.z : 1, c = CHUNKED ? blockIdx.z : 0;
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

  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;
  const int n_items = n_tiles * nchunk;
  if (warp == (F::INLINE ? 0 : NCONSUMERS)) {   // the loading warp's first items
    if (!CHUNKED && lane == 0) {
      mbar_arrive_expect_tx(&s.q_full, F::Q_BYTES);
#pragma unroll
      for (int ch = 0; ch < NCHUNK; ++ch)
        tma_load_4d(s.q[0][ch], &q_map, &s.q_full, ch * CHUNK_COLS, q0, h, b);
    }
    // the producer warp loads every item; warp 0 the first STAGES
    for (int i = 0; i < (F::INLINE ? min(n_items, STAGES) : n_items); ++i)
      fwd_issue(s, &q_map, &k_map, &v_map, mrow, i, nchunk, c, q0, h, b, Sk, lane);
    if (!F::INLINE) return;
  }
  // warp 0 (INLINE): refill the stage of `item`, which this warp has released
  auto refill = [&](int item) {
    if (F::INLINE && warp == 0 && item + STAGES < n_items)
      fwd_issue(s, &q_map, &k_map, &v_map, mrow, item + STAGES, nchunk, c, q0, h, b, Sk,
                lane);
  };

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

  if (!CHUNKED) mbar_wait(&s.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    float sc[32];                           // S = Q K^T, 64 x 64 per warpgroup
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    int st = 0;
    for (int it = 0; it < nchunk; ++it) {   // one score item per chunk (native: one)
      const int item = j * nchunk + it;
      st = item % STAGES;
      mbar_wait(&s.full[st], (item / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int ch = ks / 2, off = (ks % 2) * 32;
        const uint64_t da = desc_b64(
            &s.q[CHUNKED ? st : 0][ch][wg * 64 * CHUNK_BYTES_ROW + off], 16, 512);
        const uint64_t db = desc_b64(&s.k[st][ch][off], 16, 512);
        wgmma_m64n64k16_ss(sc, da, db, it > 0 || ks > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      if (it + 1 < nchunk) {                // a score item's stage is done
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[st]);
        refill(item);
      }
    }

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
    refill((j + 1) * nchunk - 1);
  }

  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  if (lse != nullptr && c == 0 && t == 0) { // one lane per row (chunk 0's) writes it
    float* lb = lse + (size_t)bh * Sq;
    if (row0 < Sq)
      lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
    if (row1 < Sq)
      lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
  }
  __nv_bfloat16* ob = o + (size_t)b * o_sb + (size_t)h * o_sh + c * D;
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

// Dh is the full head dim: D itself, or nchunk * D when CHUNKED.
template <int D, bool CHUNKED>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o,
           void* lse, int B, int H, int Sq, int Sk, int Dh, int q_sb, int q_sh,
           int q_ss, int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
           int o_sb, int o_sh, int o_ss, int mask_sb, int causal, float scale,
           int dropout, uint32_t seed, uint32_t threshold, float inv_keep,
           DropShard ds, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, CHUNKED>();
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the limit");
  CUtensorMap qm, km, vm;
  int err = make_head_map(&qm, q, B, H, Sq, Dh, q_sb, q_sh, q_ss, BQ);
  if (err == 0) err = make_head_map(&km, k, B, H, Sk, Dh, k_sb, k_sh, k_ss, BK);
  if (err == 0) err = make_head_map(&vm, v, B, H, Sk, Dh, v_sb, v_sh, v_ss, BK);
  if (err != 0) return err;
  static bool configured = false;           // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H, Dh / D);
  flash_fwd_kernel<D, CHUNKED><<<grid, Fwd<D, CHUNKED>::NTHREADS, bytes, stream>>>(
      qm, km, vm, static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Sk, o_sb, o_sh, o_ss, mask_sb, causal,
      scale * LOG2E, dropout, seed, threshold, inv_keep, ds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: bf16 (B, H, S, Dh) with element strides (sb, sh, ss), the last
// dimension contiguous, q/k/v 16-byte aligned with strides of whole 16-byte
// units (the TMA maps' rule); Dh 64, 96, 128, 192 or 256 (one instance
// each), or over 256 a multiple of 256 or of 192 (the chunked route, in
// chunks of 256 where both divide it); mask: (B, Sk) uint8 (nonzero =
// attend) with row stride mask_sb, or null; lse: contiguous f32 (B, H, Sq),
// or null for none. dropout != 0 turns on attention-weight dropout with the
// hash keep mask (seed, threshold) and the scale inv_keep = 1/(1-rate); the
// mask is keyed as if this call's (b, h) were (b + drop_b0, h + drop_h0) of
// drop_hg global heads (hash_dropout.cuh: DropShard). Returns the first
// error: a head dim no route takes, a refused tensor map, or
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int H, int Sq, int Sk, int Dh, int q_sb, int q_sh, int q_ss,
    int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
    int o_sh, int o_ss, int mask_sb, int causal, float scale, int dropout,
    uint32_t seed, uint32_t threshold, float inv_keep, int drop_b0, int drop_h0,
    int drop_hg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropShard ds{(uint32_t)drop_b0, (uint32_t)drop_h0, (uint32_t)drop_hg};
#define FWD_ARGS q, k, v, mask, o, lse, B, H, Sq, Sk, Dh, q_sb, q_sh, q_ss, k_sb, \
    k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal, scale, dropout, \
    seed, threshold, inv_keep, ds, st
  switch (Dh) {
    case 64: return launch<64, false>(FWD_ARGS);
    case 96: return launch<96, false>(FWD_ARGS);
    case 128: return launch<128, false>(FWD_ARGS);
    case 192: return launch<192, false>(FWD_ARGS);
    case 256: return launch<256, false>(FWD_ARGS);
    default:
      if (Dh > 256 && Dh % 256 == 0) return launch<256, true>(FWD_ARGS);
      if (Dh > 256 && Dh % 192 == 0) return launch<192, true>(FWD_ARGS);
      return static_cast<int>(cudaErrorInvalidValue);   // no route takes it
  }
#undef FWD_ARGS
}
