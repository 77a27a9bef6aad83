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
// Bound on an H100: the products Q K^T and P V over the attended keys,
// 4*H*Sq*dh*sum_b(attended keys of row b) flops at 989 TFLOP/s, against Q and
// O and the attended keys' K and V rows at 3.35 TB/s: a masked key adds
// nothing to O, so it needs no product. At (8, 8, 1024, 96) with every key
// attended that is 0.026 ms of products, 6x the 0.004 ms of bytes:
// compute-bound. Under chip_smoke.py's key mask (5301 of 8192 keys) it is
// 0.017 ms.
//
// Every instance walks only the live key tiles of its block: a tile is live
// when one of its keys is attended and, under causal, some row of the block
// sees it. The loading warp reads the block's mask row 32 tiles at a time
// (LiveWalk: 4 keys a lane a load, four loads in flight), counts the
// live tiles and publishes the count with stage 0, then hands each stage's
// tile to the consumers beside its data (Smem::tile), so producer and
// consumers walk one item sequence of one length. (An end-of-walk stage
// instead made the inline loader at 256 wait once more for every warp: 5%
// with every key on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6.) A
// block with no live tile loads nothing (not even Q) and
// writes zeros and lse = -1e30, as a fully masked row always has. A skipped
// tile added exactly nothing before (its scores are -inf: alpha = 1, P =
// 0), so the skip changes no result, and the dropout index stays the flat
// one above.
//
// Head dims 64, 96 and 128: flash_fwd_hopper_kernel<FwdShape<D>> below, the
// pipeline of flash_fwd_hopper.cuh (shared with K7, flash_parts.cu) with
// the body Softmax, in FlashAttention-3's arrangement:
//   * a block of two consumer warpgroups (64 query rows each) and one
//     producer warpgroup, whose first warp issues the TMA loads (Q once, K
//     and V through a ring of STAGES stages, with the tile's key-mask bits)
//     and which gives its registers to the consumers (setmaxnreg: 40 left
//     to the producer, 224 a consumer thread);
//   * in each warpgroup, tile j's S = Q K^T is issued together with tile
//     j-1's O += P V, the softmax of tile j runs while P V is still on the
//     tensor cores, and the warpgroup waits for P V only to rescale O;
//   * between warpgroups, named barriers hand the issue of the products
//     round in turn (ping-pong), so that one warpgroup's softmax runs under
//     another's products;
//   * the elementwise body is picked a tile at a time: a tile whose keys are
//     all attended and, under causal, all visible to the warpgroup's rows
//     has no mask and no causal test; dropout is on or off; 2^x is the SFU's
//     ex2.approx;
//   * both products run on wgmma (S as m64n64k16 from shared memory, P V as
//     m64nDk16 with P from registers and V read MN-major through the
//     transpose bit). Layouts: hopper_tile.cuh.
// Tiles of BK = 64 keys, chosen on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md §6): 128 keys spill at 96 and 128 (Budget below) and, at 64,
// take 11-22% longer under CodeBERT's masks of short contracts, though
// 14% less with every key of 1024 attended. Three consumer warpgroups
// (192 rows a block) timed no faster at CodeBERT's shapes, products issued
// without turns no faster at 64 to 128, and a producer warp without
// setmaxnreg about 1% slower at 96 and 128.
//
// Head dims 192 and 256, and over 256 in chunks of them: flash_fwd_kernel
// <D, CHUNKED>, the earlier wide design with the tile walk above: two consumer
// warpgroups of 64 rows, BK = 64, a producer warp (at D = 256 warp 0 of the
// consumers loads instead: Fwd below), the products as above but issued
// and waited for one after the other. The chunked route runs one block per
// (query tile, column chunk c of the output), S computed over the full head
// dim by walking Q's and K's column chunks through the ring, O written for
// chunk c alone; each chunk's block recomputes S, so the route does
// (nchunk + 1) / 2 times the forward's products: 1.5x at 384 = 2 x 192.
//
// Budget. Shared memory: Q (128 rows x D) + STAGES x (K and V, BK x D
// each) + the mask bits, STAGES as deep as 227 KB allow (at most 4).
// Registers: a consumer thread holds O (D / 2 f32), the S tile (BK / 2
// f32) and the previous tile's P packed (BK / 4). setmaxnreg gives it 224
// at run time, but ptxas (CUDA 12.8) allocates the consumer code within
// the launch bound's 168 all the same. The wide instances: under the 168
// that 288 threads leave a thread at 192, the 255 of 256 threads at 256
// (Fwd below). ptxas -v must show no spill in any instance.
//
// Semantics (the JAX kernel's): a masked key gets -inf; a fully-masked row
// gives zeros and lse = -1e30 (the JAX kernel's m + log(1) with its finite
// -1e30 mask); causal means key j is visible to query i iff j <= i
// (top-left aligned when Sq != Sk).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_hopper.cuh"
#include "hash_dropout.cuh"
#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace hopper;

constexpr float LN2 = 0.6931471805599453f;

// ---- head dims 64, 96 and 128: the body of flash_fwd_hopper.cuh's pipeline ----

// K1's body (flash_fwd_hopper.cuh's hooks): the online softmax on the
// stage's key-mask bits, O rescaled by alpha; the epilogue writes O / l and
// lse, a fully masked row zeros and lse = -1e30.
template <class C>
struct Softmax {
  // The softmax body for this tile: EDGE when a key is masked (not all bits
  // of kb set), under causal when a key follows the warpgroup's first row,
  // and whenever the scale is not > 0 (the interior body's max needs it).
  static __device__ __forceinline__ void tile(float (&sc)[BK / 2],
                                              const uint32_t (&kb)[C::WORDS], int k0,
                                              int wrow, int row0, int t, const FwdArgs& a,
                                              uint32_t drop0, float (&m_run)[2],
                                              float (&l_run)[2], float (&alpha)[2]) {
    bool all = true;
#pragma unroll
    for (int u = 0; u < C::WORDS; ++u) all = all && kb[u] == ~0u;
    const bool edge = !all || (a.causal && k0 + BK - 1 > wrow) || !(a.scale_log2 > 0.f);
    if (a.dropout) {
      if (edge)
        fwd_softmax<C, true, true>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
      else
        fwd_softmax<C, false, true>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
    } else {
      if (edge)
        fwd_softmax<C, true, false>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
      else
        fwd_softmax<C, false, false>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
    }
  }

  static __device__ __forceinline__ void rescale(float (&acc)[C::D / 2],
                                                 const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < C::D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }

  static __device__ __forceinline__ void store(const float (&acc)[C::D / 2], const FwdArgs& a,
                                               int b, int h, int row0, int row1, int t,
                                               const float (&m_run)[2],
                                               const float (&l_run)[2]) {
    const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
    const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
    const int bh = b * a.H + h;
    if (a.lse != nullptr && t == 0) {       // one lane a row writes it
      float* lb = a.lse + (size_t)bh * a.Sq;
      if (row0 < a.Sq)
        lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
      if (row1 < a.Sq)
        lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
    }
    __nv_bfloat16* ob = a.o + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
#pragma unroll
    for (int dt = 0; dt < C::D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (row0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * a.o_ss + col) =
            __floats2bfloat162_rn(acc[dt * 4] * inv0, acc[dt * 4 + 1] * inv0);
      if (row1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * a.o_ss + col) =
            __floats2bfloat162_rn(acc[dt * 4 + 2] * inv1, acc[dt * 4 + 3] * inv1);
    }
  }
};

// One block a (query tile of BQ rows, b, h), walking its live key tiles.
template <class C>
__global__ void __launch_bounds__(C::NTHREADS, 1)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ FwdArgs a) {
  fwd_block<C, Softmax<C>>(q_map, k_map, v_map, a);
}


template <class C>
int launch_hopper(const void* q, const void* k, const void* v, const FwdArgs& a, int B,
                  int q_sb, int q_sh, int q_ss, int k_sb, int k_sh, int k_ss, int v_sb,
                  int v_sh, int v_ss, cudaStream_t stream) {
  constexpr int bytes = sizeof(FwdSmem<C>) + 1024;   // + alignment slack
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the limit");
  CUtensorMap qm, km, vm;
  int err = make_head_map(&qm, q, B, a.H, a.Sq, C::D, q_sb, q_sh, q_ss, C::BQ);
  if (err == 0) err = make_head_map(&km, k, B, a.H, a.Sk, C::D, k_sb, k_sh, k_ss, BK);
  if (err == 0) err = make_head_map(&vm, v, B, a.H, a.Sk, C::D, v_sb, v_sh, v_ss, BK);
  if (err != 0) return err;
  static bool configured = false;           // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_hopper_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, B * a.H);
  flash_fwd_hopper_kernel<C><<<grid, C::NTHREADS, bytes, stream>>>(qm, km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- head dims 192 and 256, and the chunked route over 256 -------------------------

constexpr int BQ = 128;                     // query rows per block
constexpr int NCONSUMERS = 8;               // warps in the two warpgroups
constexpr int Q_CHUNK = BQ * CHUNK_BYTES_ROW;
constexpr int KV_CHUNK = BK * CHUNK_BYTES_ROW;

// The shape of an instance: D is the head dim, or with CHUNKED the column
// chunk of a head dim over 256 (the chunked route above).
//   * native: Q (BQ x D) stays in shared memory; a ring stage holds the K
//     and V tiles (BK x D each);
//   * chunked: a ring stage holds D columns of Q and K (a score item) and,
//     on a tile's last item, V's D columns of the block's own chunk.
// STAGES is as deep as the 227 KB allow, at most 3: 3 at 192, 2 at 256;
// chunked 2 at 192 and 1 at 256.
// Who loads (INLINE): at 192 a producer warp. Its nine warps put three on
// one of the SM's four register files (16K registers each), which caps
// every thread at 168 registers: 192 fits (168, no spill), but at 256 a
// consumer thread holds the O accumulator (128 f32) and the S tile (32)
// and needs ~230. So at 256 the block is the two consumer warpgroups alone
// (256 threads, up to 255 registers a thread) and their warp 0 issues the
// loads: the first STAGES items before its first tile, then each item's
// refill once every consumer warp has released the stage. That ties
// warpgroup 0 to warpgroup 1 at each tile: at 192 the inline loads were
// slower on an NVIDIA H100 80GB HBM3 at 700 W (0.0833 against 0.0732 ms
// at (8, 4, 1024, 192)), so
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
  int tile[F::STAGES];                      // the item's key tile
  int n_live;                               // live tiles: published with stage 0
  uint64_t q_full, full[F::STAGES], empty[F::STAGES];
};
template <int D, bool CHUNKED>
constexpr int smem_bytes() { return sizeof(Smem<D, CHUNKED>) + 1024; }   // + alignment slack

// Warp-wide: wait until the stage of ring item `item` is free, write its
// key-mask bias (0 or -inf; -inf past Sk) and key tile j, and (lane 0) start
// its loads: the item is score item `it` of tile j, whose K (and, chunked,
// Q) columns are chunk (c + 1 + it) % nchunk, the block's own chunk c last;
// a tile's last item also loads V's chunk c.
template <int D, bool CHUNKED>
__device__ __forceinline__ void fwd_issue(Smem<D, CHUNKED>& s, const CUtensorMap* q_map,
                                          const CUtensorMap* k_map, const CUtensorMap* v_map,
                                          const uint8_t* mrow, int item, int j, int it,
                                          int nchunk, int c, int q0, int h, int b, int Sk,
                                          int lane) {
  using F = Fwd<D, CHUNKED>;
  const int st = item % F::STAGES;
  const int k0 = j * BK, ka = k0 + lane, kb = ka + 32;
  const bool last = it == nchunk - 1;
  const int col = ((c + 1 + it) % nchunk) * D;   // 0 when native
  mbar_wait(&s.empty[st], ((item / F::STAGES) & 1) ^ 1);   // the stage is free
  s.bias[st][lane] = ka < Sk && (mrow == nullptr || mrow[ka]) ? 0.f : -INFINITY;
  s.bias[st][lane + 32] = kb < Sk && (mrow == nullptr || mrow[kb]) ? 0.f : -INFINITY;
  if (lane == 0) {
    s.tile[st] = j;
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
  Smem<D, CHUNKED>& s = aligned_smem<Smem<D, CHUNKED>>(smem_raw);
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
      mbar_init(&s.full[i], 32);            // the loading warp's lanes
      mbar_init(&s.empty[i], NCONSUMERS);   // one lane a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The loading warp walks the live tiles: it counts them first and
  // publishes the count with stage 0; `cur` is the tile it loads next,
  // `cur_it` that tile's next score item, `issued` the next ring item.
  const bool loader = warp == (F::INLINE ? 0 : NCONSUMERS);
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;
  LiveWalk walk(mrow, Sk, n_tiles);
  int cur = 0, cur_it = 0, issued = 0, n_items = 0;
  if (loader) {
    const int n_live = walk.count(lane);
    n_items = n_live * nchunk;
    cur = walk.next(lane);
    if (lane == 0) s.n_live = n_live;       // released by lane 0's first arrival
    if (n_live == 0) {
      mbar_arrive(&s.full[0]);              // nothing to load: stage 0 says so
    } else if (!CHUNKED && lane == 0) {     // Q, once the block has a live tile
      mbar_arrive_expect_tx(&s.q_full, F::Q_BYTES);
#pragma unroll
      for (int ch = 0; ch < NCHUNK; ++ch)
        tma_load_4d(s.q[0][ch], &q_map, &s.q_full, ch * CHUNK_COLS, q0, h, b);
    }
  }
  auto issue_next = [&]() {                 // the loading warp's next ring item
    if (issued == n_items) return;
    fwd_issue(s, &q_map, &k_map, &v_map, mrow, issued++, cur, cur_it, nchunk, c, q0, h, b,
              Sk, lane);
    if (++cur_it == nchunk) {
      cur_it = 0;
      cur = walk.next(lane);
    }
  };
  if (loader) {   // the producer warp loads every item; warp 0 the first STAGES
    if constexpr (!F::INLINE) {
      while (issued < n_items) issue_next();
      return;
    } else {
      for (int i = 0; i < STAGES; ++i) issue_next();
    }
  }
  // warp 0 (INLINE): refill the stage this warp has just released
  auto refill = [&]() {
    if (F::INLINE && warp == 0) issue_next();
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

  mbar_wait(&s.full[0], 0);
  const int n_live = s.n_live;
  if (!CHUNKED && n_live > 0) mbar_wait(&s.q_full, 0);
  for (int n = 0; n < n_live; ++n) {        // the walk's n-th live tile
    const int item0 = n * nchunk;
    float sc[32];                           // S = Q K^T, 64 x 64 per warpgroup
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    int st = 0;
    for (int it = 0; it < nchunk; ++it) {   // one score item per chunk (native: one)
      const int item = item0 + it;
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
        refill();
      }
    }

    const int k0 = s.tile[st] * BK;         // the tile's last item: still held
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
    refill();
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
  const FwdArgs a{static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(o),
                  static_cast<float*>(lse), H, Sq, Sk, o_sb, o_sh, o_ss, mask_sb, causal,
                  scale * LOG2E, dropout, seed, threshold, inv_keep, ds};
#define HOPPER_ARGS q, k, v, a, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, st
#define FWD_ARGS q, k, v, mask, o, lse, B, H, Sq, Sk, Dh, q_sb, q_sh, q_ss, k_sb, \
    k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal, scale, dropout, \
    seed, threshold, inv_keep, ds, st
  switch (Dh) {
    case 64: return launch_hopper<FwdShape<64>>(HOPPER_ARGS);
    case 96: return launch_hopper<FwdShape<96>>(HOPPER_ARGS);
    case 128: return launch_hopper<FwdShape<128>>(HOPPER_ARGS);
    case 192: return launch<192, false>(FWD_ARGS);
    case 256: return launch<256, false>(FWD_ARGS);
    default:
      if (Dh > 256 && Dh % 256 == 0) return launch<256, true>(FWD_ARGS);
      if (Dh > 256 && Dh % 192 == 0) return launch<192, true>(FWD_ARGS);
      return static_cast<int>(cudaErrorInvalidValue);   // no route takes it
  }
#undef FWD_ARGS
#undef HOPPER_ARGS
}
