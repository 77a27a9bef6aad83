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
// Head dims 64, 96 and 128: flash_fwd_hopper_kernel<FwdShape<D>> below, in
// FlashAttention-3's arrangement:
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

#include "hash_dropout.cuh"
#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace hopper;

constexpr int SMEM_LIMIT = 232448;          // bytes of shared memory a block may use
constexpr int BK = 64;                      // keys a K/V tile, every instance
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---- the walk over live key tiles ---------------------------------------------

// Bit i: tile w + i (of the up to 32 from w below n_tiles) of BK keys holds
// an attended key. Warp-wide: each lane reads 4 mask bytes a load (one
// 32-bit load where the row is 4-byte aligned and the 4 keys lie below the
// window's end), four loads in flight, so 512 keys cost one round trip
// (eight in flight pushed the 192 instance to a spill); one vote a 128-key
// load, split into its four 32-key units.
__device__ __forceinline__ uint32_t live_window(const uint8_t* mrow, int w, int n_tiles,
                                                int Sk, int lane) {
  const int count = min(32, n_tiles - w);
  if (mrow == nullptr) return count == 32 ? ~0u : (1u << count) - 1u;
  const int base = w * BK, end = min(Sk, (w + count) * BK);   // the window's keys
  const bool aligned = (reinterpret_cast<uintptr_t>(mrow) & 3u) == 0;
  uint32_t bits = 0;
  for (int k0 = base; k0 < end; k0 += 512) {
    uint32_t word[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = k0 + e * 128 + lane * 4;
      if (aligned && j + 3 < end) {
        word[e] = *reinterpret_cast<const uint32_t*>(mrow + j);
      } else {
        word[e] = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < end && mrow[j + q] != 0) word[e] = 1;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t on = __ballot_sync(0xffffffffu, word[e] != 0);   // lane l: 4 keys
#pragma unroll
      for (int u = 0; u < 4; ++u) {         // 32-key unit u: lanes 8u .. 8u + 7
        const int key = k0 + e * 128 + u * 32;
        if (((on >> (8 * u)) & 0xffu) && key < end) bits |= 1u << ((key - base) / BK);
      }
    }
  }
  return bits;
}

// The live tiles of a block's key range [0, n_tiles * BK), in order, for the
// warp that loads them (every tile when there is no mask). Warp-uniform.
struct LiveWalk {
  const uint8_t* mrow;                      // the batch row's mask, or null
  int Sk, n_tiles;
  int w;                                    // first tile of the window held
  uint32_t bits;                            // its live tiles not yet walked

  __device__ LiveWalk(const uint8_t* m, int sk, int n)
      : mrow(m), Sk(sk), n_tiles(n), w(-32), bits(0) {}

  // how many tiles are live (all of them, from the first window on)
  __device__ int count(int lane) const {
    int n = 0;
    for (int w0 = 0; w0 < n_tiles; w0 += 32)
      n += __popc(live_window(mrow, w0, n_tiles, Sk, lane));
    return n;
  }

  // the next live tile, or -1 after the last
  __device__ int next(int lane) {
    while (bits == 0) {
      w += 32;
      if (w >= n_tiles) return -1;
      bits = live_window(mrow, w, n_tiles, Sk, lane);
    }
    const int j = w + __ffs(bits) - 1;
    bits &= bits - 1;
    return j;
  }
};

// ---- head dims 64, 96 and 128 --------------------------------------------------

struct FwdArgs {
  const uint8_t* mask;                      // (B, Sk) nonzero = attend, or null
  __nv_bfloat16* o;
  float* lse;                               // (B, H, Sq), or null
  int H, Sq, Sk, o_sb, o_sh, o_ss, mask_sb, causal;
  float scale_log2;
  int dropout;
  uint32_t seed, threshold;
  float inv_keep;
  DropShard ds;
};

// A head dim's instance: two consumer warpgroups of 64 query rows (BQ =
// 128 rows a block), BK keys a tile.
template <int D_>
struct FwdShape {
  static constexpr int D = D_, NWG = 2, BQ = 64 * NWG;
  static constexpr int NCHUNK = D / CHUNK_COLS;   // 32-column swizzled boxes a row
  static constexpr int Q_CHUNK = BQ * CHUNK_BYTES_ROW, KV_CHUNK = BK * CHUNK_BYTES_ROW;
  static constexpr int Q_BYTES = NCHUNK * Q_CHUNK, KV_BYTES = NCHUNK * KV_CHUNK;
  static constexpr int WORDS = BK / 32;           // key-mask words a tile
  static constexpr int FREE = SMEM_LIMIT - 2048 - Q_BYTES;
  static constexpr int STAGES = FREE / (2 * KV_BYTES) < 4 ? FREE / (2 * KV_BYTES) : 4;
  static constexpr int NTHREADS = 128 * (NWG + 1);
  // The launch gives each thread 65536 / NTHREADS = 168 registers; the
  // producer warpgroup keeps 40 and the consumer warpgroups take what it
  // gives back.
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 224;
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(128 * PRODUCER_REGS + 128 * NWG * CONSUMER_REGS <= 65536,
                "more registers than the SM has");
};

template <class C>
struct FwdSmem {
  alignas(1024) unsigned char q[C::NCHUNK][C::Q_CHUNK];
  alignas(1024) unsigned char k[C::STAGES][C::NCHUNK][C::KV_CHUNK];
  alignas(1024) unsigned char v[C::STAGES][C::NCHUNK][C::KV_CHUNK];
  uint32_t bits[C::STAGES][C::WORDS];       // bit i of word u: key k0 + 32u + i attended
  int tile[C::STAGES];                      // the stage's first key k0
  int n_live;                               // live tiles: published with stage 0
  uint64_t q_full, full[C::STAGES], empty[C::STAGES];
};

template <class T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

// The producer warp: the count of live tiles, Q once the block has one,
// then each live tile's K, V and key-mask bits into the ring.
template <class C>
__device__ __forceinline__ void fwd_produce(FwdSmem<C>& s, const CUtensorMap* q_map,
                                            const CUtensorMap* k_map,
                                            const CUtensorMap* v_map, const FwdArgs& a,
                                            int q0, int b, int h, int lane) {
  constexpr int STAGES = C::STAGES;
  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + C::BQ - 1) / BK + 1);
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  LiveWalk walk(mrow, a.Sk, n_tiles);
  const int n_live = walk.count(lane);
  if (lane == 0) s.n_live = n_live;         // released by lane 0's first arrival
  if (n_live == 0) {                        // nothing to load: stage 0 says so
    mbar_arrive(&s.full[0]);
    return;
  }
  if (lane == 0) {                          // Q, once the block has a live tile
    mbar_arrive_expect_tx(&s.q_full, C::Q_BYTES);
#pragma unroll
    for (int ch = 0; ch < C::NCHUNK; ++ch)
      tma_load_4d(s.q[ch], q_map, &s.q_full, ch * CHUNK_COLS, q0, h, b);
  }
  for (int item = 0; item < n_live; ++item) {
    const int k0 = walk.next(lane) * BK, st = item % STAGES;
    uint32_t kb[C::WORDS];
#pragma unroll
    for (int u = 0; u < C::WORDS; ++u) {
      const int key = k0 + 32 * u + lane;
      kb[u] = __ballot_sync(0xffffffffu, key < a.Sk && (mrow == nullptr || mrow[key] != 0));
    }
    mbar_wait(&s.empty[st], ((item / STAGES) & 1) ^ 1);   // the stage is free
    if (lane == 0) {
      s.tile[st] = k0;
#pragma unroll
      for (int u = 0; u < C::WORDS; ++u) s.bits[st][u] = kb[u];
      mbar_arrive_expect_tx(&s.full[st], 2 * C::KV_BYTES);
#pragma unroll
      for (int ch = 0; ch < C::NCHUNK; ++ch) {
        tma_load_4d(s.k[st][ch], k_map, &s.full[st], ch * CHUNK_COLS, k0, h, b);
        tma_load_4d(s.v[st][ch], v_map, &s.full[st], ch * CHUNK_COLS, k0, h, b);
      }
    } else {
      mbar_arrive(&s.full[st]);
    }
  }
}

// S = Q K^T of the warpgroup's 64 rows and the stage's BK keys; issues D / 16
// wgmma, no commit.
template <class C>
__device__ __forceinline__ void fwd_scores(float (&sc)[BK / 2], const FwdSmem<C>& s,
                                           int st, int wg) {
#pragma unroll
  for (int ks = 0; ks < C::D / 16; ++ks) {
    const int ch = ks / 2, off = (ks % 2) * 32;
    const uint64_t da = desc_b64(&s.q[ch][wg * 64 * CHUNK_BYTES_ROW + off], 16, 512);
    const uint64_t db = desc_b64(&s.k[st][ch][off], 16, 512);
    wgmma_m64n64k16_ss(sc, da, db, ks > 0);
  }
}

// O += P V over the stage's BK keys, P packed in the score layout (p[4 kk +
// r] is A register r of k-step kk); issues BK / 16 wgmma, no commit.
template <class C>
__device__ __forceinline__ void fwd_pv(float (&acc)[C::D / 2], const uint32_t (&p)[BK / 4],
                                       const FwdSmem<C>& s, int st) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs(acc, pa, desc_b64(&s.v[st][0][kk * 16 * CHUNK_BYTES_ROW], C::KV_CHUNK, 512));
  }
}

// The online softmax of one S tile, in place: element x = 4 nt + e of a
// thread is row row0 + 8 (e / 2), key k0 + 8 nt + 2t + (e % 2). EDGE: the
// tile has a masked key (bit of kb clear) or, under causal, a key after one
// of the warpgroup's rows: tested element by element, on scaled scores. An
// interior tile takes the row max of the raw scores and folds the scale
// into the exponent's FMA, 2^(s * scale - m): one instruction an element
// less, which measured faster on an NVIDIA H100 80GB HBM3 at 700 W; that
// needs scale > 0, and any
// other scale takes the EDGE body. Leaves P (dropped when DROP) in sc and the factor
// that rescales O in alpha.
template <class C, bool EDGE, bool DROP>
__device__ __forceinline__ void fwd_softmax(float (&sc)[BK / 2],
                                            const uint32_t (&kb)[C::WORDS], int k0,
                                            int row0, int t, const FwdArgs& a,
                                            uint32_t drop0, float (&m_run)[2],
                                            float (&l_run)[2], float (&alpha)[2]) {
  // two chains a row for the max and the sum: half the dependent steps
  float mx2[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    const uint32_t on = kb[nt / 4] >> ((nt % 4) * 8 + 2 * t);   // keys 8 nt + 2t, + 1
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[nt * 4 + e];
      if constexpr (EDGE) {
        x *= a.scale_log2;
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        if (!((on >> (e & 1)) & 1u) || (a.causal && key > row0 + 8 * (e >> 1)))
          x = -INFINITY;
        sc[nt * 4 + e] = x;
      }
      mx2[e >> 1][e & 1] = fmaxf(mx2[e >> 1][e & 1], x);
    }
  }
  float mx[2] = {fmaxf(mx2[0][0], mx2[0][1]), fmaxf(mx2[1][0], mx2[1][1])};
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if constexpr (!EDGE) mx[i] *= a.scale_log2;   // the raw max: the scale is > 0 here
    mx[i] = fmaxf(mx[i], m_run[i]);
    base[i] = mx[i] == -INFINITY ? 0.f : mx[i];   // all masked so far
    alpha[i] = fast_exp2(m_run[i] - base[i]);
    m_run[i] = mx[i];
  }
  float rs2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if constexpr (EDGE)
      sc[i] = fast_exp2(sc[i] - base[(i >> 1) & 1]);
    else
      sc[i] = fast_exp2(fmaf(sc[i], a.scale_log2, -base[(i >> 1) & 1]));
    rs2[(i >> 1) & 1][i & 1] += sc[i];
  }
  float rs[2] = {rs2[0][0] + rs2[0][1], rs2[1][0] + rs2[1][1]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l_run[i] = l_run[i] * alpha[i] + rs[i];
  }
  if constexpr (DROP) {                     // after l: dropout acts on P only
    const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const uint32_t key = (uint32_t)(k0 + (i >> 2) * 8 + 2 * t + (i & 1));
      const bool keep = hash_keep((((i >> 1) & 1) ? drop1 : drop0) + key, a.seed, a.threshold);
      sc[i] = keep ? sc[i] * a.inv_keep : 0.f;
    }
  }
}

// The softmax body for this tile: EDGE when a key is masked (not all bits
// of kb set), under causal when a key follows the warpgroup's first row,
// and whenever the scale is not > 0 (the interior body's max needs it).
template <class C>
__device__ __forceinline__ void fwd_softmax_tile(float (&sc)[BK / 2],
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

// Named barriers 1 .. NWG: barrier 1 + w is warpgroup w's turn to issue.
constexpr int TURN_BAR = 1;

// A consumer warpgroup: rows q0 + 64 wg .. + 63. The first live tile is
// peeled off the walk, so that inside it every wgmma is issued and waited
// for unconditionally: S of tile j with P V of tile j-1, the softmax of j
// while P V runs, then O rescaled once P V is done.
template <class C>
__device__ __forceinline__ void fwd_consume(FwdSmem<C>& s, const FwdArgs& a, int q0, int b,
                                            int h, int wg, int lane) {
  constexpr int D = C::D, STAGES = C::STAGES;
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;    // accumulator group / thread-in-group
  const int wrow = q0 + wg * 64;
  const int row0 = wrow + warp * 16 + g, row1 = row0 + 8;
  // flat dropout index of (b, h, row0, 0) over the true Sq, Sk
  const uint32_t drop0 = (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const int next_wg = (wg + 1) % C::NWG;

  float acc[D / 2];                         // O, D / 8 blocks of 8 columns
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};

  mbar_wait(&s.full[0], 0);
  const int n_live = s.n_live;
  if (n_live > 0) {
    int k0 = s.tile[0];
    uint32_t p[BK / 4];                     // P of the tile before, bf16 pairs
    uint32_t kb[C::WORDS];
#pragma unroll
    for (int u = 0; u < C::WORDS; ++u) kb[u] = s.bits[0][u];
    mbar_wait(&s.q_full, 0);
    if (wg == C::NWG - 1) bar_arrive(TURN_BAR, 256);   // warpgroup 0 first
    {
      float sc[BK / 2];                     // S = Q K^T, 64 x BK per warpgroup
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      bar_sync(TURN_BAR + wg, 256);
      fence_regs(sc);
      wgmma_fence();
      fwd_scores<C>(sc, s, 0, wg);
      wgmma_commit();
      bar_arrive(TURN_BAR + next_wg, 256);
      wgmma_wait0();
      fence_regs(sc);
      float alpha[2];
      fwd_softmax_tile<C>(sc, kb, k0, wrow, row0, t, a, drop0, m_run, l_run, alpha);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    }
    int prev = 0;                           // the stage of P's tile
    for (int item = 1; item < n_live; ++item) {
      const int st = item % STAGES;
      mbar_wait(&s.full[st], (item / STAGES) & 1);
      k0 = s.tile[st];
#pragma unroll
      for (int u = 0; u < C::WORDS; ++u) kb[u] = s.bits[st][u];
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      bar_sync(TURN_BAR + wg, 256);
      fence_regs(sc);
      fence_regs(acc);
      wgmma_fence();
      fwd_scores<C>(sc, s, st, wg);         // S of this tile
      wgmma_commit();
      fwd_pv<C>(acc, p, s, prev);           // O += P V of the tile before
      wgmma_commit();
      bar_arrive(TURN_BAR + next_wg, 256);
      wgmma_wait_n<1>();
      fence_regs(sc);
      float alpha[2];
      fwd_softmax_tile<C>(sc, kb, k0, wrow, row0, t, a, drop0, m_run, l_run, alpha);
      wgmma_wait0();                        // P V done: O and the stage are free
      fence_regs(acc);
      hold_regs(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[prev]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      prev = st;
    }
    bar_sync(TURN_BAR + wg, 256);   // the last tile's O += P V
    fence_regs(acc);
    wgmma_fence();
    fwd_pv<C>(acc, p, s, prev);
    wgmma_commit();
    if (wg + 1 < C::NWG) bar_arrive(TURN_BAR + next_wg, 256);
    wgmma_wait0();
    fence_regs(acc);
    hold_regs(p);
  }

  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  const int bh = b * a.H + h;
  if (a.lse != nullptr && t == 0) {         // one lane a row writes it
    float* lb = a.lse + (size_t)bh * a.Sq;
    if (row0 < a.Sq)
      lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
    if (row1 < a.Sq)
      lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
  }
  __nv_bfloat16* ob = a.o + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * a.o_ss + col) =
          __floats2bfloat162_rn(acc[dt * 4] * inv0, acc[dt * 4 + 1] * inv0);
    if (row1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * a.o_ss + col) =
          __floats2bfloat162_rn(acc[dt * 4 + 2] * inv1, acc[dt * 4 + 3] * inv1);
  }
}

// One block a (query tile of BQ rows, b, h). The two roles never meet
// again after the barriers are set up, so setmaxnreg sees each branch whole.
template <class C>
__global__ void __launch_bounds__(C::NTHREADS, 1)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<C>& s = aligned_smem<FwdSmem<C>>(smem_raw);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * C::BQ;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);   // warp-uniform
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
#pragma unroll
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&s.full[i], 32);            // the producer warp's lanes
      mbar_init(&s.empty[i], 4 * C::NWG);   // one lane a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == C::NWG) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x % 128 < 32) fwd_produce<C>(s, &q_map, &k_map, &v_map, a, q0, b, h, lane);
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    fwd_consume<C>(s, a, q0, b, h, wg, lane);
  }
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
