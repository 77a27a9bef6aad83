// The flash forward's Hopper pipeline at head dims 64, 96 and 128 (sm_90a),
// shared by K1 (flash_attention_fwd.cu, flash_fwd_hopper_kernel) and K7, the
// flash-parts tool (flash_parts.cu, flash_parts_hopper_kernel): the shape of
// an instance, its shared memory, the producer, the two products and the
// consumer loop, templated on the elementwise body that runs between them.
//
// A block is one producer warpgroup and two consumer warpgroups of 64 query
// rows (128 rows a block):
//   * the producer's first warp issues the TMA loads: Q once, then K and V
//     through a ring of STAGES 64-key stages on mbarriers. It walks only
//     the key tiles that hold an attended key (every tile, in order, when
//     there is no mask, as in K7) and hands each stage's key-mask bits
//     beside its data. The producer gives its registers to the consumers
//     (setmaxnreg);
//   * a consumer warpgroup issues tile j's S = Q K^T (wgmma m64n64k16 from
//     shared memory) together with tile j-1's O += P V (wgmma with P from
//     registers, packed from the S accumulators, and V read MN-major
//     through the transpose bit), runs the body of tile j while P V is on
//     the tensor cores, then waits for P V, frees the stage and rescales O;
//   * named barriers hand the issue of the products round the consumer
//     warpgroups in turn (ping-pong), so one warpgroup's body runs under
//     the other's products.
//
// A Body is a struct of three static hooks that fwd_consume calls in each
// consumer thread:
//   tile(sc, kb, k0, wrow, row0, t, a, drop0, m_run, l_run, alpha)
//       the S tile in place into P (f32), the factor that rescales O into
//       alpha; kb and k0 are the stage's key-mask bits and first key, wrow
//       the warpgroup's first row, row0 the thread's, t its place in its
//       accumulator group, drop0 the flat dropout index of (b, h, row0, 0),
//       m_run and l_run the rows' running statistics (the body's to use)
//   rescale(acc, alpha)   O *= alpha, once P V of the tile before is done
//   store(acc, a, b, h, row0, row1, t, m_run, l_run)   the epilogue (row1 =
//       row0 + 8)
// Element x = 4 nt + e of a thread's S tile is row row0 + 8 (e / 2), key
// k0 + 8 nt + 2t + (e % 2); of its O, column 8 (x / 4) + 2t + (x % 2).
#pragma once
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
  float scale_log2;                         // the score scale times log2(e); K7's
                                            // noexp and mmonly: the plain scale
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

// Named barriers 1 .. NWG: barrier 1 + w is warpgroup w's turn to issue.
constexpr int TURN_BAR = 1;

// A consumer warpgroup: rows q0 + 64 wg .. + 63. The first live tile is
// peeled off the walk, so that inside it every wgmma is issued and waited
// for unconditionally: S of tile j with P V of tile j-1, the body of j
// while P V runs, then O rescaled once P V is done.
template <class C, class Body>
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
      Body::tile(sc, kb, k0, wrow, row0, t, a, drop0, m_run, l_run, alpha);
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
      Body::tile(sc, kb, k0, wrow, row0, t, a, drop0, m_run, l_run, alpha);
      wgmma_wait0();                        // P V done: O and the stage are free
      fence_regs(acc);
      hold_regs(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[prev]);
      Body::rescale(acc, alpha);
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

  Body::store(acc, a, b, h, row0, row1, t, m_run, l_run);
}

// One block a (query tile of BQ rows, b, h): the body of a kernel with
// __launch_bounds__(C::NTHREADS, 1) and these parameters, each passed
// __grid_constant__. The two roles never meet again after the barriers are
// set up, so setmaxnreg sees each branch whole.
template <class C, class Body>
__device__ __forceinline__ void fwd_block(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                          const CUtensorMap& v_map, const FwdArgs& a) {
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
    if (threadIdx.x % 128 < 32)
      fwd_produce<C>(s, &q_map, &k_map, &v_map, a, q0, b, h, lane);
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    fwd_consume<C, Body>(s, a, q0, b, h, wg, lane);
  }
}

}  // namespace
