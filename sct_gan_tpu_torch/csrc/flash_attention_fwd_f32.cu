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
// Design: a block is a (128 query rows, b, h) tile, three warpgroups:
//   * the transform warpgroup: its first warp walks the key tiles that hold
//     an attended key (TileWalk; under causal only those its rows see) and
//     issues the TMA loads, Q once and each live tile's K and V into a raw
//     ring; all four warps split each landed tile once, for the whole
//     block, into its TF32 halves in wgmma's layout (f32_attention.cuh): K
//     as it lands, V transposed (TF32 wgmma reads K-major operands only),
//     into a ring of split stages, and Q's small half in place;
//   * two consumer warpgroups of 64 rows each, in ping-pong as the bf16
//     K1's (named barriers hand the issue of the products round them, so
//     one's softmax runs under the other's products). Each holds Q's big
//     half in registers (QREG, at 64 and 96), read once as Q lands. Per
//     tile, two turns: S = Q K^T by 3 D / 8 TF32 wgmma (3xTF32: Qs Kb from
//     shared memory, then Qb Ks and Qb Kb with Qb from registers), the
//     online softmax in f32 in the log2 domain (an interior tile folds the
//     scale into the exponent's FMA), dropout on P after the statistics, O
//     rescaled, P split in registers as the A operand, then O += P V by 3
//     BK / 8 wgmma on V^T's halves. S and P V are not issued together (the
//     bf16 K1's pipeline): P's halves of the tile before would stay live
//     beside S's accumulator, past the 168 registers a thread may hold in a
//     block of 384 threads (the SM's register file is split over its four
//     schedulers: 320 threads fare no better).
// Measured on the card (chip_smoke.py --f32-times): a TF32 wgmma of N = 32
// runs at ~56% of the TF32 rate with both operands in shared memory and
// ~90% with A in registers, N >= 64 at the full rate; at D = 96 the budget
// allows 32-key tiles only, so S's products bound this kernel.
// A skipped tile adds exactly nothing (its scores are -inf), so the skip
// changes no result.
//
// Budget (bytes of shared memory: Q (its small half; at 128 both) + the
// split stages (K's halves, V^T's) + the raw ring (K, V as landed); the
// struct rounds up to 1 KB and 1 KB more aligns it):
//   D = 64:  64-key tiles, 2 split + 2 raw stages:  32768 + 131072 + 65536 = 229,376 (231,424 asked)
//   D = 96:  32-key tiles, 2 split + 3 raw stages:  49152 +  98304 + 73728 = 221,184 (223,232)
//   D = 128: 16-key tiles, 2 split + 2 raw stages: 131072 +  65536 + 32768 = 229,376 (231,424)
// (at 128 Q's big half would not fit the registers beside O: all three of
// S's products read Q from shared memory). One block an SM, 384 threads.
// Waves on 132 SMs: (8, 8, 1024, 96) 512 blocks, 3.88 waves; CodeBERT's
// (4, 12, 512, 64) 192 blocks, 1.45 waves.
//
// Head dims over 128 take the wide route instead (flash_f32_fwd_group_kernel,
// below): a block owns a group of O's columns (the whole head dim up to
// 256) and computes each score tile once, over the head dim in 64-column
// chunks that its TMA ring brings in, on the same 3xTF32 wgmma.
//
// Semantics (the bf16 K1's and the JAX kernel's): a masked key gets -inf; a
// fully-masked row gives zeros and lse = -1e30; causal means key j is
// visible to query i iff j <= i (top-left aligned when Sq != Sk).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_attention.cuh"
#include "hash_dropout.cuh"
#include "hopper_tile.cuh"

namespace {

using namespace f32att;
using namespace hopper;

struct FwdF32Args {
  const uint8_t* mask;   // (B, Sk), nonzero = attend, or null
  float* o;
  float* lse;            // contiguous (B*H, Sq), or null
  int H, Sq, Sk, o_sb, o_sh, o_ss, mask_sb, causal;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float inv_keep;
  DropShard ds;
};

// An instance: head dim, keys a tile, split stages, raw stages, and whether
// Q's big half is held in registers (QREG: two of S's three products take
// A from registers, only Q's small half stays in shared memory).
template <int D_, int BK_, int STAGES_, int RAW_, bool QREG_>
struct FwdF32Shape {
  static constexpr int D = D_, BK = BK_, STAGES = STAGES_, RAW = RAW_;
  static constexpr bool QREG = QREG_;
  static constexpr int BQ = 128, NWG = 2, NX = 128, NT = 128 * NWG + NX;   // NX: transform threads
  static constexpr int Q_BYTES = BQ * D * 4, TILE = BK * D * 4, WORDS = (BK + 31) / 32;
  static constexpr int Q_HALVES = QREG ? 1 : 2;   // in shared memory
};

template <int D>
struct FwdF32;
template <>
struct FwdF32<64> : FwdF32Shape<64, 64, 2, 2, true> {};
template <>
struct FwdF32<96> : FwdF32Shape<96, 32, 2, 3, true> {};
template <>
struct FwdF32<128> : FwdF32Shape<128, 16, 2, 2, false> {};

template <class C>
struct FwdF32Smem {
  // Q's small half (q[0]; Q lands there and is split in place) and, unless
  // QREG, its big half (q[1])
  alignas(1024) unsigned char q[C::Q_HALVES][C::Q_BYTES];
  alignas(1024) unsigned char kb[C::STAGES][C::TILE];   // split stages: K's halves, KM
  alignas(1024) unsigned char ks[C::STAGES][C::TILE];
  alignas(1024) unsigned char vb[C::STAGES][C::TILE];   // V's, transposed
  alignas(1024) unsigned char vs[C::STAGES][C::TILE];
  alignas(1024) unsigned char kraw[C::RAW][C::TILE];    // the raw ring, as landed
  alignas(1024) unsigned char vraw[C::RAW][C::TILE];
  uint32_t bits[C::STAGES][C::WORDS];   // the stage's key-mask bits (tile_bits)
  int tile[C::STAGES];                  // the stage's first key
  uint32_t raw_bits[C::RAW][C::WORDS];
  int raw_tile[C::RAW];
  int n_live;                           // live tiles, published on `meta`
  uint64_t meta, q_full, q_read, q_ready, raw_full[C::RAW], full[C::STAGES], empty[C::STAGES];
};

// The transform warpgroup: the walk and the TMA loads (warp 0), the split
// of Q and of each live tile (all four warps).
template <class C>
__device__ __forceinline__ void fwd_transform(FwdF32Smem<C>& s, const CUtensorMap* q_map,
                                              const CUtensorMap* k_map,
                                              const CUtensorMap* v_map, const FwdF32Args& a,
                                              int q0, int b, int h) {
  constexpr int BK = C::BK;
  const int tid = threadIdx.x - 128 * C::NWG, warp = tid / 32, lane = tid % 32;
  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + C::BQ, a.Sq) - 1) / BK + 1);
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  TileWalk<BK> walk(mrow, a.Sk, n_tiles);
  if (warp == 0) {
    const int n = walk.count(lane);
    if (lane == 0) {
      s.n_live = n;
      mbar_arrive(&s.meta);
    }
  }
  bar_sync(XF_BAR, C::NX);
  const int n_live = s.n_live;
  if (n_live == 0) return;
  auto issue = [&](int r) {                 // warp 0: the next live tile into raw stage r
    const int k0 = walk.next(lane) * BK;
    uint32_t kb[C::WORDS];
    tile_bits<BK>(kb, mrow, k0, a.Sk, lane);
    if (lane == 0) {
      s.raw_tile[r] = k0;
#pragma unroll
      for (int u = 0; u < C::WORDS; ++u) s.raw_bits[r][u] = kb[u];
      mbar_arrive_expect_tx(&s.raw_full[r], 2 * C::TILE);
      tma_tile<C::D>(s.kraw[r], k_map, &s.raw_full[r], BK, k0, h, b);
      tma_tile<C::D>(s.vraw[r], v_map, &s.raw_full[r], BK, k0, h, b);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(&s.q_full, C::Q_BYTES);
      tma_tile<C::D>(s.q[0], q_map, &s.q_full, C::BQ, q0, h, b);
    }
    for (int r = 0; r < C::RAW && r < n_live; ++r) issue(r);
  }
  if constexpr (C::QREG) {                  // the consumers took Q's big half
    mbar_wait(&s.q_read, 0);
    split_km<C::BQ, C::D, C::NX, false>(s.q[0], nullptr, s.q[0], tid);
  } else {
    mbar_wait(&s.q_full, 0);
    split_km<C::BQ, C::D, C::NX>(s.q[0], s.q[1], s.q[0], tid);
  }
  fence_proxy_async();                      // the halves are read by wgmma
  mbar_arrive(&s.q_ready);
  for (int item = 0; item < n_live; ++item) {
    const int r = item % C::RAW, st = item % C::STAGES;
    mbar_wait(&s.raw_full[r], (item / C::RAW) & 1);
    mbar_wait(&s.empty[st], ((item / C::STAGES) & 1) ^ 1);   // the stage is free
    split_km<BK, C::D, C::NX>(s.kraw[r], s.kb[st], s.ks[st], tid);
    split_t<BK, C::D, C::NX, false>(s.vraw[r], s.vb[st], s.vs[st], nullptr, nullptr, tid);
    if (tid == 0) {
      s.tile[st] = s.raw_tile[r];
#pragma unroll
      for (int u = 0; u < C::WORDS; ++u) s.bits[st][u] = s.raw_bits[r][u];
    }
    fence_proxy_async();
    mbar_arrive(&s.full[st]);
    bar_sync(XF_BAR, C::NX);                // raw stage r is read: free for tile item + RAW
    if (warp == 0 && item + C::RAW < n_live) issue(r);
  }
}

// descriptor of k-step kk of 64 rows of Q's tile (BQ rows) whose first
// row is at shared address `base`
template <class C>
__device__ __forceinline__ uint64_t q_desc(uint32_t base, int kk) {
  return km_desc_at(base + (kk >> 1) * C::BQ * 64 + (kk & 1) * 32);
}

// S = Q K^T of warpgroup wg's 64 rows and the stage's BK keys, 3xTF32 (Qs
// Kb, then Qb Ks, then Qb Kb; Qb from registers qr when QREG): issues 3 D /
// 8 wgmma, no commit.
template <class C, int NQ>
__device__ __forceinline__ void fwd_scores(float (&sc)[C::BK / 2], const FwdF32Smem<C>& s,
                                           const uint32_t (&qr)[NQ][4], int st, int wg) {
  // Q's rows of this warpgroup, as an address the compiler cannot hoist: the
  // descriptors of its k-steps are made afresh each tile (held across the
  // walk they cost two registers each)
  uint32_t qs = smem_u32(s.q[0]) + wg * 64 * 64, qb = qs + C::Q_BYTES;
  asm volatile("" : "+r"(qs), "+r"(qb));
#pragma unroll
  for (int kk = 0; kk < C::D / 8; ++kk)
    wgmma_tf32_ss(sc, q_desc<C>(qs, kk), km_desc(s.kb[st], C::BK, kk));
  const unsigned char* kbk[2] = {s.ks[st], s.kb[st]};
#pragma unroll
  for (int term = 0; term < 2; ++term)
#pragma unroll
    for (int kk = 0; kk < C::D / 8; ++kk) {
      if constexpr (C::QREG)
        wgmma_tf32_rs(sc, qr[kk], km_desc(kbk[term], C::BK, kk));
      else
        wgmma_tf32_ss(sc, q_desc<C>(qb, kk), km_desc(kbk[term], C::BK, kk));
    }
}

// O += P V over the stage's BK keys, P's halves in A order (p[kk][r]):
// issues 3 BK / 8 wgmma, no commit.
template <class C>
__device__ __forceinline__ void fwd_pv(float (&acc)[C::D / 2],
                                       const uint32_t (&pb)[C::BK / 8][4],
                                       const uint32_t (&ps)[C::BK / 8][4],
                                       const FwdF32Smem<C>& s, int st) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 8; ++kk) wgmma_tf32_rs(acc, ps[kk], km_desc(s.vb[st], C::D, kk));
#pragma unroll
  for (int kk = 0; kk < C::BK / 8; ++kk) wgmma_tf32_rs(acc, pb[kk], km_desc(s.vs[st], C::D, kk));
#pragma unroll
  for (int kk = 0; kk < C::BK / 8; ++kk) wgmma_tf32_rs(acc, pb[kk], km_desc(s.vb[st], C::D, kk));
}

// The online softmax of one S tile in the log2 domain, in place: element i
// of a thread is row row0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2t + (i
// & 1). EDGE: the tile has a key whose bit of kb is clear or, under causal,
// a key after one of the warpgroup's rows: such keys get -inf, tested
// element by element on scaled scores. An interior tile takes the row max
// of the raw scores and folds the scale into the exponent's FMA (the bf16
// K1's body; it needs scale > 0, and any other scale takes EDGE). Leaves P
// (dropped when dropout is on) in sc and the factor that rescales O in
// alpha.
template <class C, bool EDGE>
__device__ __forceinline__ void fwd_softmax(float (&sc)[C::BK / 2],
                                            const uint32_t (&kb)[C::WORDS], int k0, int row0,
                                            int t, const FwdF32Args& a, uint32_t drop0,
                                            float (&m_run)[2], float (&l_run)[2],
                                            float (&alpha)[2]) {
  constexpr int BK = C::BK;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int e = (i >> 1) & 1;
    float x = sc[i];
    if constexpr (EDGE) {
      const int col = (i >> 2) * 8 + 2 * t + (i & 1);
      x *= scale_log2;
      if (!key_on(kb, col) || (a.causal && k0 + col > row0 + 8 * e)) x = -INFINITY;
      sc[i] = x;
    }
    mx[e] = fmaxf(mx[e], x);
  }
  float base[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = quad_max(mx[e]);
    if constexpr (!EDGE) mx[e] *= scale_log2;   // the raw max: the scale is > 0 here
    mx[e] = fmaxf(mx[e], m_run[e]);
    base[e] = mx[e] == -INFINITY ? 0.f : mx[e];   // all masked so far
    alpha[e] = fast_exp2(m_run[e] - base[e]);
    m_run[e] = mx[e];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if constexpr (EDGE)
      sc[i] = fast_exp2(sc[i] - base[(i >> 1) & 1]);
    else
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -base[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l_run[e] = l_run[e] * alpha[e] + quad_sum(rs[e]);
  if (a.dropout) {                          // after l: dropout acts on P only
    const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const uint32_t key = (uint32_t)(k0 + (i >> 2) * 8 + 2 * t + (i & 1));
      const bool keep = hash_keep((((i >> 1) & 1) ? drop1 : drop0) + key, a.seed, a.threshold);
      sc[i] = keep ? sc[i] * a.inv_keep : 0.f;
    }
  }
}

// Named barriers TURN_BAR + w: warpgroup w's turn to issue its products.
constexpr int TURN_BAR = 2;

// A consumer warpgroup: rows q0 + 64 wg .. + 63, every live tile. Per tile
// two turns: S, then (after the softmax, O rescaled and P split) P V; the
// turns go round the two warpgroups (ping-pong), so that the tensor cores
// run one's S while the other's softmax runs, and each waits only for its
// own products. S and P V are not issued together (the bf16 K1's pipeline):
// P's two halves of the tile before would stay live beside S's accumulator,
// past the 168 registers a thread of a 384-thread block may hold.
template <class C>
__device__ __forceinline__ void fwd_consume(FwdF32Smem<C>& s, const FwdF32Args& a, int q0,
                                            int b, int h, int wg) {
  constexpr int D = C::D, BK = C::BK, STAGES = C::STAGES;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;   // in the block's tile
  const int row0 = q0 + r0, row1 = row0 + 8;
  // flat dropout index of (b, h, row0, 0) over the true Sq, Sk
  const uint32_t drop0 =
      (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const int next_wg = (wg + 1) % C::NWG;

  float acc[D / 2];                         // O, D / 8 blocks of 8 columns
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};   // log2 domain

  mbar_wait(&s.meta, 0);
  const int n_live = s.n_live;
  // QREG: Q's big half as A fragments, k-step kk: rows row0, row1, columns
  // 8 kk + t, + 4 (a0..a3), read from Q as landed
  uint32_t qr[C::QREG ? D / 8 : 1][4];
  if (n_live > 0) {
    if constexpr (C::QREG) {
      mbar_wait(&s.q_full, 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + 8 * (r & 1), col = 8 * kk + t + 4 * (r >> 1);
          const float x = *reinterpret_cast<const float*>(
              s.q[0] + km_off(C::BQ, row, col >> 2) + (col & 3) * 4);
          qr[kk][r] = __float_as_uint(x) & 0xffffe000u;   // split_tf32's big
        }
      mbar_arrive(&s.q_read);
    }
    mbar_wait(&s.q_ready, 0);
    if (wg == C::NWG - 1) bar_arrive(TURN_BAR, 256);   // warpgroup 0 first
  }
  for (int item = 0; item < n_live; ++item) {
    const int st = item % STAGES;
    mbar_wait(&s.full[st], (item / STAGES) & 1);
    const int k0 = s.tile[st];
    uint32_t kb[C::WORDS];
#pragma unroll
    for (int u = 0; u < C::WORDS; ++u) kb[u] = s.bits[st][u];
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    bar_sync(TURN_BAR + wg, 256);
    fence_regs(sc);
    wgmma_fence();
    fwd_scores<C>(sc, s, qr, st, wg);
    wgmma_commit();
    bar_arrive(TURN_BAR + next_wg, 256);
    wgmma_wait0();
    fence_regs(sc);
    float alpha[2];
    bool all_on = true;                     // every key of the tile attended
#pragma unroll
    for (int u = 0; u < C::WORDS; ++u)
      all_on &= kb[u] == (BK - 32 * u >= 32 ? ~0u : (1u << (BK - 32 * u)) - 1u);
    if (!all_on || a.scale <= 0.f || (a.causal && k0 + BK - 1 > q0 + wg * 64))
      fwd_softmax<C, true>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
    else
      fwd_softmax<C, false>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) a_operand(sc, kk, pb[kk], ps[kk]);
    bar_sync(TURN_BAR + wg, 256);
    fence_regs(acc);
    wgmma_fence();
    fwd_pv<C>(acc, pb, ps, s, st);
    wgmma_commit();
    // every turn is handed on but warpgroup 1's last: warpgroup 0 takes no
    // more (each syncs 2 n_live times; 1 gives its turn on once up front)
    if (wg + 1 < C::NWG || item + 1 < n_live) bar_arrive(TURN_BAR + next_wg, 256);
    wgmma_wait0();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      hold_regs(pb[kk]);
      hold_regs(ps[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }

  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  const int bh = b * a.H + h;
  if (a.lse != nullptr && t == 0) {          // one lane a row writes it
    constexpr float LN2 = 0.6931471805599453f;
    float* lb = a.lse + (size_t)bh * a.Sq;
    if (row0 < a.Sq) lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
    if (row1 < a.Sq) lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
  }
  float* ob = a.o + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8) {
    const int col = n8 * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<float2*>(ob + (size_t)row0 * a.o_ss + col) =
          make_float2(acc[4 * n8] * inv0, acc[4 * n8 + 1] * inv0);
    if (row1 < a.Sq)
      *reinterpret_cast<float2*>(ob + (size_t)row1 * a.o_ss + col) =
          make_float2(acc[4 * n8 + 2] * inv1, acc[4 * n8 + 3] * inv1);
  }
}

template <int D>
__global__ void __launch_bounds__(FwdF32<D>::NT, 1)
flash_f32_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const FwdF32Args a) {
  using C = FwdF32<D>;
  extern __shared__ unsigned char smem_raw[];
  FwdF32Smem<C>& s = aligned_smem<FwdF32Smem<C>>(smem_raw);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, q0 = blockIdx.x * C::BQ;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);   // warp-uniform
  if (threadIdx.x == 0) {
    mbar_init(&s.meta, 1);
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_read, 128 * C::NWG);     // the consumer threads (QREG)
    mbar_init(&s.q_ready, C::NX);           // the transform threads
#pragma unroll
    for (int i = 0; i < C::RAW; ++i) mbar_init(&s.raw_full[i], 1);
#pragma unroll
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&s.full[i], C::NX);
      mbar_init(&s.empty[i], 4 * C::NWG);   // one lane a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == C::NWG)
    fwd_transform<C>(s, &q_map, &k_map, &v_map, a, q0, b, h);
  else
    fwd_consume<C>(s, a, q0, b, h, wg);
}

template <int D>
int launch(const FwdF32Args& a, const void* q, const void* k, const void* v, int B,
           const int (&st)[9], cudaStream_t stream) {
  using C = FwdF32<D>;
  constexpr int bytes = sizeof(FwdF32Smem<C>) + 1024;
  static_assert(bytes <= 232448, "shared memory over the limit");
  CUtensorMap qm, km, vm;
  int e = make_f32_map(&qm, q, B, a.H, a.Sq, D, st[0], st[1], st[2], C::BQ);
  if (e == 0) e = make_f32_map(&km, k, B, a.H, a.Sk, D, st[3], st[4], st[5], C::BK);
  if (e == 0) e = make_f32_map(&vm, v, B, a.H, a.Sk, D, st[6], st[7], st[8], C::BK);
  if (e != 0) return e;
  static bool configured = false;            // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, B * a.H);
  flash_f32_fwd_kernel<D><<<grid, C::NT, bytes, stream>>>(qm, km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

// The card's handling of the 13 low bits of an f32 operand that TF32 drops:
// one m64n8k8 wgmma of A (64 x 8, column 0: row 0 x = 1 + 3 * 2^-12, row 1
// -x, row 2 one) by B (8 x 8, column 0 of row n: one for n = 0, x for n =
// 1), both in the KM layout, the rest zero. out[0..2] = D[0][0], D[1][0]
// (A's x and -x as the tensor core took them) and D[2][1] (B's x): 1 (and
// -1) where the bits are dropped, 1 + 2^-10 where they are rounded to
// nearest, x where they are kept.
__global__ void __launch_bounds__(128) tf32_probe_kernel(float* out) {
  __shared__ __align__(1024) unsigned char tiles[4096 + 1024];
  unsigned char* ta = tiles;                 // 64 rows x 16 columns: one chunk
  unsigned char* tb = tiles + 4096;          // 16 rows (8 used) x 16 columns
  const int tid = threadIdx.x;
  for (int i = tid; i < (4096 + 1024) / 4; i += 128) reinterpret_cast<float*>(tiles)[i] = 0.f;
  __syncthreads();
  const float x = 1.f + 3.f * 0x1p-12f;
  if (tid == 0) {
    *reinterpret_cast<float*>(ta + km_off(64, 0, 0)) = x;
    *reinterpret_cast<float*>(ta + km_off(64, 1, 0)) = -x;
    *reinterpret_cast<float*>(ta + km_off(64, 2, 0)) = 1.f;
    *reinterpret_cast<float*>(tb + km_off(16, 0, 0)) = 1.f;
    *reinterpret_cast<float*>(tb + km_off(16, 1, 0)) = x;
  }
  fence_proxy_async();
  __syncthreads();
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  fence_regs(d);
  wgmma_fence();
  wgmma_tf32_ss(d, km_desc(ta, 64, 0), km_desc(tb, 16, 0));
  wgmma_commit();
  wgmma_wait0();
  fence_regs(d);
  if (tid == 0) out[0] = d[0];               // row 0, column 0
  if (tid == 4) out[1] = d[0];               // row 1, column 0
  if (tid == 8) out[2] = d[1];               // row 2, column 1
}

// The card's TF32 wgmma rate by shape (chip_smoke.py --f32-times; no
// kernel of the port calls it): every SM runs two warpgroups, each issuing
// `reps` groups of 12 m64nNk8 wgmma into one accumulator (the kernels'
// chains), A from shared memory (SS) or from registers (RS), B from shared
// memory; operands zero. The host times a launch: 2 * 64 * N * 8 * 12 *
// reps * 2 * blocks flops.
template <int N, bool RS>
__global__ void __launch_bounds__(256) tf32_rate_kernel(float* out, int reps) {
  __shared__ __align__(1024) unsigned char tiles[4096 + 8192];
  unsigned char* ta = tiles;                 // 64 rows x 16 columns: one chunk
  unsigned char* tb = tiles + 4096;          // up to 128 rows x 16 columns
  for (int i = threadIdx.x; i < (4096 + 8192) / 4; i += 256)
    reinterpret_cast<float*>(tiles)[i] = 0.f;
  fence_proxy_async();
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t a[4] = {0u, 0u, 0u, 0u};
  const uint64_t da = km_desc(ta, 64, 0), db = km_desc(tb, N < 16 ? 16 : N, 0);
  for (int r = 0; r < reps; ++r) {
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      if constexpr (RS)
        wgmma_tf32_rs(d, a, db);
      else
        wgmma_tf32_ss(d, da, db);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(d);
  }
  hold_regs(a);
  float x = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x += d[i];
  if (x != 0.f) out[0] = x;                  // never: keeps the products
}

template <int N, bool RS>
int rate_launch(void* out, int reps, int blocks, cudaStream_t st) {
  tf32_rate_kernel<N, RS><<<blocks, 256, 0, st>>>(static_cast<float*>(out), reps);
  return static_cast<int>(cudaGetLastError());
}

// ---- head dims over 128: the wide route ----------------------------------------
// A head dim D over 128 (a multiple of wide::CW = 64; the wrapper pads any
// other) runs in column groups (f32_attention.cuh, wide), each score tile
// computed once per row tile and group: a block owns 64 query rows and a
// group of DG columns of O, DG 192 or 256 (wide::groups: one group at 192
// and 256, two of 192 at 384, two of 256 at 512; the last group's columns
// past D are zeros, not written). 256 threads:
//   * the transform warpgroup: warp 4 walks the 64-key tiles that hold an
//     attended key (TileWalk; under causal only those its rows see) and
//     loads each tile's units by TMA into the ring: Q's and K's chunks c =
//     0 .. D/64 - 1 in turn, then the group's chunks of V; warps 5-7 split
//     each landed unit once (wide::Ring::feed): Q's and K's small halves
//     beside them, V transposed (TF32 wgmma reads K-major operands only);
//   * one consumer warpgroup: per tile S = Q K^T once, over the whole head
//     dim, one 64 x 64 x 64 step of 3xTF32 m64n64k8 wgmma a chunk pair,
//     both operands from shared memory (each step issued before the one
//     before is released); the online softmax in the log2 domain (the
//     64-128 instances' fwd_softmax), dropout on P after the statistics;
//     O rescaled, then O[:, c] += P V[:, c] for each of the group's
//     chunks, one step each, P's halves as the A operand: from registers
//     at DG = 192 (P_REG), stored once in shared memory at 256.
// Every group's block computes the same S in the same order, so the same
// statistics and the same keep bits (the hash is over (b, h, i, j)); only
// group 0 writes the LSE. A fully masked row gives zeros and lse = -1e30.
// Budget (shared memory, 1 KB more aligns it; registers, 255 a thread at
// 256 threads, so no setmaxnreg):
//   DG = 192: 7 stages x 32 KB = 229,376 bytes; O (96) and P's halves (64)
//             in registers (210 used)
//   DG = 256: 6 stages x 32 KB + P's halves 32 KB = 229,376 bytes; O (128)
//             and S (32) (226 used)
// The products run (NG (D / 64) + D / 64) / (2 D / 64) times the math's: 1 at
// 192 and 256, 1.5 at 384 (a block a 64-column chunk: 2, 2.5, 3.5). What bounds
// it on the card (chip_smoke.py --f32-times, PERF.md): the transform's
// split and shared memory's bandwidth (every 3xTF32 step reads 96 KB of
// operands, the split 48 KB a unit), more than the tensor cores; one
// consumer warpgroup leaves them idle during its softmax, and two of 64
// rows each would cap every thread at 168 registers, under O's 128 at DG =
// 256.
template <int DG>
struct FwdGroupSmem {
  static constexpr bool P_REG = DG <= 192;         // P's 64 registers beside O's DG / 2
  wide::Ring<P_REG ? 7 : 6> r;
  alignas(P_REG ? 16 : 1024) unsigned char p[P_REG ? 1 : 2][P_REG ? 16 : wide::HALF];   // P
  int n_live;                                      // live tiles, published on `meta`
  uint64_t meta;
};

// fwd_softmax's shape at the wide route's 64-key tiles
struct FwdGroupTile {
  static constexpr int BK = wide::CW, WORDS = 2;
};

constexpr int CONS_BAR = 2;   // the consumer warpgroup (named barrier)

// The transform warpgroup of a K1 block (FwdGroupSmem or FwdSplitSmem),
// tid its thread in [0, 128).
template <int DG, class Smem>
__device__ __forceinline__ void fwd_group_transform(Smem& s, const CUtensorMap* q_map,
                                                    const CUtensorMap* k_map,
                                                    const CUtensorMap* v_map,
                                                    const FwdF32Args& a, int D, int q0, int g,
                                                    int b, int h, int tid) {
  constexpr int NCG = DG / wide::CW;
  const int warp = tid / 32, lane = tid % 32;
  const int nc = D / wide::CW, upt = 2 * nc + NCG;   // units a tile
  int n_tiles = (a.Sk + wide::CW - 1) / wide::CW;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + wide::CW, a.Sq) - 1) / wide::CW + 1);
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  TileWalk<wide::CW> walk(mrow, a.Sk, n_tiles);
  if (warp == 0) {
    const int n = walk.count(lane);
    if (lane == 0) {
      s.n_live = n;
      mbar_arrive(&s.meta);
    }
  }
  mbar_wait(&s.meta, 0);
  int k0 = 0;
  auto issue = [&](int v, int ln) {          // warp 0: unit v of the walk
    const int x = v % upt;
    if (x == 0) {                            // the next live tile
      k0 = walk.next(ln) * wide::CW;
      uint32_t kb[2];
      tile_bits<wide::CW>(kb, mrow, k0, a.Sk, ln);
      s.r.load(v, q_map, 0, q0, h, b, ln, k0, kb[0], kb[1]);
    } else if (x < 2 * nc) {                 // Q's and K's chunks in turn
      s.r.load(v, (x & 1) ? k_map : q_map, (x >> 1) * wide::CW, (x & 1) ? k0 : q0, h, b, ln);
    } else {                                 // the group's chunks of V
      s.r.load(v, v_map, (g * NCG + x - 2 * nc) * wide::CW, k0, h, b, ln);
    }
  };
  s.r.feed(s.n_live * upt, tid, issue, [&](int u) { return u % upt >= 2 * nc; });
}

template <int DG>
__device__ __forceinline__ void fwd_group_consume(FwdGroupSmem<DG>& s, const FwdF32Args& a, int D,
                                                  int q0, int g, int b, int h) {
  constexpr int NCG = DG / wide::CW;
  constexpr bool P_REG = FwdGroupSmem<DG>::P_REG;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  const int nc = D / wide::CW;
  // flat dropout index of (b, h, row0, 0) over the true Sq, Sk
  const uint32_t drop0 =
      (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t pb = smem_u32(s.p[0]), ps = smem_u32(s.p[P_REG ? 0 : 1]);

  float o[NCG][32];                          // O's group, a 64-column block each
#pragma unroll
  for (int c = 0; c < NCG; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};   // log2 domain

  mbar_wait(&s.meta, 0);
  const int n_live = s.n_live;
  int u = 0;
  for (int item = 0; item < n_live; ++item) {
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    int k0 = 0;
    uint32_t kb[2] = {0u, 0u};
    for (int c = 0; c < nc; ++c, u += 2) {  // S over the head dim, a chunk a step
      const unsigned char* qc = s.r.wait(u);
      const unsigned char* kc = s.r.wait(u + 1);
      if (c == 0) {
        k0 = s.r.tile[s.r.slot(u)];
        kb[0] = s.r.bits[s.r.slot(u)][0];
        kb[1] = s.r.bits[s.r.slot(u)][1];
      }
      fence_regs(sc);
      wgmma_fence();
      wide::prod3_units(sc, qc, kc);
      wgmma_commit();
      if (c > 0) {                            // the chunk before is read
        wgmma_wait_n<1>();
        s.r.release(u - 2, lane);
        s.r.release(u - 1, lane);
      }
    }
    wgmma_wait0();
    fence_regs(sc);
    s.r.release(u - 2, lane);
    s.r.release(u - 1, lane);
    float alpha[2];
    const bool all_on = kb[0] == ~0u && kb[1] == ~0u;   // every key of the tile attended
    if (!all_on || a.scale <= 0.f || (a.causal && k0 + wide::CW - 1 > q0))
      fwd_softmax<FwdGroupTile, true>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
    else
      fwd_softmax<FwdGroupTile, false>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
    // P's halves, A of O[:, c] += P V[:, c]: in registers where they fit
    // beside O (P_REG), else stored once in shared memory (the tile
    // before's products read them there and are complete)
    uint32_t ab[P_REG ? 8 : 1][4], as[P_REG ? 8 : 1][4];
    if constexpr (P_REG) {
      wide::a_frags(sc, ab, as);
    } else {
      wide::store_a(sc, s.p[0], s.p[P_REG ? 0 : 1], warp, lane);
      fence_proxy_async();
      bar_sync(CONS_BAR, 128);
    }
#pragma unroll
    for (int c = 0; c < NCG; ++c, ++u) {
      const uint32_t vc = smem_u32(s.r.wait(u));
      fence_regs(o[c]);
      wgmma_fence();
      if constexpr (P_REG)
        wide::prod3_rs(o[c], ab, as, vc, vc + wide::HALF);
      else
        wide::prod3(o[c], pb, ps, vc, vc + wide::HALF);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait_n<1>();
        fence_regs(o[c - 1]);
        s.r.release(u - 1, lane);
      }
    }
    wgmma_wait0();
    fence_regs(o[NCG - 1]);
#pragma unroll
    for (int kk = 0; kk < (P_REG ? 8 : 1); ++kk) {
      hold_regs(ab[kk]);
      hold_regs(as[kk]);
    }
    s.r.release(u - 1, lane);
  }

  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  if (a.lse != nullptr && g == 0 && t == 0) {   // one block and lane a row writes it
    constexpr float LN2 = 0.6931471805599453f;
    float* lb = a.lse + (size_t)(b * a.H + h) * a.Sq;
    if (row0 < a.Sq) lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
    if (row1 < a.Sq) lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
  }
  float* ob = a.o + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
#pragma unroll
  for (int c = 0; c < NCG; ++c)
#pragma unroll
    for (int n8 = 0; n8 < wide::CW / 8; ++n8) {
      const int col = g * DG + c * wide::CW + n8 * 8 + 2 * t;
      if (col >= D) continue;
      if (row0 < a.Sq)
        *reinterpret_cast<float2*>(ob + (size_t)row0 * a.o_ss + col) =
            make_float2(o[c][4 * n8] * inv0, o[c][4 * n8 + 1] * inv0);
      if (row1 < a.Sq)
        *reinterpret_cast<float2*>(ob + (size_t)row1 * a.o_ss + col) =
            make_float2(o[c][4 * n8 + 2] * inv1, o[c][4 * n8 + 3] * inv1);
    }
}

template <int DG>
__global__ void __launch_bounds__(256, 1)
flash_f32_fwd_group_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const FwdF32Args a,
                           int D) {
  extern __shared__ unsigned char smem_raw[];
  FwdGroupSmem<DG>& s = aligned_smem<FwdGroupSmem<DG>>(smem_raw);
  const int ng = wide::groups(D, 256), g = blockIdx.x % ng, q0 = (blockIdx.x / ng) * wide::CW;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  if (threadIdx.x == 0) {
    mbar_init(&s.meta, 1);
    s.r.init();
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128)
    fwd_group_transform<DG>(s, &q_map, &k_map, &v_map, a, D, q0, g, b, h, threadIdx.x - 128);
  else
    fwd_group_consume<DG>(s, a, D, q0, g, b, h);
}

// ---- K1 over 256 columns, split over two warpgroups -------------------------------
// Head dims over 256 (flash_f32_fwd_split_kernel): groups of 256 or 384
// columns (wide::group_width_even: one group at 320 and 384, two of 256 at
// 448 and 512), two consumer warpgroups a half each, so S is computed once
// a tile for all of them. 384 threads: both warpgroups issue S's steps,
// warpgroup wg the chunks c = wg, wg + 2, ...; warpgroup 1 hands its part
// over in shared memory, warpgroup 0 adds it, runs the online softmax,
// stores P's halves once and hands alpha over; each rescales its half of
// O, then adds P V[:, c] over its half of the group's chunks; the transform
// warpgroup (warps 8-11) as above. Budget: 5 stages x 32 KB + P's halves
// 32 KB (S's part handed over in their place) = 196,608 bytes (a sixth
// stage would not fit beside the hand-over); registers (168 a thread: 12
// warps) O's half (DG / 4) and S (32), 168 used. The products run (D / 64
// + D / 64) / (2 D / 64) = 1 times the math's at 384.
constexpr int FWD_SPLIT_STAGES = 5;
constexpr int WIDE_FWD_SPLIT = 384;

struct FwdSplitSmem {   // the small members last
  alignas(1024) unsigned char p[2][wide::HALF];   // P's halves
  wide::Ring<FWD_SPLIT_STAGES> r;
  float ax[256];                                  // alpha (each tile), then l: [thread][row]
  int n_live;
  uint64_t meta, s_full, p_full, p_empty, fin;
};

template <int DG>
__device__ __forceinline__ void fwd_split_consume(FwdSplitSmem& s, const FwdF32Args& a, int D,
                                                  int wg) {
  constexpr int NH = DG / wide::CW / 2;       // each warpgroup's chunks of O
  float o[NH][32];
#pragma unroll
  for (int c = 0; c < NH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};   // warpgroup 0, log2

  mbar_wait(&s.meta, 0);
  const int n_live = *(volatile int*)&s.n_live;
  for (int item = 0; item < n_live; ++item) {
    const int nc = D / wide::CW, upt = 2 * nc + 2 * NH, base = item * upt;
    const int x_ = wide::wg_thread();
    float alpha[2];
    // S over the head dim, the chunks shared out: warpgroup wg takes chunks
    // c = wg, wg + 2, ... (both issue score products); warpgroup 1 hands
    // its part over in P's place once both warpgroups' products of the
    // tile before read the last P, warpgroup 0 adds it
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    int k0 = 0;
    uint32_t kb[2] = {0u, 0u};
    for (int c = wg; c < nc; c += 2) {
      const int u = base + 2 * c;
      const unsigned char* qc = s.r.wait(u);
      const unsigned char* kc = s.r.wait(u + 1);
      if (c == 0) {
        k0 = s.r.tile[s.r.slot(u)];
        kb[0] = s.r.bits[s.r.slot(u)][0];
        kb[1] = s.r.bits[s.r.slot(u)][1];
      }
      fence_regs(sc);
      wgmma_fence();
      wide::prod3_units(sc, qc, kc);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      s.r.release(u, x_ % 32);
      s.r.release(u + 1, x_ % 32);
    }
    float* part = reinterpret_cast<float*>(s.p[0]);   // [i * 128 + thread]
    if (wg == 1) {
      mbar_wait(&s.p_empty, (item & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i * 128 + x_] = sc[i];
      mbar_arrive(&s.s_full);
    } else {
      mbar_wait(&s.s_full, item & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] += part[i * 128 + x_];
      bar_sync(CONS_BAR, 128);                // every part read: P takes its place
      uint32_t x, y;
      wide::cta(x, y);
      const int q0 = (int)(x / wide::groups(D, WIDE_FWD_SPLIT)) * wide::CW;
      const int b = (int)y / a.H, h = (int)y % a.H;
      const int row0 = q0 + (x_ / 32) * 16 + ((x_ % 32) >> 2);
      const uint32_t drop0 =
          (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
      const bool all_on = kb[0] == ~0u && kb[1] == ~0u;
      if (!all_on || a.scale <= 0.f || (a.causal && k0 + wide::CW - 1 > q0))
        fwd_softmax<FwdGroupTile, true>(sc, kb, k0, row0, x_ & 3, a, drop0, m_run, l_run, alpha);
      else
        fwd_softmax<FwdGroupTile, false>(sc, kb, k0, row0, x_ & 3, a, drop0, m_run, l_run,
                                         alpha);
      wide::store_a(sc, s.p[0], s.p[1], x_ / 32, x_ % 32);
      s.ax[2 * x_] = alpha[0];
      s.ax[2 * x_ + 1] = alpha[1];
      fence_proxy_async();
      mbar_arrive(&s.p_full);
    }
    mbar_wait(&s.p_full, item & 1);
    if (wg == 1) {
      alpha[0] = s.ax[2 * x_];
      alpha[1] = s.ax[2 * x_ + 1];
    }
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
    const uint32_t pb = smem_u32(s.p[0]), ps = smem_u32(s.p[1]);
#pragma unroll
    for (int c = 0; c < NH; ++c) {            // O[:, c] += P V[:, c], this half's chunks
      const int u = base + 2 * nc + wg * NH + c;
      const uint32_t vc = smem_u32(s.r.wait(u));
      fence_regs(o[c]);
      wgmma_fence();
      wide::prod3(o[c], pb, ps, vc, vc + wide::HALF);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait_n<1>();
        fence_regs(o[c - 1]);
        s.r.release(u - 1, wide::wg_thread() % 32);
      }
    }
    wgmma_wait0();
    fence_regs(o[NH - 1]);
    s.r.release(base + 2 * nc + wg * NH + NH - 1, wide::wg_thread() % 32);
    mbar_arrive(&s.p_empty);                  // P's place is free for the next tile's
  }
  // the rows' sums: warpgroup 0 hands them over once both read the last alpha
  const int x_ = wide::wg_thread(), t = x_ & 3;
  if (wg == 0) {
    if (n_live > 0) mbar_wait(&s.p_empty, (n_live - 1) & 1);
    s.ax[2 * x_] = l_run[0];
    s.ax[2 * x_ + 1] = l_run[1];
    mbar_arrive(&s.fin);
  } else {
    mbar_wait(&s.fin, 0);
    l_run[0] = s.ax[2 * x_];
    l_run[1] = s.ax[2 * x_ + 1];
  }
  uint32_t x, y;
  wide::cta(x, y);
  const int ng = wide::groups(D, WIDE_FWD_SPLIT), g = (int)(x % ng);
  const int q0 = (int)(x / ng) * wide::CW, b = (int)y / a.H, h = (int)y % a.H;
  const int row0 = q0 + (x_ / 32) * 16 + ((x_ % 32) >> 2), row1 = row0 + 8;
  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;   // masked row -> 0
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  if (wg == 0 && a.lse != nullptr && g == 0 && t == 0) {   // one block and lane a row
    constexpr float LN2 = 0.6931471805599453f;
    float* lb = a.lse + (size_t)(b * a.H + h) * a.Sq;
    if (row0 < a.Sq) lb[row0] = l_run[0] > 0.f ? (m_run[0] + log2f(l_run[0])) * LN2 : -1e30f;
    if (row1 < a.Sq) lb[row1] = l_run[1] > 0.f ? (m_run[1] + log2f(l_run[1])) * LN2 : -1e30f;
  }
  float* ob = a.o + (size_t)b * a.o_sb + (size_t)h * a.o_sh;
#pragma unroll
  for (int c = 0; c < NH; ++c)
#pragma unroll
    for (int n8 = 0; n8 < wide::CW / 8; ++n8) {
      const int col = g * DG + (wg * NH + c) * wide::CW + n8 * 8 + 2 * t;
      if (col >= D) continue;
      if (row0 < a.Sq)
        *reinterpret_cast<float2*>(ob + (size_t)row0 * a.o_ss + col) =
            make_float2(o[c][4 * n8] * inv0, o[c][4 * n8 + 1] * inv0);
      if (row1 < a.Sq)
        *reinterpret_cast<float2*>(ob + (size_t)row1 * a.o_ss + col) =
            make_float2(o[c][4 * n8 + 2] * inv1, o[c][4 * n8 + 3] * inv1);
    }
}

template <int DG>
__global__ void __launch_bounds__(384, 1)
flash_f32_fwd_split_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const FwdF32Args a,
                           int D) {
  extern __shared__ unsigned char smem_raw[];
  FwdSplitSmem& s = aligned_smem<FwdSplitSmem>(smem_raw);
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);   // warp-uniform
  if (threadIdx.x == 0) {
    mbar_init(&s.meta, 1);
    mbar_init(&s.s_full, 128);
    mbar_init(&s.p_full, 128);
    mbar_init(&s.p_empty, 256);
    mbar_init(&s.fin, 128);
    s.r.init();
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == 2) {
    uint32_t x, y;
    wide::cta(x, y);
    const int ng = wide::groups(D, WIDE_FWD_SPLIT);
    fwd_group_transform<DG>(s, &q_map, &k_map, &v_map, a, D, (int)(x / ng) * wide::CW,
                            (int)(x % ng), (int)y / a.H, (int)y % a.H, threadIdx.x - 256);
  } else {
    fwd_split_consume<DG>(s, a, D, wg);
  }
}

template <class Smem, typename Kernel>
int launch_group(Kernel kernel, int threads, int widest, bool& configured, const FwdF32Args& a,
                 const void* q, const void* k, const void* v, int B, int D, const int (&st)[9],
                 cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem) + 1024;
  static_assert(bytes <= 232448, "shared memory over the limit");
  CUtensorMap qm, km, vm;
  int e = make_f32_map(&qm, q, B, a.H, a.Sq, D, st[0], st[1], st[2], wide::CW);
  if (e == 0) e = make_f32_map(&km, k, B, a.H, a.Sk, D, st[3], st[4], st[5], wide::CW);
  if (e == 0) e = make_f32_map(&vm, v, B, a.H, a.Sk, D, st[6], st[7], st[8], wide::CW);
  if (e != 0) return e;
  if (!configured) {                          // above 48 KB needs an opt-in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.Sq + wide::CW - 1) / wide::CW * wide::groups(D, widest), B * a.H);
  kernel<<<grid, threads, bytes, stream>>>(qm, km, vm, a, D);
  return static_cast<int>(cudaGetLastError());
}

// K1 over 128: up to 256 one consumer warpgroup (FwdGroupSmem), over 256
// two (FwdSplitSmem)
template <int DG, bool SPLIT>
int launch_wide(const FwdF32Args& a, const void* q, const void* k, const void* v, int B, int D,
                const int (&st)[9], cudaStream_t stream) {
  static bool configured = false;
  if constexpr (SPLIT)
    return launch_group<FwdSplitSmem>(flash_f32_fwd_split_kernel<DG>, 384, WIDE_FWD_SPLIT,
                                      configured, a, q, k, v, B, D, st, stream);
  else
    return launch_group<FwdGroupSmem<DG>>(flash_f32_fwd_group_kernel<DG>, 256, 256, configured,
                                          a, q, k, v, B, D, st, stream);
}

}  // namespace

// The bf16 entry point's arguments (flash_attention_fwd.cu), for f32 q, k, v
// and o: (B, H, S, Dh) with element strides (sb, sh, ss), the last dimension
// contiguous, q/k/v 16-byte aligned with strides of whole 16-byte units (4
// f32; their TMA maps' and cp.async's rule), o on 8-byte lines; Dh 64, 96,
// 128 or, on the wide route, a multiple of 64 over 128.
// mask: (B, Sk) uint8 (nonzero = attend) with row stride mask_sb, or null;
// lse: contiguous f32 (B, H, Sq), or null. Returns the first error: a head
// dim with no route, a refused map, or cudaGetLastError() after the
// launch.
extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int H, int Sq, int Sk, int Dh, int q_sb, int q_sh, int q_ss,
    int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
    int o_sh, int o_ss, int mask_sb, int causal, float scale, int dropout,
    uint32_t seed, uint32_t threshold, float inv_keep, int drop_b0, int drop_h0,
    int drop_hg, void* stream) {
  const FwdF32Args a{static_cast<const uint8_t*>(mask), static_cast<float*>(o),
                     static_cast<float*>(lse), H, Sq, Sk, o_sb, o_sh, o_ss,
                     mask_sb, causal, scale, dropout, seed, threshold, inv_keep,
                     DropShard{(uint32_t)drop_b0, (uint32_t)drop_h0, (uint32_t)drop_hg}};
  const int st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (Dh) {
    case 64: return launch<64>(a, q, k, v, B, st, s);
    case 96: return launch<96>(a, q, k, v, B, st, s);
    case 128: return launch<128>(a, q, k, v, B, st, s);
    default: break;
  }
  if (Dh <= 128 || Dh % wide::CW != 0)
    return static_cast<int>(cudaErrorInvalidValue);   // no route takes it
  if (Dh <= 256)
    return Dh == 256 ? launch_wide<256, false>(a, q, k, v, B, Dh, st, s)
                     : launch_wide<192, false>(a, q, k, v, B, Dh, st, s);
  return wide::group_width_even(Dh, WIDE_FWD_SPLIT) == 384
             ? launch_wide<384, true>(a, q, k, v, B, Dh, st, s)
             : launch_wide<256, true>(a, q, k, v, B, Dh, st, s);
}

// The wide route's kernels' launch budgets, for chip_smoke.py's build
// report: out[3 i .. 3 i + 2] = (width of the column group, bytes of
// dynamic shared memory asked, threads) of the one-warpgroup instances at
// 192 and 256, then the split ones at 256 and 384; returns how many.
extern "C" int f32_fwd_wide_budgets(int* out) {
  const int rows[4][3] = {
      {192, (int)sizeof(FwdGroupSmem<192>) + 1024, 256},
      {256, (int)sizeof(FwdGroupSmem<256>) + 1024, 256},
      {256, (int)sizeof(FwdSplitSmem) + 1024, 384},
      {384, (int)sizeof(FwdSplitSmem) + 1024, 384}};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = rows[i][j];
  return 4;
}

// out: 3 f32 on the card (tf32_probe_kernel's); returns cudaGetLastError().
extern "C" int f32_tf32_probe(void* out, void* stream) {
  tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One launch of tf32_rate_kernel<n, rs> (n 16, 32 or 64; 96 with rs) on
// `blocks` blocks; out: 1 f32 on the card. Returns cudaGetLastError().
extern "C" int f32_wgmma_rate(void* out, int n, int rs, int reps, int blocks,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n * 2 + (rs != 0)) {
    case 32: return rate_launch<16, false>(out, reps, blocks, st);
    case 33: return rate_launch<16, true>(out, reps, blocks, st);
    case 64: return rate_launch<32, false>(out, reps, blocks, st);
    case 65: return rate_launch<32, true>(out, reps, blocks, st);
    case 128: return rate_launch<64, false>(out, reps, blocks, st);
    case 129: return rate_launch<64, true>(out, reps, blocks, st);
    case 193: return rate_launch<96, true>(out, reps, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
