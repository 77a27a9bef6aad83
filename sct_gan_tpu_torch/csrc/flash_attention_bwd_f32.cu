// Flash-attention backward for Hopper (sm_90a), f32: dQ, dK, dV in f32 from
// f32 q, k, v, dO, O and the forward's per-row LSE. The f32 instance of the
// backward pair (flash_attention_bwd.cu is the bf16 one).
//
// Replaces the TPU kernels of sct_gan_tpu/ops/flash_attention.py::
// _flash_backward on f32 operands, where the JAX kernels keep dS and P in
// the operands' dtype (lines 280-302, 352-375): _fa_bwd_fused_kernel (nk ==
// 1) and the _fa_dkv_kernel / _fa_dq_kernel pair (nk > 1). With M the
// dropout keep mask and r its rate:
//
//   P  = exp(S - lse),  S = Q K^T * scale + bias [+ causal]   (recomputed)
//   dV = (M o P / (1-r))^T dO
//   dS = P o (M o (dO V^T) / (1-r) - D),   D = rowsum(dO o O)
//   dK = dS^T Q * scale,   dQ = dS K * scale
//
// Three kernels, no atomics, so the gradients are bit-for-bit deterministic:
// D (flash_f32_dvec_kernel, a warp a row), a dKV kernel (blocks over keys,
// walking query tiles) and a dQ kernel (blocks over queries, walking key
// tiles). Both recompute S and dP: 7 products as run for the 5 of the math.
//
// Bound on an H100: the 5 products over the attended keys,
// 10*H*Sq*dh*sum_b(attended keys of row b) flops at f32 accuracy, ~165
// TFLOP/s by 3xTF32 (f32_attention.cuh): 0.25 ms at (8, 8, 1024, 96) under
// chip_smoke.py's key mask, against ~0.05 ms of bytes.
//
// Design: the forward's (flash_attention_fwd_f32.cu). A block is a
// transform warpgroup and one or two consumer warpgroups. The transform's
// first warp issues the TMA loads: the block's resident 64 rows once, then
// each walked tile into a raw ring; its four warps split each landed tile
// once, for the whole block, into its TF32 halves in wgmma's layout
// (f32_attention.cuh), into a ring of split stages. The consumer
// warpgroups take the walked tiles in turn, each with its own gradient
// accumulators, and sum them at the end in a fixed order (warpgroup 0's,
// then 1's). Every product is 3xTF32 on TF32 wgmma: the scores with A the
// resident rows (from shared memory, or their big half from registers:
// QREG) and B the tile, the gradients with P or dS split in registers as
// the A operand and the tile's transposed halves as B. P is 2^x of the
// scaled score less lse, both in the log2 domain (the SFU's exponent).
//   dKV: a block owns 64 keys (K and V resident). Per W-query tile the
//        transform makes Q's and dO's halves both ways: as landed (B of S^T
//        = K Q^T and dP^T = V dO^T) and transposed (B of dV += P_drop^T dO
//        and dK += dS^T Q); the consumers read its lse and D. It walks the
//        query tiles from the one holding its first key on, when causal; a
//        block whose 64 keys are all masked walks nothing and writes zeros.
//   dQ:  a block owns 64 queries (Q and dO resident; their big halves in
//        registers at 64 and 96) and walks the W-key tiles that hold an
//        attended key (TileWalk; up to the diagonal, when causal). Per tile
//        the transform makes K's halves both ways (B of S = Q K^T;
//        transposed, B of dQ += dS K) and V's (B of dP = dO V^T).
// Budget (bytes of shared memory: the resident halves + the split stages +
// the raw ring; the struct rounds up to 1 KB and 1 KB more aligns it):
//   dKV D = 64:  W 32, 2 split + 2 raw stages: 65536 + 131072 + 32768 = 229,376
//       D = 96:  W 16, 2 split + 2 raw:        98304 +  98304 + 24576 = 221,184
//       D = 128: W 16, 1 split + 2 raw:       131072 +  65536 + 32768 = 229,376
//   dQ  D = 64:  W 32, 3 split + 2 raw, QREG:  32768 + 147456 + 32768 = 212,992
//       D = 96:  W 32, 2 split + 1 raw, QREG:  49152 + 147456 + 24576 = 221,184
//       D = 128: W 16, 1 split + 3 raw:       131072 +  49152 + 49152 = 229,376
// dKV's f32 halves of 64 resident keys and of a query tile both ways leave
// room at D = 96 for 16-query tiles only, so its score products are wgmma
// of N = 16 with both operands in shared memory: ~40% of the TF32 rate on
// the card (chip_smoke.py --f32-times), which bounds it; holding K's or
// V's big half in registers does not fit beside dK and dV (D f32 a thread).
// Registers: dKV at 64 and 96 two consumer warpgroups (384 threads: 168 a
// thread), at 128 one (256 threads: 255); dQ one consumer warpgroup (255:
// Q's and dO's big halves, dQ, S, dP and dS's halves). No product is left
// on mma.sync.
// Waves on 132 SMs at (8, 8, 1024, 96): 1024 blocks each, 7.76 waves.
// Head dims over 128 take the wide route instead (flash_f32_{dkv,dq}_group_
// kernel and flash_f32_dq_split_kernel, below, after the same D): a block
// owns a group of the gradient's columns and computes S and dP once a tile
// over the head dim, in 64-column chunks that its TMA ring brings in, on
// the same 3xTF32 wgmma.
//
// The mask and causal semantics are the forward's: a masked key, a key past
// Sk, a query past Sq and a causal key j > i all get P = 0, so a fully-
// masked row gets dQ = 0 whatever its lse. The dropout keep bit is the
// forward's (hash_dropout.cuh), keyed by ((b*H + h)*Sq + i)*Sk + j.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_attention.cuh"
#include "hash_dropout.cuh"
#include "hopper_tile.cuh"

namespace {

using namespace f32att;
using namespace hopper;

struct St {
  int sb, sh, ss;
};

struct BwdF32Args {
  const float *dout, *o;
  const uint8_t* mask;   // (B, Sk), nonzero = attend, or null
  const float* lse;      // contiguous (B*H, Sq)
  float* dvec;           // D = rowsum(dO o O), contiguous (B*H, Sq)
  float *dq, *dk, *dv;
  int H, Sq, Sk;
  St dos, os, dqs, dks, dvs;
  int mask_sb, causal;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float inv_keep;
  DropShard ds;
};

constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T* head(T* p, const St& s, int b, int h) {
  return p + (size_t)b * s.sb + (size_t)h * s.sh;
}

// D = rowsum(dO o O), one warp a (b, h, i) row.
__global__ void __launch_bounds__(256)
flash_f32_dvec_kernel(const BwdF32Args a, int rows, int Dh) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = row % a.Sq, bh = row / a.Sq, b = bh / a.H, h = bh % a.H;
  const float* dor = head(a.dout, a.dos, b, h) + (size_t)i * a.dos.ss;
  const float* orow = head(a.o, a.os, b, h) + (size_t)i * a.os.ss;
  float s = 0.f;
  for (int c = lane; c < Dh; c += 32) s = fmaf(dor[c], orow[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.dvec[row] = s;
}

// A block's shape: D, the walked tile's rows W, split stages, raw stages,
// consumer warpgroups, and (dQ) whether the resident rows' big halves are
// held in registers (QREG: A of two of each score's three products; only
// their small halves stay in shared memory).
template <int D_, int W_, int STAGES_, int RAW_, int NWG_, bool QREG_ = false>
struct BwdShape {
  static constexpr int D = D_, W = W_, STAGES = STAGES_, RAW = RAW_, NWG = NWG_;
  static constexpr bool QREG = QREG_;
  static constexpr int ROWS = 64;                      // the block's resident rows
  static constexpr int NX = 128, NT = 128 * NWG + NX;  // NX: the transform's threads
  static constexpr int RES = ROWS * D * 4, TILE = W * D * 4, WORDS = (W + 31) / 32;
};

template <int D>
struct Dkv;
template <>
struct Dkv<64> : BwdShape<64, 32, 2, 2, 2> {};
template <>
struct Dkv<96> : BwdShape<96, 16, 2, 2, 2> {};
template <>
struct Dkv<128> : BwdShape<128, 16, 1, 2, 1> {};

template <int D>
struct Dq;
template <>
struct Dq<64> : BwdShape<64, 32, 3, 2, 1, true> {};
template <>
struct Dq<96> : BwdShape<96, 32, 2, 1, 1, true> {};
template <>
struct Dq<128> : BwdShape<128, 16, 1, 3, 1> {};

// Write a warpgroup's 64 x D gradient tile (accumulator layout) at rows r0,
// r0 + 8 of a strided head, times `mul`; rows >= n_rows are not written.
template <int D>
__device__ __forceinline__ void store_rows(float* base, int ss, const float (&acc)[D / 2],
                                           int r0, int n_rows, float mul, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<float2*>(base + (size_t)r0 * ss + col) =
          make_float2(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<float2*>(base + (size_t)(r0 + 8) * ss + col) =
          make_float2(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// Sum the consumer warpgroups' accumulators into warpgroup 0's, thread by
// thread, through shared memory xs (free by now): warpgroup 1 adds after 0.
template <int NWG, int N>
__device__ __forceinline__ void merge_warpgroups(float (&acc)[N], float* xs, int wg) {
  if constexpr (NWG == 2) {
    const int x = threadIdx.x % 128;
    bar_sync(COMBINE_BAR, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) xs[i * 128 + x] = acc[i];
    }
    bar_sync(COMBINE_BAR, 256);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += xs[i * 128 + x];
    }
  }
}

// S (or S^T, dP, dP^T) += A B^T, 3xTF32: A the resident halves (64 rows;
// its big half from registers ar when REG), B the stage's (W rows); issues
// 3 D / 8 wgmma, no commit.
template <class C, bool REG = false, int NR = 1>
__device__ __forceinline__ void scores(float (&acc)[C::W / 2], const unsigned char* ab,
                                       const unsigned char* as, const unsigned char* bb,
                                       const unsigned char* bs,
                                       const uint32_t (&ar)[NR][4] = {{0u, 0u, 0u, 0u}}) {
  // the resident halves as addresses the compiler cannot hoist: their
  // k-steps' descriptors are made afresh each tile (held across the walk
  // they cost two registers each)
  uint32_t ra[2] = {smem_u32(as), REG ? 0u : smem_u32(ab)};
  asm volatile("" : "+r"(ra[0]), "+r"(ra[1]));
#pragma unroll
  for (int kk = 0; kk < C::D / 8; ++kk)
    wgmma_tf32_ss(acc, km_desc_at(ra[0] + (kk >> 1) * C::ROWS * 64 + (kk & 1) * 32),
                  km_desc(bb, C::W, kk));
  const unsigned char* bt[2] = {bs, bb};
#pragma unroll
  for (int term = 0; term < 2; ++term)
#pragma unroll
    for (int kk = 0; kk < C::D / 8; ++kk) {
      if constexpr (REG)
        wgmma_tf32_rs(acc, ar[kk], km_desc(bt[term], C::W, kk));
      else
        wgmma_tf32_ss(acc, km_desc_at(ra[1] + (kk >> 1) * C::ROWS * 64 + (kk & 1) * 32),
                      km_desc(bt[term], C::W, kk));
    }
}

// acc += X Y over the stage's W rows, X's halves in A order (x[kk][r]), Y
// the stage's transposed halves (D rows); issues 3 W / 8 wgmma, no commit.
template <class C>
__device__ __forceinline__ void grad(float (&acc)[C::D / 2], const uint32_t (&xb)[C::W / 8][4],
                                     const uint32_t (&xs)[C::W / 8][4], const unsigned char* yb,
                                     const unsigned char* ys) {
#pragma unroll
  for (int kk = 0; kk < C::W / 8; ++kk) wgmma_tf32_rs(acc, xs[kk], km_desc(yb, C::D, kk));
#pragma unroll
  for (int kk = 0; kk < C::W / 8; ++kk) wgmma_tf32_rs(acc, xb[kk], km_desc(ys, C::D, kk));
#pragma unroll
  for (int kk = 0; kk < C::W / 8; ++kk) wgmma_tf32_rs(acc, xb[kk], km_desc(yb, C::D, kk));
}

// ---- dKV ------------------------------------------------------------------------

template <class C>
struct DkvSmem {
  alignas(1024) unsigned char kb[C::RES];   // resident: K's and V's halves (K, V as landed in kb, vb)
  alignas(1024) unsigned char ks[C::RES];
  alignas(1024) unsigned char vb[C::RES];
  alignas(1024) unsigned char vs[C::RES];
  alignas(1024) unsigned char qb[C::STAGES][C::TILE];    // split stages: Q's and dO's halves
  alignas(1024) unsigned char qs[C::STAGES][C::TILE];
  alignas(1024) unsigned char ob[C::STAGES][C::TILE];
  alignas(1024) unsigned char os[C::STAGES][C::TILE];
  alignas(1024) unsigned char qtb[C::STAGES][C::TILE];   // and transposed
  alignas(1024) unsigned char qts[C::STAGES][C::TILE];
  alignas(1024) unsigned char otb[C::STAGES][C::TILE];
  alignas(1024) unsigned char ots[C::STAGES][C::TILE];
  alignas(1024) unsigned char qraw[C::RAW][C::TILE];     // the raw ring: Q, dO as landed
  alignas(1024) unsigned char oraw[C::RAW][C::TILE];
  int n_items, t_first;                 // the walk, published on `meta`
  uint64_t meta, kv_full, kv_ready, raw_full[C::RAW], full[C::STAGES], empty[C::STAGES];
};

template <class C>
__device__ __forceinline__ void dkv_transform(DkvSmem<C>& s, const CUtensorMap* q_map,
                                              const CUtensorMap* k_map,
                                              const CUtensorMap* v_map,
                                              const CUtensorMap* do_map, const BwdF32Args& a,
                                              int k0, int b, int h) {
  constexpr int W = C::W, NX = C::NX;
  const int tid = threadIdx.x - 128 * C::NWG, warp = tid / 32, lane = tid % 32;
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  if (warp == 0) {
    bool on = false;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int key = k0 + 32 * u + lane;
      on |= key < a.Sk && (mrow == nullptr || mrow[key] != 0);
    }
    const bool any = __any_sync(0xffffffffu, on);
    const int t_first = a.causal ? k0 / W : 0, t_end = (a.Sq + W - 1) / W;
    if (lane == 0) {
      s.t_first = t_first;
      s.n_items = any ? max(0, t_end - t_first) : 0;
      mbar_arrive(&s.meta);
    }
  }
  bar_sync(XF_BAR, NX);
  const int n = s.n_items, t_first = s.t_first;
  if (n == 0) return;
  auto issue = [&](int item) {              // one thread: query tile item into its raw stage
    const int r = item % C::RAW;
    mbar_arrive_expect_tx(&s.raw_full[r], 2 * C::TILE);
    tma_tile<C::D>(s.qraw[r], q_map, &s.raw_full[r], W, (t_first + item) * W, h, b);
    tma_tile<C::D>(s.oraw[r], do_map, &s.raw_full[r], W, (t_first + item) * W, h, b);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&s.kv_full, 2 * C::RES);
    tma_tile<C::D>(s.kb, k_map, &s.kv_full, C::ROWS, k0, h, b);
    tma_tile<C::D>(s.vb, v_map, &s.kv_full, C::ROWS, k0, h, b);
    for (int item = 0; item < C::RAW && item < n; ++item) issue(item);
  }
  mbar_wait(&s.kv_full, 0);
  split_km<C::ROWS, C::D, NX>(s.kb, s.kb, s.ks, tid);
  split_km<C::ROWS, C::D, NX>(s.vb, s.vb, s.vs, tid);
  fence_proxy_async();
  mbar_arrive(&s.kv_ready);
  for (int item = 0; item < n; ++item) {
    const int r = item % C::RAW, st = item % C::STAGES;
    mbar_wait(&s.raw_full[r], (item / C::RAW) & 1);
    mbar_wait(&s.empty[st], ((item / C::STAGES) & 1) ^ 1);   // the stage is free
    split_t<W, C::D, NX, true>(s.qraw[r], s.qtb[st], s.qts[st], s.qb[st], s.qs[st], tid);
    split_t<W, C::D, NX, true>(s.oraw[r], s.otb[st], s.ots[st], s.ob[st], s.os[st], tid);
    fence_proxy_async();
    mbar_arrive(&s.full[st]);
    bar_sync(XF_BAR, NX);                   // raw stage r is read: free for item + RAW
    if (tid == 0 && item + C::RAW < n) issue(item + C::RAW);
  }
}

template <class C>
__device__ __forceinline__ void dkv_consume(DkvSmem<C>& s, const BwdF32Args& a, int k0, int b,
                                            int h, int wg) {
  constexpr int D = C::D, W = C::W;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;   // this thread's rows
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  const bool on0 = key0 < a.Sk && (mrow == nullptr || mrow[key0] != 0);
  const bool on1 = key1 < a.Sk && (mrow == nullptr || mrow[key1] != 0);
  const uint32_t head_index = drop_head(b, h, a.ds) * (uint32_t)a.Sq;
  const float* lse = a.lse + (size_t)(b * a.H + h) * a.Sq;
  const float* dvec = a.dvec + (size_t)(b * a.H + h) * a.Sq;
  const float scale_log2 = a.scale * LOG2E;  // P = 2^(S scale log2(e) - lse log2(e))
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&s.meta, 0);
  const int n = s.n_items, t_first = s.t_first;
  if (n > 0) mbar_wait(&s.kv_ready, 0);
  for (int item = wg; item < n; item += C::NWG) {
    const int st = item % C::STAGES;
    mbar_wait(&s.full[st], (item / C::STAGES) & 1);
    const int q0 = (t_first + item) * W;
    // the queries' lse and D, this thread's columns 8n + 2t (+ 1): loaded
    // now, read after the products
    float lq[W / 4], dd[W / 4];
#pragma unroll
    for (int x = 0; x < W / 4; ++x) {
      const int i = q0 + (x >> 1) * 8 + 2 * t + (x & 1);
      lq[x] = i < a.Sq ? lse[i] * LOG2E : 0.f;
      dd[x] = i < a.Sq ? dvec[i] : 0.f;
    }
    float sc[W / 2], dp[W / 2];             // S^T and dP^T: 64 keys x W queries
#pragma unroll
    for (int i = 0; i < W / 2; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    scores<C>(sc, s.kb, s.ks, s.qb[st], s.qs[st]);
    scores<C>(dp, s.vb, s.vs, s.ob[st], s.os[st]);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int x = 0; x < W / 2; ++x) {
      const int c = (x >> 2) * 8 + 2 * t + (x & 1), i = q0 + c;
      const int e = (x >> 1) & 1, key = e ? key1 : key0;
      const bool live = (e ? on1 : on0) && i < a.Sq && !(a.causal && key > i);
      const int cx = ((x >> 2) << 1) | (x & 1);   // column x's lq, dd
      const float p = live ? fast_exp2(fmaf(sc[x], scale_log2, -lq[cx])) : 0.f;
      float pd = p, dpd = dp[x];
      if (a.dropout) {
        const bool keep = hash_keep((head_index + (uint32_t)i) * (uint32_t)a.Sk + (uint32_t)key,
                                    a.seed, a.threshold);
        pd = keep ? p * a.inv_keep : 0.f;
        dpd = keep ? dpd * a.inv_keep : 0.f;
      }
      sc[x] = pd;                           // P_drop^T
      dp[x] = p * (dpd - dd[cx]);           // dS^T
    }
    uint32_t pb[W / 8][4], ps[W / 8][4], db[W / 8][4], ds[W / 8][4];
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      a_operand(sc, kk, pb[kk], ps[kk]);
      a_operand(dp, kk, db[kk], ds[kk]);
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    grad<C>(dv, pb, ps, s.otb[st], s.ots[st]);
    grad<C>(dk, db, ds, s.qtb[st], s.qts[st]);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      hold_regs(pb[kk]);
      hold_regs(ps[kk]);
      hold_regs(db[kk]);
      hold_regs(ds[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }

  static_assert(C::NWG == 1 || D * 128 * 4 <= 8 * C::STAGES * C::TILE, "merge scratch");
  float* xs = reinterpret_cast<float*>(&s.qb[0][0]);
  merge_warpgroups<C::NWG>(dk, xs, wg);
  merge_warpgroups<C::NWG>(dv, xs + (D / 2) * 128, wg);
  if (wg != 0) return;
  store_rows<D>(head(a.dk, a.dks, b, h), a.dks.ss, dk, key0, a.Sk, a.scale, t);
  store_rows<D>(head(a.dv, a.dvs, b, h), a.dvs.ss, dv, key0, a.Sk, 1.f, t);
}

template <int D>
__global__ void __launch_bounds__(Dkv<D>::NT, 1)
flash_f32_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map, const BwdF32Args a) {
  using C = Dkv<D>;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<C>& s = aligned_smem<DkvSmem<C>>(smem_raw);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, k0 = blockIdx.x * C::ROWS;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);   // warp-uniform
  if (threadIdx.x == 0) {
    mbar_init(&s.meta, 1);
    mbar_init(&s.kv_full, 1);
    mbar_init(&s.kv_ready, C::NX);
#pragma unroll
    for (int i = 0; i < C::RAW; ++i) mbar_init(&s.raw_full[i], 1);
#pragma unroll
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&s.full[i], C::NX);
      mbar_init(&s.empty[i], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == C::NWG)
    dkv_transform<C>(s, &q_map, &k_map, &v_map, &do_map, a, k0, b, h);
  else
    dkv_consume<C>(s, a, k0, b, h, wg);
}

// ---- dQ -------------------------------------------------------------------------

template <class C>
struct DqSmem {
  // resident: Q's and dO's small halves (QS, OS; Q and dO land there and are
  // split in place) and, unless QREG, their big halves (QB, OB)
  static constexpr int QS = 0, OS = 1, QB = 2, OB = 3;
  alignas(1024) unsigned char res[C::QREG ? 2 : 4][C::RES];
  alignas(1024) unsigned char kb[C::STAGES][C::TILE];    // split stages: K's and V's halves
  alignas(1024) unsigned char ks[C::STAGES][C::TILE];
  alignas(1024) unsigned char vb[C::STAGES][C::TILE];
  alignas(1024) unsigned char vs[C::STAGES][C::TILE];
  alignas(1024) unsigned char ktb[C::STAGES][C::TILE];   // K's, transposed
  alignas(1024) unsigned char kts[C::STAGES][C::TILE];
  alignas(1024) unsigned char kraw[C::RAW][C::TILE];     // the raw ring: K, V as landed
  alignas(1024) unsigned char vraw[C::RAW][C::TILE];
  uint32_t bits[C::STAGES][C::WORDS];   // the stage's key-mask bits (tile_bits)
  int tile[C::STAGES];                  // the stage's first key
  uint32_t raw_bits[C::RAW][C::WORDS];
  int raw_tile[C::RAW];
  int n_live;
  uint64_t meta, qo_full, qo_read, qo_ready, raw_full[C::RAW], full[C::STAGES],
      empty[C::STAGES];
};

template <class C>
__device__ __forceinline__ void dq_transform(DqSmem<C>& s, const CUtensorMap* q_map,
                                             const CUtensorMap* k_map,
                                             const CUtensorMap* v_map,
                                             const CUtensorMap* do_map, const BwdF32Args& a,
                                             int q0, int b, int h) {
  constexpr int W = C::W, NX = C::NX;
  const int tid = threadIdx.x - 128 * C::NWG, warp = tid / 32, lane = tid % 32;
  int n_tiles = (a.Sk + W - 1) / W;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + C::ROWS, a.Sq) - 1) / W + 1);
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  TileWalk<W> walk(mrow, a.Sk, n_tiles);
  if (warp == 0) {
    const int n = walk.count(lane);
    if (lane == 0) {
      s.n_live = n;
      mbar_arrive(&s.meta);
    }
  }
  bar_sync(XF_BAR, NX);
  const int n_live = s.n_live;
  if (n_live == 0) return;
  auto issue = [&](int r) {                 // warp 0: the next live tile into raw stage r
    const int k0 = walk.next(lane) * W;
    uint32_t kb[C::WORDS];
    tile_bits<W>(kb, mrow, k0, a.Sk, lane);
    if (lane == 0) {
      s.raw_tile[r] = k0;
#pragma unroll
      for (int u = 0; u < C::WORDS; ++u) s.raw_bits[r][u] = kb[u];
      mbar_arrive_expect_tx(&s.raw_full[r], 2 * C::TILE);
      tma_tile<C::D>(s.kraw[r], k_map, &s.raw_full[r], W, k0, h, b);
      tma_tile<C::D>(s.vraw[r], v_map, &s.raw_full[r], W, k0, h, b);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(&s.qo_full, 2 * C::RES);
      tma_tile<C::D>(s.res[s.QS], q_map, &s.qo_full, C::ROWS, q0, h, b);
      tma_tile<C::D>(s.res[s.OS], do_map, &s.qo_full, C::ROWS, q0, h, b);
    }
    for (int r = 0; r < C::RAW && r < n_live; ++r) issue(r);
  }
  if constexpr (C::QREG) {                  // the consumers took the big halves
    mbar_wait(&s.qo_read, 0);
    split_km<C::ROWS, C::D, NX, false>(s.res[s.QS], nullptr, s.res[s.QS], tid);
    split_km<C::ROWS, C::D, NX, false>(s.res[s.OS], nullptr, s.res[s.OS], tid);
  } else {
    mbar_wait(&s.qo_full, 0);
    split_km<C::ROWS, C::D, NX>(s.res[s.QS], s.res[s.QB], s.res[s.QS], tid);
    split_km<C::ROWS, C::D, NX>(s.res[s.OS], s.res[s.OB], s.res[s.OS], tid);
  }
  fence_proxy_async();
  mbar_arrive(&s.qo_ready);
  for (int item = 0; item < n_live; ++item) {
    const int r = item % C::RAW, st = item % C::STAGES;
    mbar_wait(&s.raw_full[r], (item / C::RAW) & 1);
    mbar_wait(&s.empty[st], ((item / C::STAGES) & 1) ^ 1);   // the stage is free
    split_t<W, C::D, NX, true>(s.kraw[r], s.ktb[st], s.kts[st], s.kb[st], s.ks[st], tid);
    split_km<W, C::D, NX>(s.vraw[r], s.vb[st], s.vs[st], tid);
    if (tid == 0) {
      s.tile[st] = s.raw_tile[r];
#pragma unroll
      for (int u = 0; u < C::WORDS; ++u) s.bits[st][u] = s.raw_bits[r][u];
    }
    fence_proxy_async();
    mbar_arrive(&s.full[st]);
    bar_sync(XF_BAR, NX);                   // raw stage r is read: free for tile item + RAW
    if (warp == 0 && item + C::RAW < n_live) issue(r);
  }
}

template <class C>
__device__ __forceinline__ void dq_consume(DqSmem<C>& s, const BwdF32Args& a, int q0, int b,
                                           int h, int wg) {
  constexpr int D = C::D, W = C::W;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int bh = b * a.H + h;
  // the rows' lse in the log2 domain: P = 2^(S scale log2(e) - lse log2(e))
  const float lse0 = row0 < a.Sq ? a.lse[(size_t)bh * a.Sq + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[(size_t)bh * a.Sq + row1] * LOG2E : 0.f;
  const float scale_log2 = a.scale * LOG2E;
  const float dv0 = row0 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row0] : 0.f;
  const float dv1 = row1 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row1] : 0.f;
  const uint32_t drop0 =
      (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(&s.meta, 0);
  const int n_live = s.n_live;
  // QREG: Q's and dO's big halves as A fragments (k-step kk: rows g, g + 8
  // of the warp's 16, columns 8 kk + t, + 4), read as they landed
  uint32_t qr[C::QREG ? D / 8 : 1][4], orr[C::QREG ? D / 8 : 1][4];
  if (n_live > 0) {
    if constexpr (C::QREG) {
      mbar_wait(&s.qo_full, 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = warp * 16 + g + 8 * (r & 1), col = 8 * kk + t + 4 * (r >> 1);
          const uint32_t off = km_off(C::ROWS, row, col >> 2) + (col & 3) * 4;
          qr[kk][r] = *reinterpret_cast<const uint32_t*>(s.res[s.QS] + off) & 0xffffe000u;
          orr[kk][r] = *reinterpret_cast<const uint32_t*>(s.res[s.OS] + off) & 0xffffe000u;
        }
      mbar_arrive(&s.qo_read);
    }
    mbar_wait(&s.qo_ready, 0);
  }
  for (int item = wg; item < n_live; item += C::NWG) {
    const int st = item % C::STAGES;
    mbar_wait(&s.full[st], (item / C::STAGES) & 1);
    const int k0 = s.tile[st];
    uint32_t kb[C::WORDS];
#pragma unroll
    for (int u = 0; u < C::WORDS; ++u) kb[u] = s.bits[st][u];
    float sc[W / 2], dp[W / 2];             // S and dP: 64 queries x W keys
#pragma unroll
    for (int i = 0; i < W / 2; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    // (with QREG the big halves come from qr and orr: the first operand is unread)
    scores<C, C::QREG>(sc, s.res[C::QREG ? s.QS : s.QB], s.res[s.QS], s.kb[st], s.ks[st], qr);
    scores<C, C::QREG>(dp, s.res[C::QREG ? s.OS : s.OB], s.res[s.OS], s.vb[st], s.vs[st], orr);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int x = 0; x < W / 2; ++x) {
      const int col = (x >> 2) * 8 + 2 * t + (x & 1), e = (x >> 1) & 1;
      const int row = e ? row1 : row0;
      const bool live = key_on(kb, col) && row < a.Sq && !(a.causal && k0 + col > row);
      const float p = live ? fast_exp2(fmaf(sc[x], scale_log2, -(e ? lse1 : lse0))) : 0.f;
      float dpd = dp[x];
      if (a.dropout) {
        const bool keep =
            hash_keep((e ? drop1 : drop0) + (uint32_t)(k0 + col), a.seed, a.threshold);
        dpd = keep ? dpd * a.inv_keep : 0.f;
      }
      sc[x] = p * (dpd - (e ? dv1 : dv0));  // dS
    }
    uint32_t db[W / 8][4], ds[W / 8][4];
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) a_operand(sc, kk, db[kk], ds[kk]);
    fence_regs(dq);
    wgmma_fence();
    grad<C>(dq, db, ds, s.ktb[st], s.kts[st]);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      hold_regs(db[kk]);
      hold_regs(ds[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }

  static_assert(C::NWG == 1 || (D / 2) * 128 * 4 <= 6 * C::STAGES * C::TILE, "merge scratch");
  merge_warpgroups<C::NWG>(dq, reinterpret_cast<float*>(&s.kb[0][0]), wg);
  if (wg != 0) return;
  store_rows<D>(head(a.dq, a.dqs, b, h), a.dqs.ss, dq, row0, a.Sq, a.scale, t);
}

template <int D>
__global__ void __launch_bounds__(Dq<D>::NT, 1)
flash_f32_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const BwdF32Args a) {
  using C = Dq<D>;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<C>& s = aligned_smem<DqSmem<C>>(smem_raw);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, q0 = blockIdx.x * C::ROWS;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);   // warp-uniform
  if (threadIdx.x == 0) {
    mbar_init(&s.meta, 1);
    mbar_init(&s.qo_full, 1);
    mbar_init(&s.qo_read, 128 * C::NWG);    // the consumer threads (QREG)
    mbar_init(&s.qo_ready, C::NX);
#pragma unroll
    for (int i = 0; i < C::RAW; ++i) mbar_init(&s.raw_full[i], 1);
#pragma unroll
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&s.full[i], C::NX);
      mbar_init(&s.empty[i], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == C::NWG)
    dq_transform<C>(s, &q_map, &k_map, &v_map, &do_map, a, q0, b, h);
  else
    dq_consume<C>(s, a, q0, b, h, wg);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;        // above 48 KB needs an opt-in
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = err == cudaSuccess;
  return err;
}

// q, k, v, dO: their TMA maps at box_rows (the resident 64 rows or the
// walked tile's), element strides st (q, k, v, dO); walk_q: Q and dO are
// walked (dKV), else K and V (dQ).
template <int D>
int make_maps(CUtensorMap (&m)[4], const void* const (&p)[4], const St (&st)[4], int B,
              int H, int Sq, int Sk, bool walk_q, int w) {
  const int S[4] = {Sq, Sk, Sk, Sq};
  const bool walked[4] = {walk_q, !walk_q, !walk_q, walk_q};
  for (int i = 0; i < 4; ++i) {
    const int e = make_f32_map(&m[i], p[i], B, H, S[i], D, st[i].sb, st[i].sh, st[i].ss,
                               walked[i] ? w : 64);
    if (e != 0) return e;
  }
  return 0;
}

template <int D>
int launch(const BwdF32Args& a, const void* const (&p)[4], const St (&st)[4], int B,
           cudaStream_t s) {
  constexpr int dkv_bytes = sizeof(DkvSmem<Dkv<D>>) + 1024;
  constexpr int dq_bytes = sizeof(DqSmem<Dq<D>>) + 1024;
  static_assert(dkv_bytes <= 232448 && dq_bytes <= 232448, "shared memory over the limit");
  static bool dkv_ok = false, dq_ok = false;
  CUtensorMap dkv_maps[4], dq_maps[4];
  int e = make_maps<D>(dkv_maps, p, st, B, a.H, a.Sq, a.Sk, true, Dkv<D>::W);
  if (e == 0) e = make_maps<D>(dq_maps, p, st, B, a.H, a.Sq, a.Sk, false, Dq<D>::W);
  if (e != 0) return e;
  cudaError_t err = allow_smem(flash_f32_dkv_kernel<D>, dkv_bytes, dkv_ok);
  if (err == cudaSuccess) err = allow_smem(flash_f32_dq_kernel<D>, dq_bytes, dq_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_f32_dkv_kernel<D><<<dim3((a.Sk + 63) / 64, B * a.H), Dkv<D>::NT, dkv_bytes, s>>>(
      dkv_maps[0], dkv_maps[1], dkv_maps[2], dkv_maps[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_f32_dq_kernel<D><<<dim3((a.Sq + 63) / 64, B * a.H), Dq<D>::NT, dq_bytes, s>>>(
      dq_maps[0], dq_maps[1], dq_maps[2], dq_maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

// ---- head dims over 128: the wide route ----------------------------------------
// A head dim D over 128 (a multiple of wide::CW = 64; the wrapper pads any
// other) runs in column groups (f32_attention.cuh, wide): a block owns 64
// rows and a group of DG columns of the gradients it writes, walks the
// other side's 64-row tiles and computes S and dP once a tile, over the
// whole head dim, one 64 x 64 x 64 step of 3xTF32 m64n64k8 wgmma a chunk
// pair, each operand a unit that the transform warpgroup loads by TMA into
// a ring and splits once (warp 0 loads, warps 1-3 split: as landed, or
// transposed for a gradient's B). P and dS are formed once a tile and read
// as the A of every gradient step, one step a 64-column chunk of the group.
//   dQ at 192: 64 queries, one group. 256 threads: the transform warpgroup
//        (warp 4 walks the 64-key tiles that hold an attended key, up to
//        the diagonal when causal, and loads Q's, K's, dO's and V's chunks
//        in turn, then K's, to transpose) and one consumer warpgroup: S =
//        Q K^T and dP = dO V^T step by step (each step issued before the
//        one before is released), dS = P (dP_drop - D) with its halves in
//        registers, then dQ[:, c] += dS K[:, c]. Budget: 7 stages x 32 KB =
//        229,376 bytes, one block an SM; registers (255 a thread) dQ (96),
//        S and dP (32 each), then dS's halves (64): 226 used.
//   dQ over 192 (flash_f32_dq_split_kernel): 64 queries, groups of 256 or
//        384 columns, two consumer warpgroups a half each (one group at
//        256 and 384). 384 threads: the same transform (warps 8-11);
//        warpgroup 0 computes S and P and hands P (its sign the keep bit)
//        to warpgroup 1 through shared memory, warpgroup 1 dP and dS, whose
//        halves it stores once; both then add dS K[:, c] over their half of
//        the group's chunks. Budget: 6 stages x 32 KB + dS's halves 32 KB (P
//        handed over in their place) = 229,376 bytes; registers (168 a
//        thread: three warps share each of the SM's four register files)
//        dQ's half (DG / 4) and S or dP (32).
//   dKV: 64 keys, DG 128 or 192 (one group at 192, two of 128 at 256, two
//        of 192 at 384). 384 threads: the transform warpgroup (warp 8
//        loads the query tiles' units, from the one holding the block's
//        first key on when causal: K's, Q's, V's and dO's chunks in turn,
//        then the group's chunks of dO and Q, to transpose) and two
//        consumer warpgroups, one a gradient. Warpgroup 0 computes S^T = K
//        Q^T and P, stores P_drop^T's halves and hands P (its sign the keep
//        bit) to warpgroup 1, then dV[:, c] += P_drop^T dO[:, c];
//        warpgroup 1 computes dP^T = V dO^T, dS^T = P (dP_drop - D), stores
//        its halves, then dK[:, c] += dS^T Q[:, c]. Budget: 5 stages x 32
//        KB + P_drop^T's and dS^T's halves 64 KB (P handed over in dS^T's
//        place) = 229,376 bytes; registers (168) dK or dV (DG / 2) and S^T
//        or dP^T (32). A block whose 64 keys are all masked walks nothing
//        and writes zeros.
// In the two-warpgroup kernels each warpgroup waits for a score step's
// products before it takes the next step's units (two warpgroups each
// holding a step and waiting for the next could deadlock the ring); the
// other warpgroup's products fill the gap. Values the walk needs but its
// products do not (the block's indices, this thread's) are read from
// %ctaid and %tid where they are used: held beside the accumulators at 168
// registers they spilled. The products run, at NG groups of dK and dV and
// MQ of dQ, (2 NG + 2 MQ + 3) / 5 times the math's: 1.4 at 192, 1.8 at
// 256 and 384 (a block a 64-column chunk: 3, 3.8, 5.4). No atomics: the
// gradients are bit-for-bit deterministic.
constexpr int DQ_STAGES = 7;
constexpr int DKV_STAGES = 5;
constexpr int WIDE_DQ = 192;    // widest group of the one-warpgroup dQ
constexpr int WIDE_DKV = 192;   // of dK and dV
constexpr int CONS_BAR = 2;     // consumer warpgroup w's named barrier: CONS_BAR + w

struct DqGroupSmem {
  wide::Ring<DQ_STAGES> r;
  int n_live;
  uint64_t meta;
};

struct DkvGroupSmem {   // the small members last: no padding between them
  alignas(1024) unsigned char pt[2][wide::HALF];   // P_drop^T's halves (warpgroup 0)
  alignas(1024) unsigned char st[2][wide::HALF];   // dS^T's halves (warpgroup 1); P handed in st[0]
  wide::Ring<DKV_STAGES> r;
  float qv[2][wide::CW];                           // the query tile's lse log2(e) (0), D (1)
  int n_items, t_first;
  uint64_t meta, ex_full, ex_empty;
};

// Write a warpgroup's 64 x 64-column gradient block c of group g
// (accumulator layout) at rows r0, r0 + 8 of a strided head, times `mul`;
// rows >= n_rows and columns >= D are not written.
__device__ __forceinline__ void store_block(float* base, int ss, const float (&acc)[32], int col0,
                                            int D, int r0, int n_rows, float mul, int t) {
#pragma unroll
  for (int n = 0; n < wide::CW / 8; ++n) {
    const int col = col0 + n * 8 + 2 * t;
    if (col >= D) continue;
    if (r0 < n_rows)
      *reinterpret_cast<float2*>(base + (size_t)r0 * ss + col) =
          make_float2(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<float2*>(base + (size_t)(r0 + 8) * ss + col) =
          make_float2(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// ---- dQ (wide) --------------------------------------------------------------------

// The transform warpgroup of a dQ block (DqGroupSmem or DqSplitSmem), tid
// its thread in [0, 128).
template <int DG, class Smem>
__device__ __forceinline__ void dq_group_transform(Smem& s, const CUtensorMap* q_map,
                                                   const CUtensorMap* k_map,
                                                   const CUtensorMap* v_map,
                                                   const CUtensorMap* do_map,
                                                   const BwdF32Args& a, int D, int q0, int g,
                                                   int b, int h, int tid) {
  constexpr int NCG = DG / wide::CW;
  const int warp = tid / 32, lane = tid % 32;
  const int nc = D / wide::CW, upt = 4 * nc + NCG;
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
    } else if (x < 4 * nc) {                 // Q, K, dO, V of chunk x / 4
      const CUtensorMap* m = (x & 2) ? ((x & 1) ? v_map : do_map) : ((x & 1) ? k_map : q_map);
      s.r.load(v, m, (x >> 2) * wide::CW, (x & 1) ? k0 : q0, h, b, ln);
    } else {                                 // K of the group's chunk, to transpose
      s.r.load(v, k_map, (g * NCG + x - 4 * nc) * wide::CW, k0, h, b, ln);
    }
  };
  s.r.feed(s.n_live * upt, tid, issue, [&](int u) { return u % upt >= 4 * nc; });
}

template <int DG>
__device__ __forceinline__ void dq_group_consume(DqGroupSmem& s, const BwdF32Args& a, int D,
                                                 int q0, int g, int b, int h) {
  constexpr int NCG = DG / wide::CW;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  const int bh = b * a.H + h, nc = D / wide::CW;
  // the rows' lse in the log2 domain: P = 2^(S scale log2(e) - lse log2(e))
  const float lse0 = row0 < a.Sq ? a.lse[(size_t)bh * a.Sq + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[(size_t)bh * a.Sq + row1] * LOG2E : 0.f;
  const float scale_log2 = a.scale * LOG2E;
  const float dv0 = row0 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row0] : 0.f;
  const float dv1 = row1 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row1] : 0.f;
  const uint32_t drop0 =
      (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;
  float dq[NCG][32];
#pragma unroll
  for (int c = 0; c < NCG; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  mbar_wait(&s.meta, 0);
  const int n_live = s.n_live;
  int u = 0;
  for (int item = 0; item < n_live; ++item) {
    float sc[32], dp[32];                     // S and dP: 64 queries x 64 keys
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    int k0 = 0;
    uint32_t kb[2] = {0u, 0u};
    for (int c = 0; c < nc; ++c, u += 4) {
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
      if (c > 0) {                            // dP's step before is read
        wgmma_wait_n<1>();
        s.r.release(u - 2, lane);
        s.r.release(u - 1, lane);
      }
      const unsigned char* oc = s.r.wait(u + 2);
      const unsigned char* vc = s.r.wait(u + 3);
      fence_regs(dp);
      wgmma_fence();
      wide::prod3_units(dp, oc, vc);
      wgmma_commit();
      wgmma_wait_n<1>();                      // S's step is read
      s.r.release(u, lane);
      s.r.release(u + 1, lane);
    }
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
    s.r.release(u - 2, lane);
    s.r.release(u - 1, lane);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int col = (x >> 2) * 8 + 2 * t + (x & 1), e = (x >> 1) & 1;
      const int row = e ? row1 : row0;
      const bool live = key_on(kb, col) && row < a.Sq && !(a.causal && k0 + col > row);
      const float p = live ? fast_exp2(fmaf(sc[x], scale_log2, -(e ? lse1 : lse0))) : 0.f;
      float dpd = dp[x];
      if (a.dropout) {
        const bool keep =
            hash_keep((e ? drop1 : drop0) + (uint32_t)(k0 + col), a.seed, a.threshold);
        dpd = keep ? dpd * a.inv_keep : 0.f;
      }
      sc[x] = p * (dpd - (e ? dv1 : dv0));  // dS
    }
    // dS's halves in registers (64, beside dQ's 96), the A of dQ[:, c] +=
    // dS K[:, c]
    uint32_t ab[8][4], as[8][4];
    wide::a_frags(sc, ab, as);
#pragma unroll
    for (int c = 0; c < NCG; ++c, ++u) {
      const uint32_t kt = smem_u32(s.r.wait(u));
      fence_regs(dq[c]);
      wgmma_fence();
      wide::prod3_rs(dq[c], ab, as, kt, kt + wide::HALF);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait_n<1>();
        fence_regs(dq[c - 1]);
        s.r.release(u - 1, lane);
      }
    }
    wgmma_wait0();
    fence_regs(dq[NCG - 1]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      hold_regs(ab[kk]);
      hold_regs(as[kk]);
    }
    s.r.release(u - 1, lane);
  }
  float* base = head(a.dq, a.dqs, b, h);
#pragma unroll
  for (int c = 0; c < NCG; ++c)
    store_block(base, a.dqs.ss, dq[c], g * DG + c * wide::CW, D, row0, a.Sq, a.scale, t);
}

template <int DG>
__global__ void __launch_bounds__(256, 1)
flash_f32_dq_group_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map, const BwdF32Args a,
                          int D) {
  extern __shared__ unsigned char smem_raw[];
  DqGroupSmem& s = aligned_smem<DqGroupSmem>(smem_raw);
  const int ng = wide::groups(D, WIDE_DQ), g = blockIdx.x % ng;
  const int q0 = (blockIdx.x / ng) * wide::CW, b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  if (threadIdx.x == 0) {
    mbar_init(&s.meta, 1);
    s.r.init();
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128)
    dq_group_transform<DG>(s, &q_map, &k_map, &v_map, &do_map, a, D, q0, g, b, h,
                           threadIdx.x - 128);
  else
    dq_group_consume<DG>(s, a, D, q0, g, b, h);
}

// ---- dKV (wide) -------------------------------------------------------------------

// A wide-route block's (first of its 64 rows, column group, b, h) for
// groups at most WIDEST columns, read from %ctaid where it is used
// (wide::cta).
template <int WIDEST>
struct GroupBlock {
  int r0, g, b, h;
  __device__ GroupBlock(const BwdF32Args& a, int D) {
    uint32_t x, y;
    wide::cta(x, y);
    const int ng = wide::groups(D, WIDEST);
    r0 = (int)(x / ng) * wide::CW;
    g = (int)(x % ng);
    b = (int)y / a.H;
    h = (int)y % a.H;
  }
};
using DkvBlock = GroupBlock<WIDE_DKV>;

template <int DG>
__device__ __forceinline__ void dkv_group_transform(DkvGroupSmem& s, const CUtensorMap* q_map,
                                                    const CUtensorMap* k_map,
                                                    const CUtensorMap* v_map,
                                                    const CUtensorMap* do_map,
                                                    const BwdF32Args& a, int D) {
  constexpr int NCG = DG / wide::CW;
  const DkvBlock blk(a, D);
  const int k0 = blk.r0, g = blk.g, b = blk.b, h = blk.h;
  const int tid = threadIdx.x - 256, warp = tid / 32, lane = tid % 32;
  const int nc = D / wide::CW, upt = 4 * nc + 2 * NCG;
  if (warp == 0) {
    const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
    bool on = false;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int key = k0 + 32 * x + lane;
      on |= key < a.Sk && (mrow == nullptr || mrow[key] != 0);
    }
    const bool any = __any_sync(0xffffffffu, on);
    const int t_first = a.causal ? k0 / wide::CW : 0, t_end = (a.Sq + wide::CW - 1) / wide::CW;
    if (lane == 0) {
      s.n_items = any ? max(0, t_end - t_first) : 0;
      s.t_first = t_first;
      mbar_arrive(&s.meta);
    }
  }
  mbar_wait(&s.meta, 0);
  const int t_first = s.t_first;
  auto issue = [&](int v, int ln) {          // warp 0: unit v of the walk
    const int x = v % upt, q0 = (t_first + v / upt) * wide::CW;
    if (x < 4 * nc) {                        // K, Q, V, dO of chunk x / 4
      const CUtensorMap* m = (x & 2) ? ((x & 1) ? do_map : v_map) : ((x & 1) ? q_map : k_map);
      s.r.load(v, m, (x >> 2) * wide::CW, (x & 1) ? q0 : k0, h, b, ln);
    } else {                                 // dO, Q of the group's chunk, to transpose
      const int y = x - 4 * nc;
      s.r.load(v, (y & 1) ? q_map : do_map, (g * NCG + (y >> 1)) * wide::CW, q0, h, b, ln);
    }
  };
  s.r.feed(s.n_items * upt, tid, issue, [&](int u) { return u % upt >= 4 * nc; });
}

// Warpgroup wg of a dKV block: 0 computes S^T, P and dV, 1 dP^T, dS and dK.
template <int DG>
__device__ __forceinline__ void dkv_group_consume(DkvGroupSmem& s, const BwdF32Args& a, int D,
                                                  int wg) {
  constexpr int NCG = DG / wide::CW;
  float gr[NCG][32];                           // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int c = 0; c < NCG; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) gr[c][i] = 0.f;

  mbar_wait(&s.meta, 0);
  for (int item = 0; item < *(volatile int*)&s.n_items; ++item) {
    const int nc = D / wide::CW, upt = 4 * nc + 2 * NCG;
    const int q0 = (*(volatile int*)&s.t_first + item) * wide::CW, base = item * upt;
    float* ex = reinterpret_cast<float*>(s.st[0]);   // P handed over: ex[i * 128 + x]
    float sc[32];                             // S^T (0) or dP^T (1): 64 keys x 64 queries
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    for (int c = 0; c < nc; ++c) {            // K Q^T, or V dO^T, a chunk a step
      const int u = base + 4 * c + 2 * wg;
      const unsigned char* ac = s.r.wait(u);
      const unsigned char* bc = s.r.wait(u + 1);
      fence_regs(sc);
      wgmma_fence();
      wide::prod3_units(sc, ac, bc);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      s.r.release(u, wide::wg_thread() % 32);
      s.r.release(u + 1, wide::wg_thread() % 32);
    }
    // the tile's lse log2(e) or D, staged once (this warpgroup read the
    // last tile's before its store_a barrier); held in registers, 16 a
    // thread, they would spill dK or dV
    if (wide::wg_thread() < wide::CW) {              // warpgroup 0 the queries' lse, 1 their D
      const int x_ = wide::wg_thread();
      const DkvBlock blk(a, D);
      const int i = q0 + x_;
      const float* qvec = (wg == 0 ? a.lse : a.dvec) + (size_t)(blk.b * a.H + blk.h) * a.Sq;
      s.qv[wg][x_] = i < a.Sq ? qvec[i] * (wg == 0 ? LOG2E : 1.f) : 0.f;
    }
    bar_sync(CONS_BAR + wg, 128);
    if (wg == 0) {
      const DkvBlock blk(a, D);
      const int x_ = wide::wg_thread(), lane = x_ % 32, warp = x_ / 32, t = lane & 3;
      const int key0 = blk.r0 + warp * 16 + (lane >> 2), key1 = key0 + 8;   // this thread's
      const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)blk.b * a.mask_sb;
      const bool on0 = key0 < a.Sk && (mrow == nullptr || mrow[key0] != 0);
      const bool on1 = key1 < a.Sk && (mrow == nullptr || mrow[key1] != 0);
      const uint32_t head_index = drop_head(blk.b, blk.h, a.ds) * (uint32_t)a.Sq;
      const float scale_log2 = a.scale * LOG2E;   // P = 2^(S scale log2(e) - lse log2(e))
      // P, handed to warpgroup 1 once it has read the last one (its dK
      // products are complete), the keep bit in its sign
      mbar_wait(&s.ex_empty, (item & 1) ^ 1);
      // an 8-column block at a time (__syncwarp keeps the next block's
      // loads from being hoisted beside dV)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = (x >> 2) * 8 + 2 * t + (x & 1), i = q0 + c;
        const int e = (x >> 1) & 1, key = e ? key1 : key0;
        const bool live = (e ? on1 : on0) && i < a.Sq && !(a.causal && key > i);
        const float p = live ? fast_exp2(fmaf(sc[x], scale_log2, -s.qv[0][c])) : 0.f;
        bool keep = true;
        if (a.dropout)
          keep = hash_keep((head_index + (uint32_t)i) * (uint32_t)a.Sk + (uint32_t)key, a.seed,
                           a.threshold);
        ex[x * 128 + x_] = keep ? p : -p;
        sc[x] = keep ? p * (a.dropout ? a.inv_keep : 1.f) : 0.f;   // P_drop^T
        if ((x & 3) == 3) __syncwarp();
      }
      mbar_arrive(&s.ex_full);
    } else {
      const int x_ = wide::wg_thread(), t = x_ & 3;
      mbar_wait(&s.ex_full, item & 1);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const float pe = ex[x * 128 + x_];
        float dpd = sc[x];
        if (a.dropout) dpd = (__float_as_uint(pe) >> 31) ? 0.f : dpd * a.inv_keep;
        sc[x] = fabsf(pe) * (dpd - s.qv[1][(x >> 2) * 8 + 2 * t + (x & 1)]);   // dS^T
        if ((x & 3) == 3) __syncwarp();
      }
      bar_sync(CONS_BAR + 1, 128);            // every hand-over read: dS^T takes its place
    }
    // P_drop^T's or dS^T's halves (this warpgroup's products of the tile
    // before read them and are complete)
    wide::store_a(sc, wg == 0 ? s.pt[0] : s.st[0], wg == 0 ? s.pt[1] : s.st[1],
                  wide::wg_thread() / 32, wide::wg_thread() % 32);
    fence_proxy_async();
    bar_sync(CONS_BAR + wg, 128);
    const uint32_t ab = smem_u32(wg == 0 ? s.pt[0] : s.st[0]);
    const uint32_t as = smem_u32(wg == 0 ? s.pt[1] : s.st[1]);
#pragma unroll
    for (int c = 0; c < NCG; ++c) {           // dV[:, c] += P_drop^T dO[:, c]; dK: dS^T Q
      const int u = base + 4 * nc + 2 * c + wg;
      const uint32_t yc = smem_u32(s.r.wait(u));
      fence_regs(gr[c]);
      wgmma_fence();
      wide::prod3(gr[c], ab, as, yc, yc + wide::HALF);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait_n<1>();
        fence_regs(gr[c - 1]);
        s.r.release(u - 2, wide::wg_thread() % 32);
      }
    }
    wgmma_wait0();
    fence_regs(gr[NCG - 1]);
    s.r.release(base + 4 * nc + 2 * (NCG - 1) + wg, wide::wg_thread() % 32);
    if (wg == 1) mbar_arrive(&s.ex_empty);    // dS^T's place is free for the next P
  }
  const DkvBlock blk(a, D);
  const int x_ = wide::wg_thread(), lane = x_ % 32, warp = x_ / 32, t = lane & 3;
  float* out = wg == 0 ? head(a.dv, a.dvs, blk.b, blk.h) : head(a.dk, a.dks, blk.b, blk.h);
  const int ss = wg == 0 ? a.dvs.ss : a.dks.ss, key0 = blk.r0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int c = 0; c < NCG; ++c)
    store_block(out, ss, gr[c], blk.g * DG + c * wide::CW, D, key0, a.Sk,
                wg == 0 ? 1.f : a.scale, t);
}

template <int DG>
__global__ void __launch_bounds__(384, 1)
flash_f32_dkv_group_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map, const BwdF32Args a,
                           int D) {
  extern __shared__ unsigned char smem_raw[];
  DkvGroupSmem& s = aligned_smem<DkvGroupSmem>(smem_raw);
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);   // warp-uniform
  if (threadIdx.x == 0) {
    mbar_init(&s.meta, 1);
    mbar_init(&s.ex_full, 128);
    mbar_init(&s.ex_empty, 128);
    s.r.init();
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == 2)
    dkv_group_transform<DG>(s, &q_map, &k_map, &v_map, &do_map, a, D);
  else
    dkv_group_consume<DG>(s, a, D, wg);
}

// ---- dQ over 192 columns, split over two warpgroups --------------------------------

constexpr int DQ_SPLIT_STAGES = 6;
constexpr int WIDE_DQ_SPLIT = 384;   // widest group: 192 columns a warpgroup

struct DqSplitSmem {   // the small members last: no padding between them
  alignas(1024) unsigned char st[2][wide::HALF];   // dS's halves; P handed over in st[0]
  wide::Ring<DQ_SPLIT_STAGES> r;
  int n_live;
  uint64_t meta, ex_full, ds_full, ds_empty;
};

// Warpgroup wg of a split dQ block: 0 computes S and P and hands P over, 1
// dP and dS; each then adds dS K[:, c] over its half of the group's chunks.
template <int DG>
__device__ __forceinline__ void dq_split_consume(DqSplitSmem& s, const BwdF32Args& a, int D,
                                                 int wg) {
  constexpr int NH = DG / wide::CW / 2;      // each warpgroup's chunks of dQ
  float gr[NH][32];
#pragma unroll
  for (int c = 0; c < NH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) gr[c][i] = 0.f;

  mbar_wait(&s.meta, 0);
  for (int item = 0; item < *(volatile int*)&s.n_live; ++item) {
    const int nc = D / wide::CW, upt = 4 * nc + 2 * NH, base = item * upt;
    float* ex = reinterpret_cast<float*>(s.st[0]);   // P handed over: ex[i * 128 + x]
    float sc[32];                             // S (0) or dP (1): 64 queries x 64 keys
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    int k0 = 0;                               // the key tile (warpgroup 0)
    uint32_t kb[2] = {0u, 0u};
    for (int c = 0; c < nc; ++c) {            // Q K^T, or dO V^T, a chunk a step
      const int u = base + 4 * c + 2 * wg;
      const unsigned char* ac = s.r.wait(u);
      const unsigned char* bc = s.r.wait(u + 1);
      if (wg == 0 && c == 0) {                // the tile's first unit: its row and bits
        k0 = s.r.tile[s.r.slot(u)];
        kb[0] = s.r.bits[s.r.slot(u)][0];
        kb[1] = s.r.bits[s.r.slot(u)][1];
      }
      fence_regs(sc);
      wgmma_fence();
      wide::prod3_units(sc, ac, bc);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      s.r.release(u, wide::wg_thread() % 32);
      s.r.release(u + 1, wide::wg_thread() % 32);
    }
    const GroupBlock<WIDE_DQ_SPLIT> blk(a, D);
    const int x_ = wide::wg_thread(), t = x_ & 3;
    const int row0 = blk.r0 + (x_ / 32) * 16 + ((x_ % 32) >> 2), row1 = row0 + 8;
    const size_t bh = (size_t)(blk.b * a.H + blk.h) * a.Sq;
    if (wg == 0) {
      // P, handed to warpgroup 1 once both have read the last dS (their
      // products of the tile before are complete), the keep bit in its sign
      const float scale_log2 = a.scale * LOG2E;
      const float lse0 = row0 < a.Sq ? a.lse[bh + row0] * LOG2E : 0.f;
      const float lse1 = row1 < a.Sq ? a.lse[bh + row1] * LOG2E : 0.f;
      const uint32_t drop0 =
          (drop_head(blk.b, blk.h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
      mbar_wait(&s.ds_empty, (item & 1) ^ 1);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int col = (x >> 2) * 8 + 2 * t + (x & 1), e = (x >> 1) & 1;
        const int row = e ? row1 : row0;
        const bool live = key_on(kb, col) && row < a.Sq && !(a.causal && k0 + col > row);
        const float p = live ? fast_exp2(fmaf(sc[x], scale_log2, -(e ? lse1 : lse0))) : 0.f;
        bool keep = true;
        if (a.dropout)
          keep = hash_keep(drop0 + (e ? 8u * (uint32_t)a.Sk : 0u) + (uint32_t)(k0 + col),
                           a.seed, a.threshold);
        ex[x * 128 + x_] = keep ? p : -p;
        if ((x & 3) == 3) __syncwarp();
      }
      mbar_arrive(&s.ex_full);
    } else {
      const float dv0 = row0 < a.Sq ? a.dvec[bh + row0] : 0.f;
      const float dv1 = row1 < a.Sq ? a.dvec[bh + row1] : 0.f;
      mbar_wait(&s.ex_full, item & 1);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const float pe = ex[x * 128 + x_];
        float dpd = sc[x];
        if (a.dropout) dpd = (__float_as_uint(pe) >> 31) ? 0.f : dpd * a.inv_keep;
        sc[x] = fabsf(pe) * (dpd - (((x >> 1) & 1) ? dv1 : dv0));   // dS
        if ((x & 3) == 3) __syncwarp();
      }
      bar_sync(CONS_BAR + 1, 128);            // every hand-over read: dS takes its place
      wide::store_a(sc, s.st[0], s.st[1], x_ / 32, x_ % 32);
      fence_proxy_async();
      mbar_arrive(&s.ds_full);
    }
    mbar_wait(&s.ds_full, item & 1);          // dS's halves stored
    const uint32_t ab = smem_u32(s.st[0]), as = smem_u32(s.st[1]);
#pragma unroll
    for (int c = 0; c < NH; ++c) {            // dQ[:, c] += dS K[:, c], this half's chunks
      const int u = base + 4 * nc + wg * NH + c;
      const uint32_t yc = smem_u32(s.r.wait(u));
      fence_regs(gr[c]);
      wgmma_fence();
      wide::prod3(gr[c], ab, as, yc, yc + wide::HALF);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait_n<1>();
        fence_regs(gr[c - 1]);
        s.r.release(u - 1, wide::wg_thread() % 32);
      }
    }
    wgmma_wait0();
    fence_regs(gr[NH - 1]);
    s.r.release(base + 4 * nc + wg * NH + NH - 1, wide::wg_thread() % 32);
    mbar_arrive(&s.ds_empty);                 // dS's place is free for the next P
  }
  const GroupBlock<WIDE_DQ_SPLIT> blk(a, D);
  const int x_ = wide::wg_thread();
  const int row0 = blk.r0 + (x_ / 32) * 16 + ((x_ % 32) >> 2);
  float* base = head(a.dq, a.dqs, blk.b, blk.h);
#pragma unroll
  for (int c = 0; c < NH; ++c)
    store_block(base, a.dqs.ss, gr[c], blk.g * DG + (wg * NH + c) * wide::CW, D, row0, a.Sq,
                a.scale, x_ & 3);
}

template <int DG>
__global__ void __launch_bounds__(384, 1)
flash_f32_dq_split_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map, const BwdF32Args a,
                          int D) {
  extern __shared__ unsigned char smem_raw[];
  DqSplitSmem& s = aligned_smem<DqSplitSmem>(smem_raw);
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);   // warp-uniform
  if (threadIdx.x == 0) {
    mbar_init(&s.meta, 1);
    mbar_init(&s.ex_full, 128);
    mbar_init(&s.ds_full, 128);
    mbar_init(&s.ds_empty, 256);
    s.r.init();
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == 2) {
    const GroupBlock<WIDE_DQ_SPLIT> blk(a, D);
    dq_group_transform<DG>(s, &q_map, &k_map, &v_map, &do_map, a, D, blk.r0, blk.g, blk.b,
                           blk.h, threadIdx.x - 256);
  } else {
    dq_split_consume<DG>(s, a, D, wg);
  }
}

template <class Smem, typename Kernel>
int launch_group(Kernel kernel, int threads, bool& ok, const CUtensorMap (&m)[4],
                 const BwdF32Args& a, int D, int rows, int ng, int B, cudaStream_t s) {
  constexpr int bytes = sizeof(Smem) + 1024;
  static_assert(bytes <= 232448, "shared memory over the limit");
  const cudaError_t err = allow_smem(kernel, bytes, ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((rows + wide::CW - 1) / wide::CW * ng, B * a.H), threads, bytes, s>>>(
      m[0], m[1], m[2], m[3], a, D);
  return static_cast<int>(cudaGetLastError());
}

template <int DKV_DG>
int launch_dkv(const BwdF32Args& a, const CUtensorMap (&m)[4], int B, int D, cudaStream_t s) {
  static bool ok = false;
  return launch_group<DkvGroupSmem>(flash_f32_dkv_group_kernel<DKV_DG>, 384, ok, m, a, D, a.Sk,
                                    wide::groups(D, WIDE_DKV), B, s);
}

// dQ: at 192 one warpgroup holds the group (DqGroupSmem); over 192 two
// warpgroups split it (DqSplitSmem), groups of 256 or 384 columns
template <int DG>
int launch_dq(const BwdF32Args& a, const CUtensorMap (&m)[4], int B, int D, cudaStream_t s) {
  static bool ok = false;
  if constexpr (DG == 192)
    return launch_group<DqGroupSmem>(flash_f32_dq_group_kernel<DG>, 256, ok, m, a, D, a.Sq,
                                     wide::groups(D, WIDE_DQ), B, s);
  else
    return launch_group<DqSplitSmem>(flash_f32_dq_split_kernel<DG>, 384, ok, m, a, D, a.Sq,
                                     wide::groups(D, WIDE_DQ_SPLIT), B, s);
}

}  // namespace

// The wide route's kernels' launch budgets, for chip_smoke.py's build
// report: out[3 i .. 3 i + 2] = (width of the column group, bytes of
// dynamic shared memory asked, threads) of dQ at 192, the split dQ at 256
// and 384, then dKV at 128 and 192; returns how many.
extern "C" int f32_bwd_wide_budgets(int* out) {
  const int rows[5][3] = {
      {192, (int)sizeof(DqGroupSmem) + 1024, 256},
      {256, (int)sizeof(DqSplitSmem) + 1024, 384},
      {384, (int)sizeof(DqSplitSmem) + 1024, 384},
      {128, (int)sizeof(DkvGroupSmem) + 1024, 384},
      {192, (int)sizeof(DkvGroupSmem) + 1024, 384}};
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = rows[i][j];
  return 5;
}

// The bf16 entry point's arguments (flash_attention_bwd.cu), for f32 q, k,
// v, dout, out, dq, dk, dv: (B, H, S, Dh) with element strides (sb, sh, ss)
// and the last dimension contiguous; q, k, v, dout on 16-byte lines with
// strides of whole 16-byte units (their TMA maps), out and the gradients on
// 8-byte lines; Dh 64, 96, 128 or, on the wide route, a multiple of 64 over
// 128. lse: the forward's, dvec: f32 (B*H*Sq) scratch the entry fills with
// D. Returns the first error.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, const void* out,
    const void* mask, const void* lse, void* dvec, void* dq, void* dk, void* dv, int B,
    int H, int Sq, int Sk, int Dh, int q_sb, int q_sh, int q_ss, int k_sb, int k_sh,
    int k_ss, int v_sb, int v_sh, int v_ss, int do_sb, int do_sh, int do_ss, int o_sb,
    int o_sh, int o_ss, int dq_sb, int dq_sh, int dq_ss, int dk_sb, int dk_sh, int dk_ss,
    int dv_sb, int dv_sh, int dv_ss, int mask_sb, int causal, float scale, int dropout,
    uint32_t seed, uint32_t threshold, float inv_keep, int drop_b0, int drop_h0,
    int drop_hg, void* stream) {
  const BwdF32Args a{static_cast<const float*>(dout), static_cast<const float*>(out),
                     static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
                     static_cast<float*>(dvec), static_cast<float*>(dq),
                     static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
                     {do_sb, do_sh, do_ss}, {o_sb, o_sh, o_ss}, {dq_sb, dq_sh, dq_ss},
                     {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss},
                     mask_sb, causal, scale, dropout, seed, threshold, inv_keep,
                     DropShard{(uint32_t)drop_b0, (uint32_t)drop_h0, (uint32_t)drop_hg}};
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B * H > 65535 ||
      (Dh != 64 && Dh != 96 && Dh != 128 && (Dh <= 128 || Dh % wide::CW != 0)))
    return static_cast<int>(cudaErrorInvalidValue);   // no route takes it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const p[4] = {q, k, v, dout};
  const St st[4] = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
                    {do_sb, do_sh, do_ss}};
  const int rows = B * H * Sq;
  flash_f32_dvec_kernel<<<(rows + 7) / 8, 256, 0, s>>>(a, rows, Dh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (Dh) {
    case 64: return launch<64>(a, p, st, B, s);
    case 96: return launch<96>(a, p, st, B, s);
    case 128: return launch<128>(a, p, st, B, s);
    default: break;
  }
  CUtensorMap m[4];                          // q, k, v, dO: every tile 64 rows
  const int S[4] = {Sq, Sk, Sk, Sq};
  for (int i = 0; i < 4; ++i) {
    const int err = make_f32_map(&m[i], p[i], B, H, S[i], Dh, st[i].sb, st[i].sh,
                                 st[i].ss, wide::CW);
    if (err != 0) return err;
  }
  const int err = wide::group_width(Dh, WIDE_DKV) == 192 ? launch_dkv<192>(a, m, B, Dh, s)
                                                        : launch_dkv<128>(a, m, B, Dh, s);
  if (err != 0) return err;
  if (Dh <= 192) return launch_dq<192>(a, m, B, Dh, s);
  return wide::group_width_even(Dh, WIDE_DQ_SPLIT) == 384 ? launch_dq<384>(a, m, B, Dh, s)
                                                          : launch_dq<256>(a, m, B, Dh, s);
}
