// The flash-attention backward pair for head dims 64, 96 and 128 on Hopper
// (sm_90a): the dKV and dQ kernel templates, their tile shapes, and what
// the pair's instances share (the arguments, the tensor maps' launch, the
// gradient store). flash_attention_bwd.cu instantiates the shipped shapes
// (Shipped<D> below); the block-sweep tool's source
// (csrc/sweep/flash_bwd_sweep.cu) instantiates every candidate shape, the
// shipped one among them, so what the sweep times is what ships.
//
// A tile shape is a template argument:
//   DkvShape<D, WGS, STAGES, MINB>: WGS consumer warpgroups of 64 keys each
//     (a block owns 64 * WGS keys), a ring of STAGES (Q, dO) stages, and
//     MINB blocks an SM asked of the register allocator;
//   DqShape<D, STAGES, MINB>: one consumer warpgroup of 64 queries and a
//     producer warp, a ring of STAGES (K, V) stages, MINB blocks an SM.
//
// The math, for each (b, h), M the dropout keep mask and r its rate:
//   P  = exp(S - lse),  S = Q K^T * scale + key-mask bias [+ causal]
//   dV = (M o P / (1-r))^T dO,   dS = P o (M o (dO V^T) / (1-r) - D)
//   dK = dS^T Q * scale,         dQ = dS K * scale
// with D = rowsum(dO o O) and lse from the forward.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"
#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BR = 64;                      // rows of a warpgroup's tile, and of a walked tile
constexpr int TILE = BR * CHUNK_BYTES_ROW;  // one 32-column swizzled box of BR rows
constexpr int SMEM_LIMIT = 232448;          // bytes of shared memory a block may use

struct Strides {   // element strides of a (B, H, S, D) tensor, last dim contiguous
  int sb, sh, ss;
};

struct BwdArgs {
  const bf16 *q, *k, *v, *dout, *o;
  const uint8_t* mask;   // (B, Sk), nonzero = attend, or null
  const float* lse;      // contiguous (B*H, Sq)
  float* dvec;           // D = rowsum(dO o O), contiguous (B*H, Sq)
  bf16 *dq, *dk, *dv;
  int H, Sq, Sk;
  Strides qs, ks, vs, dos, os, dqs, dks, dvs;
  int mask_sb, causal;
  float scale, scale_log2;
  int dropout;
  uint32_t seed, threshold;
  float inv_keep;
  DropShard ds;          // the dropout mask's place in the global (B, H) grid
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;        // above 48 KB needs an opt-in
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = err == cudaSuccess;
  return err;
}

template <typename T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {   // 1024-byte aligned
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

// Write a (64 x N) accumulator times `mul` to rows row0 / row0 + 8 (< n_rows) of out.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], bf16* out, int ss, int row0,
                                           int n_rows, int t, float mul) {
#pragma unroll
  for (int dt = 0; dt < N / 4; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row0 * ss + col) =
          __floats2bfloat162_rn(acc[dt * 4] * mul, acc[dt * 4 + 1] * mul);
    if (row0 + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + 8) * ss + col) =
          __floats2bfloat162_rn(acc[dt * 4 + 2] * mul, acc[dt * 4 + 3] * mul);
  }
}

// acc = A B^T over D columns: A 64 rows at `a`, B 64 rows at `b`, both
// K-major in D / 32 swizzled boxes of TILE bytes. Issues D / 16 wgmma; no
// commit.
template <int D>
__device__ __forceinline__ void score_tile(float (&acc)[32], const void* a, const void* b) {
  const unsigned char* pa = static_cast<const unsigned char*>(a);
  const unsigned char* pb = static_cast<const unsigned char*>(b);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int off = (ks / 2) * TILE + (ks % 2) * 32;
    wgmma_m64n64k16_ss(acc, desc_b64(pa + off, 16, 512), desc_b64(pb + off, 16, 512), ks > 0);
  }
}

// acc += X B: X the 64 x 64 tile packed in `x` (16 bf16 pairs in the score
// layout: x[4 kk + j] is the A register j of k-step kk), B the 64 walked
// rows at `b` read MN-major (n = the head dim, LBO the next box). Issues 4
// wgmma; no commit.
template <int N>
__device__ __forceinline__ void grad_tile(float (&acc)[N], const uint32_t (&x)[16],
                                          const void* b) {
  const unsigned char* pb = static_cast<const unsigned char*>(b);
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk) {   // 16 walked rows a step
    const uint32_t pa[4] = {x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3]};
    wgmma_rs(acc, pa, desc_b64(pb + kk * 16 * CHUNK_BYTES_ROW, TILE, 512));
  }
}

// 2^x by the SFU alone (ex2.approx.ftz: a relative error under 2^-22, -inf
// gives 0); P is rounded to bf16 before any product, so the difference from
// exp2f does not show.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Wait until at most N wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep packed A operands live, unmoved, up to here: a wgmma reads them
// asynchronously, until its group is waited for.
__device__ __forceinline__ void hold_regs(uint32_t (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// The elementwise work of a 64 x 64 score tile: element x = 2m + e of a
// thread is row r = m & 1 (of two, 8 apart) and column c = (m >> 1) * 8 +
// 2t + e of the accumulator layout. The bodies are picked a tile at a time
// by uniform branches: with or without dropout (DROP), and EDGE for a tile
// that crosses Sq or the causal diagonal (its bounds checked element by
// element); an interior tile skips those checks. dQ's is in two halves, P
// while dP is still on the tensor cores, then dS (the keep bit of element
// x carried between them as bit x of `keep`); the dKV kernel, whose two
// warpgroups already overlap each other, gains nothing from that split.

// dKV: P^T and dS^T of 64 keys x 64 queries (rows keys key0 / key0 + 8,
// attended iff kv0 / kv1; columns queries q0 + c), packed as the A operands
// of dV += P_drop^T dO and dK += dS^T Q. lse (times log2 e) and D of the
// walked queries by column.
template <bool DROP, bool EDGE>
__device__ __forceinline__ void dkv_tile_math(const float (&sc)[32], const float (&dp)[32],
                                              uint32_t (&pa)[16], uint32_t (&da)[16],
                                              const float* lse, const float* dvec,
                                              const BwdArgs& a, int q0, int t, int key0,
                                              bool kv0, bool kv1, uint32_t drop0) {
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    float pd[2], ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int x = 2 * m + e, col = (m >> 1) * 8 + 2 * t + e, qi = q0 + col;
      const bool hi = m & 1;
      bool ok = hi ? kv1 : kv0;
      if (EDGE) ok = ok && qi < a.Sq && !(a.causal && key0 + (hi ? 8 : 0) > qi);
      const float p = ok ? fast_exp2(sc[x] * a.scale_log2 - lse[col]) : 0.f;
      if (DROP) {
        const bool keep = !ok || hash_keep(drop0 + (uint32_t)qi * (uint32_t)a.Sk +
                                               (hi ? 8u : 0u), a.seed, a.threshold);
        pd[e] = keep ? p * a.inv_keep : 0.f;
        ds[e] = p * ((keep ? dp[x] * a.inv_keep : 0.f) - dvec[col]);
      } else {
        pd[e] = p;
        ds[e] = p * (dp[x] - dvec[col]);
      }
    }
    pa[m] = pack_bf16(pd[0], pd[1]);
    da[m] = pack_bf16(ds[0], ds[1]);
  }
}

// dQ: P of 64 queries x 64 keys in place of S (rows: queries row0 /
// row0 + 8 with their lse times log2 e; columns: keys k0 + c with their
// key-mask bias).
template <bool DROP, bool EDGE>
__device__ __forceinline__ void dq_p(float (&sc)[32], uint32_t& keep, const float* bias,
                                     const BwdArgs& a, int k0, int t, int row0,
                                     const float (&lse)[2], const uint32_t (&drop)[2]) {
  keep = 0;
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int col = (x >> 2) * 8 + 2 * t + (x & 1), key = k0 + col, r = (x >> 1) & 1;
    float p = fast_exp2(sc[x] * a.scale_log2 + bias[col] - lse[r]);
    if (EDGE && a.causal && key > row0 + 8 * r) p = 0.f;
    sc[x] = p;
    if (DROP)
      keep |= (uint32_t)(p == 0.f || hash_keep(drop[r] + (uint32_t)key, a.seed, a.threshold))
              << x;
  }
}

// dQ: dS = P o (M o dP / (1-r) - D), D by row, packed as the A operand of
// dQ += dS K.
template <bool DROP>
__device__ __forceinline__ void dq_ds(const float (&sc)[32], const float (&dp)[32],
                                      uint32_t keep, uint32_t (&da)[16], const BwdArgs& a,
                                      const float (&dv)[2]) {
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    float ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int x = 2 * m + e, r = m & 1;
      const float g = DROP ? ((keep >> x) & 1u ? dp[x] * a.inv_keep : 0.f) : dp[x];
      ds[e] = sc[x] * (g - dv[r]);
    }
    da[m] = pack_bf16(ds[0], ds[1]);
  }
}

// ---- dKV ---------------------------------------------------------------------

template <int D_, int WGS_, int STAGES_, int MINB_>
struct DkvShape {
  static constexpr int D = D_, WGS = WGS_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int NCHUNK = D / CHUNK_COLS, SLAB = NCHUNK * TILE;   // 64 rows x D
  static constexpr int KEYS = WGS * BR, NTHREADS = WGS * 128;
  static constexpr bool DKV = true;
  // the ring refills the stage freed one tile before the last, so that
  // warp 0 (a consumer that also loads) does not wait on the slowest warp;
  // with 2 stages that would leave nothing in flight, so it refills the last
  static constexpr int LAG = STAGES >= 3 ? 1 : 0;
  static_assert(D % CHUNK_COLS == 0 && STAGES >= 2, "dKV shape");
};

template <class C>
struct DkvSmem {
  alignas(1024) unsigned char k[C::WGS][C::NCHUNK][TILE];   // the block's keys, 64 a warpgroup
  alignas(1024) unsigned char v[C::WGS][C::NCHUNK][TILE];
  alignas(1024) unsigned char q[C::STAGES][C::NCHUNK][TILE];     // the walked queries
  alignas(1024) unsigned char dout[C::STAGES][C::NCHUNK][TILE];
  float lse[C::STAGES][BR], dvec[C::STAGES][BR];   // their lse * log2(e) and D
  uint64_t own_full, full[C::STAGES], empty[C::STAGES];
};

// Warp-wide (warp 0): wait until the stage of walked tile `item` is free,
// write its queries' lse * log2(e) and D, and (lane 0) start its Q and dO loads.
template <class C>
__device__ __forceinline__ void dkv_issue(DkvSmem<C>& s, const CUtensorMap* q_map,
                                          const CUtensorMap* do_map, const BwdArgs& a, int b,
                                          int h, int qt0, int item, int lane) {
  const int st = item % C::STAGES, q0 = (qt0 + item) * BR;
  const size_t row = ((size_t)b * a.H + h) * a.Sq;
  float l[2], d[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = q0 + lane + 32 * e;
    const bool in = r < a.Sq;
    l[e] = in ? a.lse[row + r] * LOG2E : 0.f;
    d[e] = in ? a.dvec[row + r] : 0.f;
  }
  mbar_wait(&s.empty[st], ((item / C::STAGES) & 1) ^ 1);
  s.lse[st][lane] = l[0];
  s.lse[st][lane + 32] = l[1];
  s.dvec[st][lane] = d[0];
  s.dvec[st][lane + 32] = d[1];
  if (lane == 0) {
    mbar_arrive_expect_tx(&s.full[st], 2 * C::SLAB);
#pragma unroll
    for (int ch = 0; ch < C::NCHUNK; ++ch) {
      tma_load_4d(s.q[st][ch], q_map, &s.full[st], ch * CHUNK_COLS, q0, h, b);
      tma_load_4d(s.dout[st][ch], do_map, &s.full[st], ch * CHUNK_COLS, q0, h, b);
    }
  } else {
    mbar_arrive(&s.full[st]);
  }
}

// One block per (b, h, 64 * WGS keys). Each consumer warpgroup owns 64 keys
// and does all of their work: S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
// operands in shared memory), P^T and dS^T in registers (packed to bf16 as
// the A operands of the next products), dV += P_drop^T dO and dK += dS^T Q
// (m64nDk16, the walked tile read MN-major). Warp 0 also issues the loads.
// A block whose keys are all masked walks nothing and writes zeros; a
// warpgroup whose 64 keys are all masked leaves the walk to the other.
template <class C>
__global__ void __launch_bounds__(C::NTHREADS, C::MINB)
flash_bwd_dkv_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map, const BwdArgs a) {
  constexpr int D = C::D, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  auto& s = aligned_smem<DkvSmem<C>>(smem_raw);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * C::KEYS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + wg * BR + (warp % 4) * 16 + g, key1 = key0 + 8;   // this thread's keys
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  const bool kv0 = key0 < a.Sk && (mrow == nullptr || mrow[key0]);
  const bool kv1 = key1 < a.Sk && (mrow == nullptr || mrow[key1]);
  bool live = false;                        // this warpgroup owns an attended key
  int n_live = 0;
#pragma unroll
  for (int w = 0; w < C::WGS; ++w) {
    const bool any = __syncthreads_or(wg == w && (kv0 || kv1));
    n_live += any;
    live = wg == w ? any : live;
  }
  const int nq = (a.Sq + BR - 1) / BR;
  // causal: query tiles before the diagonal see no key of this block
  const int qt0 = a.causal ? min(nq, k0 / BR) : 0;
  const int n_items = n_live > 0 ? nq - qt0 : 0;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_items > 0) {
    if (threadIdx.x == 0) {
      mbar_init(&s.own_full, 1);
#pragma unroll
      for (int i = 0; i < STAGES; ++i) {
        mbar_init(&s.full[i], 32);                 // warp 0's lanes
        mbar_init(&s.empty[i], 4 * n_live);        // one lane a live consumer warp
      }
      fence_barrier_init();
    }
    __syncthreads();
    auto issue = [&](int item) {
      dkv_issue(s, &q_map, &do_map, a, b, h, qt0, item, lane);
    };
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&s.own_full, 2 * C::WGS * C::SLAB);
#pragma unroll
        for (int w = 0; w < C::WGS; ++w)
#pragma unroll
          for (int ch = 0; ch < C::NCHUNK; ++ch) {
            tma_load_4d(s.k[w][ch], &k_map, &s.own_full, ch * CHUNK_COLS, k0 + w * BR, h, b);
            tma_load_4d(s.v[w][ch], &v_map, &s.own_full, ch * CHUNK_COLS, k0 + w * BR, h, b);
          }
      }
      for (int i = 0; i < min(n_items, STAGES); ++i) issue(i);
    }

    if (live) {
      const uint32_t drop0 =
          drop_head(b, h, a.ds) * (uint32_t)a.Sq * (uint32_t)a.Sk + (uint32_t)key0;
      mbar_wait(&s.own_full, 0);
      for (int i = 0; i < n_items; ++i) {
        const int st = i % STAGES, q0 = (qt0 + i) * BR;
        mbar_wait(&s.full[st], (i / STAGES) & 1);
        float sc[32], dp[32];                     // S^T and dP^T: 64 keys x 64 queries
#pragma unroll
        for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        score_tile<D>(sc, s.k[wg], s.q[st]);      // K Q^T
        score_tile<D>(dp, s.v[wg], s.dout[st]);   // V dO^T
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);
        uint32_t pa[16], da[16];
        // the tile crosses Sq, or a key of this warpgroup lies past its first query
        const bool edge = q0 + BR > a.Sq || (a.causal && k0 + wg * BR + BR - 1 > q0);
        const float* lse = s.lse[st];
        const float* dvec = s.dvec[st];
        if (a.dropout) {
          if (edge) dkv_tile_math<true, true>(sc, dp, pa, da, lse, dvec, a, q0, t, key0, kv0, kv1, drop0);
          else dkv_tile_math<true, false>(sc, dp, pa, da, lse, dvec, a, q0, t, key0, kv0, kv1, drop0);
        } else {
          if (edge) dkv_tile_math<false, true>(sc, dp, pa, da, lse, dvec, a, q0, t, key0, kv0, kv1, drop0);
          else dkv_tile_math<false, false>(sc, dp, pa, da, lse, dvec, a, q0, t, key0, kv0, kv1, drop0);
        }
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
        grad_tile(dv, pa, s.dout[st]);            // dV += P_drop^T dO
        grad_tile(dk, da, s.q[st]);               // dK += dS^T Q
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dv);
        fence_regs(dk);
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[st]);   // this warp is done with the stage
        const int next = i - C::LAG + STAGES;
        if (warp == 0 && i >= C::LAG && next < n_items) issue(next);
      }
    } else if (warp == 0) {                   // warpgroup 0 has no key: warp 0 only loads
      for (int i = STAGES; i < n_items; ++i) issue(i);
    }
  }
  const size_t head_k = (size_t)b * a.dks.sb + (size_t)h * a.dks.sh;
  const size_t head_v = (size_t)b * a.dvs.sb + (size_t)h * a.dvs.sh;
  const int row0 = key0;
  store_rows(dk, a.dk + head_k, a.dks.ss, row0, a.Sk, t, a.scale);
  store_rows(dv, a.dv + head_v, a.dvs.ss, row0, a.Sk, t, 1.f);
}

// ---- dQ ----------------------------------------------------------------------

template <int D_, int STAGES_, int MINB_>
struct DqShape {
  static constexpr int D = D_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int NCHUNK = D / CHUNK_COLS, SLAB = NCHUNK * TILE;
  static constexpr int NTHREADS = 128 + 32;   // a consumer warpgroup and a producer warp
  static constexpr bool DKV = false;
  // dQ += dS K of a tile overlaps the next tile's score products; at D = 128
  // the registers that holds (the dS operand beside S, dP and dQ) make
  // ptxas serialize the products, so there the product is waited for at once
  static constexpr bool CROSS = D <= 96;
  static_assert(D % CHUNK_COLS == 0 && STAGES >= 2, "dQ shape");
};

template <class C>
struct DqSmem {
  alignas(1024) unsigned char q[C::NCHUNK][TILE];   // the block's queries
  alignas(1024) unsigned char dout[C::NCHUNK][TILE];
  alignas(1024) unsigned char k[C::STAGES][C::NCHUNK][TILE];   // the walked keys
  alignas(1024) unsigned char v[C::STAGES][C::NCHUNK][TILE];
  float bias[C::STAGES][BR];   // their key-mask bias: 0, or -inf (masked, past Sk)
  int tile[C::STAGES];         // which key tile the stage holds; -1 ends the walk
  uint64_t own_full, full[C::STAGES], empty[C::STAGES];
};

// One block per (b, h, 64 queries): the producer warp loads Q and dO once
// and streams the key tiles that hold an attended key (up to the diagonal,
// when causal) through the ring, reading each tile's mask bytes before it
// waits for a stage, so a fully masked tile costs one 64-byte read; the
// consumer warpgroup computes S = Q K^T and dP = dO V^T, forms dS in
// registers and accumulates dQ += dS K.
template <class C>
__global__ void __launch_bounds__(C::NTHREADS, C::MINB)
flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map, const BwdArgs a) {
  constexpr int D = C::D, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  auto& s = aligned_smem<DqSmem<C>>(smem_raw);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int n_tiles = (a.Sk + BR - 1) / BR;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BR - 1) / BR + 1);
  if (threadIdx.x == 0) {
    mbar_init(&s.own_full, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 32);   // the producer warp's lanes
      mbar_init(&s.empty[i], 4);   // one lane a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {                          // ---- producer warp ----
    if (lane == 0) {
      mbar_arrive_expect_tx(&s.own_full, 2 * C::SLAB);
#pragma unroll
      for (int ch = 0; ch < C::NCHUNK; ++ch) {
        tma_load_4d(s.q[ch], &q_map, &s.own_full, ch * CHUNK_COLS, q0, h, b);
        tma_load_4d(s.dout[ch], &do_map, &s.own_full, ch * CHUNK_COLS, q0, h, b);
      }
    }
    const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
    int item = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int r0 = j * BR + lane, r1 = r0 + 32;
      const bool in0 = r0 < a.Sk && (mrow == nullptr || mrow[r0]);
      const bool in1 = r1 < a.Sk && (mrow == nullptr || mrow[r1]);
      if (!__any_sync(0xffffffffu, in0 || in1)) continue;   // no attended key: skipped
      const int st = item % STAGES;
      mbar_wait(&s.empty[st], ((item / STAGES) & 1) ^ 1);
      s.bias[st][lane] = in0 ? 0.f : -INFINITY;
      s.bias[st][lane + 32] = in1 ? 0.f : -INFINITY;
      if (lane == 0) {
        s.tile[st] = j;
        mbar_arrive_expect_tx(&s.full[st], 2 * C::SLAB);
#pragma unroll
        for (int ch = 0; ch < C::NCHUNK; ++ch) {
          tma_load_4d(s.k[st][ch], &k_map, &s.full[st], ch * CHUNK_COLS, j * BR, h, b);
          tma_load_4d(s.v[st][ch], &v_map, &s.full[st], ch * CHUNK_COLS, j * BR, h, b);
        }
      } else {
        mbar_arrive(&s.full[st]);
      }
      ++item;
    }
    const int st = item % STAGES;           // the end of the walk: a stage with no tile
    mbar_wait(&s.empty[st], ((item / STAGES) & 1) ^ 1);
    if (lane == 0) s.tile[st] = -1;
    mbar_arrive(&s.full[st]);
    return;
  }

  // ---- the consumer warpgroup: S, dP, dS, dQ ----
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float lse[2] = {row0 < a.Sq ? a.lse[(size_t)bh * a.Sq + row0] * LOG2E : 0.f,
                        row1 < a.Sq ? a.lse[(size_t)bh * a.Sq + row1] * LOG2E : 0.f};
  const float dv[2] = {row0 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row0] : 0.f,
                       row1 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row1] : 0.f};
  const uint32_t drop0 = (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop[2] = {drop0, drop0 + 8u * (uint32_t)a.Sk};
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(&s.own_full, 0);
  // dQ += dS K of one tile runs under the next tile's score products (CROSS):
  // its stage is released, and its dS registers are free, after those are issued
  uint32_t da[16];
  int held = -1;                            // the stage of that product
  for (int item = 0;; ++item) {
    const int st = item % STAGES;
    mbar_wait(&s.full[st], (item / STAGES) & 1);
    const int j = s.tile[st];
    if (j < 0) break;
    const int k0 = j * BR;
    float sc[32], dp[32];                   // S and dP: 64 queries x 64 keys
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    score_tile<D>(sc, s.q, s.k[st]);        // S = Q K^T
    wgmma_commit();
    score_tile<D>(dp, s.dout, s.v[st]);     // dP = dO V^T, under P below
    wgmma_commit();
    if (held >= 0) {                        // the last tile's dQ product is done
      wgmma_wait_n<2>();
      hold_regs(da);
      fence_regs(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[held]);
    }
    wgmma_wait_n<1>();
    fence_regs(sc);
    uint32_t keep = 0;
    const bool edge = a.causal && k0 + BR - 1 > q0;   // a key past the block's first query
    if (a.dropout) {
      if (edge) dq_p<true, true>(sc, keep, s.bias[st], a, k0, t, row0, lse, drop);
      else dq_p<true, false>(sc, keep, s.bias[st], a, k0, t, row0, lse, drop);
    } else {
      if (edge) dq_p<false, true>(sc, keep, s.bias[st], a, k0, t, row0, lse, drop);
      else dq_p<false, false>(sc, keep, s.bias[st], a, k0, t, row0, lse, drop);
    }
    wgmma_wait0();
    fence_regs(dp);
    if (a.dropout) dq_ds<true>(sc, dp, keep, da, a, dv);
    else dq_ds<false>(sc, dp, keep, da, a, dv);
    fence_regs(dq);
    wgmma_fence();
    grad_tile(dq, da, s.k[st]);             // dQ += dS K
    wgmma_commit();
    held = st;
    if constexpr (!C::CROSS) {
      wgmma_wait0();
      hold_regs(da);
      fence_regs(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[st]);
      held = -1;
    }
  }
  wgmma_wait0();
  hold_regs(da);
  fence_regs(dq);
  store_rows(dq, a.dq + (size_t)b * a.dqs.sb + (size_t)h * a.dqs.sh, a.dqs.ss, row0, a.Sq, t,
             a.scale);
}

// ---- launch ------------------------------------------------------------------

template <class C>
constexpr int dkv_smem_bytes() { return sizeof(DkvSmem<C>) + 1024; }
template <class C>
constexpr int dq_smem_bytes() { return sizeof(DqSmem<C>) + 1024; }

// The four rank-4 maps of q, k, v and dO, read in boxes of 64 rows x 32 columns.
inline int make_bwd_maps(const BwdArgs& a, int B, int Dh, CUtensorMap (&m)[4]) {
  int err = make_head_map(&m[0], a.q, B, a.H, a.Sq, Dh, a.qs.sb, a.qs.sh, a.qs.ss, BR);
  if (err == 0) err = make_head_map(&m[1], a.k, B, a.H, a.Sk, Dh, a.ks.sb, a.ks.sh, a.ks.ss, BR);
  if (err == 0) err = make_head_map(&m[2], a.v, B, a.H, a.Sk, Dh, a.vs.sb, a.vs.sh, a.vs.ss, BR);
  if (err == 0)
    err = make_head_map(&m[3], a.dout, B, a.H, a.Sq, Dh, a.dos.sb, a.dos.sh, a.dos.ss, BR);
  return err;
}

template <class C>
int launch_dkv(const BwdArgs& a, int B, const CUtensorMap (&m)[4], cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<C>();
  static_assert(bytes <= SMEM_LIMIT, "dKV: shared memory over the limit");
  static bool ready = false;
  const cudaError_t e = allow_smem(flash_bwd_dkv_hopper_kernel<C>, bytes, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_hopper_kernel<C><<<dim3((a.Sk + C::KEYS - 1) / C::KEYS, B * a.H), C::NTHREADS,
                                   bytes, stream>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_dq(const BwdArgs& a, int B, const CUtensorMap (&m)[4], cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<C>();
  static_assert(bytes <= SMEM_LIMIT, "dQ: shared memory over the limit");
  static bool ready = false;
  const cudaError_t e = allow_smem(flash_bwd_dq_hopper_kernel<C>, bytes, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_hopper_kernel<C><<<dim3((a.Sq + BR - 1) / BR, B * a.H), C::NTHREADS, bytes,
                                  stream>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

// The pair at head dim Kv::D: the dKV kernel, then the dQ kernel.
template <class Kv, class Q>
int launch_hopper(const BwdArgs& a, int B, cudaStream_t stream) {
  static_assert(Kv::D == Q::D, "one head dim");
  CUtensorMap m[4];
  int err = make_bwd_maps(a, B, Kv::D, m);
  if (err == 0) err = launch_dkv<Kv>(a, B, m, stream);
  if (err == 0) err = launch_dq<Q>(a, B, m, stream);
  return err;
}

// The shapes that ship, chosen by the block sweep
// (sct_gan_tpu_torch/tools/sweep_flash_blocks.py) on an H100.
template <int D> struct Shipped;
template <> struct Shipped<64> {
  using Dkv = DkvShape<64, 1, 2, 2>;
  using Dq = DqShape<64, 2, 3>;
};
template <> struct Shipped<96> {
  using Dkv = DkvShape<96, 1, 2, 2>;
  using Dq = DqShape<96, 2, 2>;
};
template <> struct Shipped<128> {
  using Dkv = DkvShape<128, 1, 2, 2>;
  using Dq = DqShape<128, 2, 2>;
};

// Fill a BwdArgs from the C entry points' flat arguments (FLASH_BWD_PARAMS).
inline BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* dout,
                        const void* out, const void* mask, const void* lse, void* dvec, void* dq,
                        void* dk, void* dv, int H, int Sq, int Sk, const int (&st)[24],
                        int mask_sb, int causal, float scale, int dropout, uint32_t seed,
                        uint32_t threshold, float inv_keep, int drop_b0, int drop_h0,
                        int drop_hg) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.o = static_cast<const bf16*>(out);
  a.mask = static_cast<const uint8_t*>(mask);
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<float*>(dvec);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.dos, &a.os, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *all[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.mask_sb = mask_sb;
  a.causal = causal;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  a.dropout = dropout;
  a.seed = seed;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  a.ds = {(uint32_t)drop_b0, (uint32_t)drop_h0, (uint32_t)drop_hg};
  return a;
}

}  // namespace

// The backward entry points' parameters: flash_attention_bwd_bf16's (see
// flash_attention_bwd.cu), which the block sweep's entry shares ...
#define FLASH_BWD_PARAMS                                                                      \
  const void *q, const void *k, const void *v, const void *dout, const void *out,             \
      const void *mask, const void *lse, void *dvec, void *dq, void *dk, void *dv, int B,     \
      int H, int Sq, int Sk, int Dh, int q_sb, int q_sh, int q_ss, int k_sb, int k_sh,        \
      int k_ss, int v_sb, int v_sh, int v_ss, int do_sb, int do_sh, int do_ss, int o_sb,      \
      int o_sh, int o_ss, int dq_sb, int dq_sh, int dq_ss, int dk_sb, int dk_sh, int dk_ss,   \
      int dv_sb, int dv_sh, int dv_ss, int mask_sb, int causal, float scale, int dropout,     \
      uint32_t seed, uint32_t threshold, float inv_keep, int drop_b0, int drop_h0,            \
      int drop_hg, void *stream
// ... and the BwdArgs they give.
#define FLASH_BWD_ARGS                                                                        \
  bwd_args(q, k, v, dout, out, mask, lse, dvec, dq, dk, dv, H, Sq, Sk,                        \
           {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, o_sb,  \
            o_sh, o_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss},       \
           mask_sb, causal, scale, dropout, seed, threshold, inv_keep, drop_b0, drop_h0,      \
           drop_hg)
