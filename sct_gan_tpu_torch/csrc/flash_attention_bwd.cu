// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV in bf16 from bf16
// q, k, v, dO and the forward's f32 per-row statistics.
//
// Replaces the TPU kernels of sct_gan_tpu/ops/flash_attention.py::
// _flash_backward: _fa_bwd_fused_kernel (nk == 1, every call at L = 1024),
// and the _fa_dkv_kernel / _fa_dq_kernel pair (nk > 1, Sk > 1024). With
// M the dropout keep mask and r its rate:
//
//   P  = exp(S - lse),  S = Q K^T * scale + bias [+ causal]   (recomputed)
//   dV = (M o P / (1-r))^T dO
//   dS = P o (M o (dO V^T) / (1-r) - D),   D = rowsum(dO o O)  (from torch)
//   dK = dS^T Q * scale,   dQ = dS K * scale
//
// Three kernels, no atomics, so the gradients are bit-for-bit deterministic:
// D = rowsum(dO o O) (flash_bwd_dvec_kernel, one row a thread), then a dKV
// kernel (blocks over keys, walking query tiles) and a dQ kernel (blocks
// over queries, walking key tiles). Both recompute S and dP: 7 products as
// run for the 5 of the math.
//
// Bound on an H100: the 5 products over the attended keys,
// 10*H*Sq*dh*sum_b(attended keys of row b) flops at 989 TFLOP/s (a masked
// key adds nothing to dQ and gets dK = dV = 0), against Q, O, dO, dQ, dK, dV
// and the attended keys' K and V rows at 3.35 TB/s: at (8, 8, 1024, 96),
// 0.065 ms of products with every key attended, 0.042 ms under
// chip_smoke.py's key mask (5301 of 8192 keys); compute-bound. What bounds
// the kernels on the card is their elementwise work, not the products: it
// scales with H * Sq * Sk (the same at 64, 96 and 128 for H * d = 768: at
// 64 the pair is the slowest, with 12 heads), and the dropout hash, an
// exponent and the dS arithmetic are paid in both kernels.
//
// Head dims 64, 96 and 128: flash_bwd_hopper.cuh's templates, at the
// shapes Shipped<D> there names (chosen by the block sweep, tools/
// sweep_flash_blocks.py). Both kernels read every tile by TMA into the
// 64-byte-swizzled layout of hopper_tile.cuh (rank-4 maps from the
// caller's strides, so the model's head views pass as they are; rows past
// S read as zeros) through a ring of STAGES stages with full/empty
// mbarriers, and run every product on wgmma:
//   dKV: a block owns 64 keys per consumer warpgroup, K and V resident;
//        each warpgroup computes S^T = K Q^T and dP^T = V dO^T (m64n64k16
//        from shared memory), P^T and dS^T in registers (the dropout keep
//        bit never leaves them), and accumulates dV += P_drop^T dO and dK
//        += dS^T Q (m64nDk16, P^T / dS^T from registers, the walked tile
//        read MN-major). One warpgroup holds a whole head row of both
//        gradients, D f32 a thread, so nothing passes between warpgroups.
//        Warp 0 also issues the loads; a block whose keys are all masked
//        walks nothing and writes zeros, and a warpgroup whose 64 keys are
//        all masked sits the walk out. The sweep ships one warpgroup a
//        block, two blocks an SM: two warpgroups sharing a block's query
//        tiles were no faster, and blocks of 64 keys skip masked keys finer.
//   dQ:  a block owns 64 queries (Q and dO resident), one consumer
//        warpgroup and a producer warp; the producer reads each 64-key
//        tile's mask bytes before it waits for a stage and streams only
//        the tiles holding an attended key (up to the diagonal, when
//        causal), so a fully masked tile costs one 64-byte read. The
//        consumer computes S and dP, P while dP is still on the tensor
//        cores, then dS, and dQ += dS K under the next tile's score
//        products (up to D = 96).
// Budget (the shipped shapes at 64 / 96 / 128; ptxas -v in PERF.md §6):
// dKV K + V 16 / 24 / 32 KB and 2 stages of Q + dO (16 / 24 / 32 KB each):
// 51 / 75 / 99 KB, two blocks of 128 threads an SM; registers dK + dV (D
// f32), S^T + dP^T (64) and the packed P^T and dS^T (32), under the 255 a
// thread may have. dQ: Q + dO and 2 stages of K + V: 50 / 74 / 98 KB, three
// / two / two blocks of 160 threads an SM; registers dQ (D / 2 f32), S +
// dP (64) and the packed dS (16), under 128 at 64 (three blocks). ptxas -v
// must show no spills in any instance.
//
// The mask and causal semantics are the forward's: a masked key, a key past
// Sk, a query past Sq and a causal key j > i all get P = 0 (the TPU kernel's
// S <= -1e29 guard), so a fully-masked row gets dQ = 0 whatever its lse.
// The dropout mask is the hash keep mask of the forward (hash_dropout.cuh),
// keyed by ((b*H + h)*Sq + i)*Sk + j over the true Sq and Sk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_hopper.cuh"

namespace {

// ---- head dims 192 and 256, and the chunked route over 256: TMA + wgmma ----
//
// Past 128 columns one warpgroup cannot hold a head row of both dK and dV
// (flash_bwd_hopper.cuh's design), so these kernels split the dKV work
// between two warpgroups. They are built as K1 is (flash_attention_fwd.cu):
// the walked tiles stream through a ring of shared-memory stages by TMA
// (rank-4 maps from the caller's strides, the 64-byte swizzle of
// hopper_tile.cuh, rows past S read as zeros) with full/empty mbarriers, and
// consumer warpgroups run every product on wgmma: the score products S = Q
// K^T and dP = dO V^T (and their transposes) as m64n64k16 from shared
// memory, the gradient products as m64nNk16 with the 64 x 64 P or dS
// operand from registers (the score accumulator's layout is the A register
// layout) and the walked tile read MN-major through the transpose bit.
//
//   dKV: a block owns 64 keys (K and V stay in shared memory) and walks the
//        64-query tiles of Q, dO and their lse and D (from the diagonal on,
//        when causal). Warpgroup 0 computes S^T = K Q^T, turns it into P^T,
//        hands P^T to warpgroup 1 through shared memory (f32, the sign
//        bit carrying the dropout keep bit) and accumulates dV += P_drop^T
//        dO; warpgroup 1 computes dP^T = V dO^T, forms dS^T = P^T o (M o
//        dP^T / (1-r) - D) and accumulates dK += dS^T Q. Each holds its
//        gradient's whole head row: W / 2 f32 a thread. Warp 0 issues the
//        loads (as K1's from 192): a producer warp would put three warps
//        on one of the SM's four register files and cap every thread at
//        168 registers.
//   dQ:  a block owns 64 queries (Q and dO stay in shared memory) and walks
//        the 64-key tiles of K, V and the key mask (up to the diagonal,
//        when causal); one warpgroup computes S and dP, forms dS and
//        accumulates dQ += dS K; a producer warp loads (160 threads: up to
//        255 registers a thread).
// Five products a tile, the math's.
//
// Over 256 (CHUNKED) the head dim is padded by the wrapper to a multiple of
// 256 or of 192 and cut into chunks of that width W. A block writes the
// gradients of one column chunk; S and dP cover the full head dim, so per
// walked tile the block walks every chunk's Q, K, V and dO columns through
// the ring, its own chunk last (so the last item's stage holds the columns
// of its gradient products), and every chunk's block recomputes S and dP.
//
// Budget: shared memory as deep a ring as the 227 KB allow, at most 3
// stages (Wide below): dKV at 192 K + V 48 KB, 3 stages of Q + dO 48 KB,
// P^T 16 KB: 210 KB; at 256 64 + 2 x 64 + 16 = 208 KB; dQ 192 and 192 KB.
// Registers: dKV's dV or dK row (96 or 128 f32) and a score tile (32 f32),
// dQ's row (96 or 128) with S and dP (64), under the 255 a thread of 256
// or 160 threads may have. ptxas -v must show no spills.

// The shape of a wgmma instance: W is the head dim, or with CHUNKED the
// column chunk of a head dim over 256; DKV picks the dKV kernel (else dQ).
template <int W, bool CHUNKED, bool DKV>
struct Wide {
  static constexpr int NCHUNK = W / CHUNK_COLS, SLAB = NCHUNK * TILE;   // BR rows x W
  static constexpr int RESIDENT = CHUNKED ? 0 : 2 * SLAB;   // the block's own rows
  static constexpr int STAGE_BYTES = (CHUNKED ? 4 : 2) * SLAB + 2 * BR * 4;
  static constexpr int P_BYTES = DKV ? 32 * 128 * 4 : 0;
  static constexpr int FREE = SMEM_LIMIT - 2048 - RESIDENT - P_BYTES;
  static constexpr int STAGES = FREE / STAGE_BYTES < 3 ? FREE / STAGE_BYTES : 3;
  static constexpr int WARPS = DKV ? 8 : 4;               // consumer warps
  // dKV: warp 0 loads (256 threads); dQ: a producer warp (160 threads)
  static constexpr int NTHREADS = WARPS * 32 + (DKV ? 0 : 32);
  static_assert(STAGES >= 1, "no ring stage fits");
};

template <int W, bool CHUNKED, bool DKV>
struct WideSmem {
  using C = Wide<W, CHUNKED, DKV>;
  static constexpr int OWN = CHUNKED ? C::STAGES : 1;
  alignas(1024) unsigned char own0[OWN][C::NCHUNK][TILE];          // K (dKV), Q (dQ)
  alignas(1024) unsigned char own1[OWN][C::NCHUNK][TILE];          // V, dO
  alignas(1024) unsigned char walk0[C::STAGES][C::NCHUNK][TILE];   // Q, K
  alignas(1024) unsigned char walk1[C::STAGES][C::NCHUNK][TILE];   // dO, V
  // dKV: the walked queries' lse * log2(e) and D; dQ: the walked keys' bias
  float rowa[C::STAGES][BR], rowb[C::STAGES][BR];
  float p[DKV ? 32 : 1][128];       // dKV: P^T, element i of thread t at [i][t]
  uint64_t own_full, full[C::STAGES], empty[C::STAGES];
};
template <int W, bool CHUNKED, bool DKV>
constexpr int wide_smem_bytes() { return sizeof(WideSmem<W, CHUNKED, DKV>) + 1024; }

template <int W, bool CHUNKED, bool DKV>
__device__ __forceinline__ void wide_init(WideSmem<W, CHUNKED, DKV>& s) {
  if (threadIdx.x == 0) {
    mbar_init(&s.own_full, 1);
#pragma unroll
    for (int i = 0; i < Wide<W, CHUNKED, DKV>::STAGES; ++i) {
      mbar_init(&s.full[i], 32);                            // the producer warp's lanes
      mbar_init(&s.empty[i], Wide<W, CHUNKED, DKV>::WARPS); // one lane a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// The block's own rows [r0, r0 + 64) of own0 and own1 (native: once, for
// every walked tile).
template <int W, bool CHUNKED, bool DKV>
__device__ __forceinline__ void wide_own(WideSmem<W, CHUNKED, DKV>& s, const CUtensorMap* own0,
                                         const CUtensorMap* own1, int r0, int h, int b) {
  mbar_arrive_expect_tx(&s.own_full, 2 * Wide<W, CHUNKED, DKV>::SLAB);
#pragma unroll
  for (int ch = 0; ch < Wide<W, CHUNKED, DKV>::NCHUNK; ++ch) {
    tma_load_4d(s.own0[0][ch], own0, &s.own_full, ch * CHUNK_COLS, r0, h, b);
    tma_load_4d(s.own1[0][ch], own1, &s.own_full, ch * CHUNK_COLS, r0, h, b);
  }
}

// Warp-wide: wait until the stage of ring item `item` is free, write the
// walked rows' values (rowa, rowb), and (lane 0) start its loads. Item
// item = i * nchunk + it is item `it` of walked tile t = t0 + i, rows
// [64 t, 64 t + 64) of walk0 and walk1: native their whole rows; chunked
// column chunk (cs + 1 + it) % nchunk of them and of the own rows, the
// block's chunk cs last.
template <int W, bool CHUNKED, bool DKV>
__device__ __forceinline__ void wide_issue(WideSmem<W, CHUNKED, DKV>& s,
                                           const CUtensorMap* own0, const CUtensorMap* own1,
                                           const CUtensorMap* walk0, const CUtensorMap* walk1,
                                           const BwdArgs& a, int b, int h, int r0, int t0,
                                           int item, int nchunk, int cs, int lane) {
  using C = Wide<W, CHUNKED, DKV>;
  const int t = t0 + item / nchunk, st = item % C::STAGES;
  const int col = ((cs + 1 + item % nchunk) % nchunk) * W;   // 0 when native
  const size_t bh = (size_t)b * a.H + h;
  float va[2], vb[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = t * BR + lane + 32 * e;
    if (DKV) {                             // the walked queries' lse * log2(e) and D
      const bool in = r < a.Sq;
      va[e] = in ? a.lse[bh * a.Sq + r] * LOG2E : 0.f;
      vb[e] = in ? a.dvec[bh * a.Sq + r] : 0.f;
    } else {                               // the walked keys' bias
      va[e] = r < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + r])
                  ? 0.f : -INFINITY;
      vb[e] = 0.f;
    }
  }
  mbar_wait(&s.empty[st], ((item / C::STAGES) & 1) ^ 1);   // the stage is free
  s.rowa[st][lane] = va[0];
  s.rowa[st][lane + 32] = va[1];
  s.rowb[st][lane] = vb[0];
  s.rowb[st][lane + 32] = vb[1];
  if (lane == 0) {
    mbar_arrive_expect_tx(&s.full[st], (CHUNKED ? 4 : 2) * C::SLAB);
#pragma unroll
    for (int ch = 0; ch < C::NCHUNK; ++ch) {
      const int x = col + ch * CHUNK_COLS;
      if constexpr (CHUNKED) {
        tma_load_4d(s.own0[st][ch], own0, &s.full[st], x, r0, h, b);
        tma_load_4d(s.own1[st][ch], own1, &s.full[st], x, r0, h, b);
      }
      tma_load_4d(s.walk0[st][ch], walk0, &s.full[st], x, t * BR, h, b);
      tma_load_4d(s.walk1[st][ch], walk1, &s.full[st], x, t * BR, h, b);
    }
  } else {
    mbar_arrive(&s.full[st]);
  }
}

// acc {=, +=} A B^T over the W columns of one item: A the 64 own rows (K-major),
// B the 64 walked rows (K-major); accumulate iff `more`.
template <int W>
__device__ __forceinline__ void wide_scores(float (&acc)[32], unsigned char (*a)[TILE],
                                            unsigned char (*b)[TILE], bool more) {
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks) {
    const int ch = ks / 2, off = (ks % 2) * 32;
    wgmma_m64n64k16_ss(acc, desc_b64(&a[ch][off], 16, 512), desc_b64(&b[ch][off], 16, 512),
                       more || ks > 0);
  }
}

// acc += X B: X the 64 x 64 tile of `x` (the score layout) rounded to bf16,
// B the 64 walked rows from column chunk `b` on, read MN-major.
template <int N>
__device__ __forceinline__ void wide_grad(float (&acc)[N], const float (&x)[32],
                                          unsigned char (*b)[TILE]) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk) {   // 16 walked rows a step
    const uint32_t pa[4] = {pack_bf16(x[8 * kk], x[8 * kk + 1]),
                            pack_bf16(x[8 * kk + 2], x[8 * kk + 3]),
                            pack_bf16(x[8 * kk + 4], x[8 * kk + 5]),
                            pack_bf16(x[8 * kk + 6], x[8 * kk + 7])};
    wgmma_rs(acc, pa, desc_b64(&b[0][kk * 16 * CHUNK_BYTES_ROW], TILE, 512));
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
}

template <int W, bool CHUNKED>
__global__ void __launch_bounds__(Wide<W, CHUNKED, true>::NTHREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map, const BwdArgs a) {
  using C = Wide<W, CHUNKED, true>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  auto& s = aligned_smem<WideSmem<W, CHUNKED, true>>(smem_raw);
  const int nchunk = CHUNKED ? gridDim.z : 1, c = CHUNKED ? blockIdx.z : 0;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = (a.Sq + BR - 1) / BR;
  // causal: query tiles before the diagonal see no key of this block
  const int qt0 = a.causal ? min(nq, k0 / BR) : 0;
  const int n_items = (nq - qt0) * nchunk;
  wide_init(s);
  // warp 0 loads: K and V, the first STAGES items, then each refill
  auto issue = [&](int item) {
    wide_issue(s, &k_map, &v_map, &q_map, &do_map, a, b, h, k0, qt0, item, nchunk, c, lane);
  };
  if (warp == 0) {
    if (!CHUNKED && lane == 0) wide_own(s, &k_map, &v_map, k0, h, b);
    for (int i = 0; i < min(n_items, STAGES); ++i) issue(i);
  }

  // ---- warpgroup 0: S^T, P^T, dV; warpgroup 1: dP^T, dS^T, dK ----
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + (warp % 4) * 16 + g, key1 = key0 + 8;   // this thread's key rows
  const bool kv0 = key0 < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key0]);
  const bool kv1 = key1 < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key1]);
  const uint32_t dhead = drop_head(b, h, a.ds);
  float acc[W / 2];                         // dV (warpgroup 0) or dK (1), chunk c
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;

  if (!CHUNKED) mbar_wait(&s.own_full, 0);
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BR;
    float sc[32];                           // S^T (wg 0) or dP^T (wg 1): 64 keys x 64 queries
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    int st = 0;
    for (int it = 0; it < nchunk; ++it) {   // one score item per chunk (native: one)
      const int item = (qt - qt0) * nchunk + it;
      st = item % STAGES;
      mbar_wait(&s.full[st], (item / STAGES) & 1);
      const int os = CHUNKED ? st : 0;
      fence_regs(sc);
      wgmma_fence();
      wide_scores<W>(sc, wg == 0 ? s.own0[os] : s.own1[os],     // K Q^T or V dO^T
                     wg == 0 ? s.walk0[st] : s.walk1[st], it > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      if (it + 1 < nchunk) {                // a score item's stage is done
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[st]);
        if (warp == 0 && item + STAGES < n_items) issue(item + STAGES);
      }
    }

    // element i: key row (i >> 1) & 1 (key0, key1), query column q0 + col
    if (wg == 0) {
      if (qt > qt0) bar_sync(2, 256);       // warpgroup 1 has read the last P^T
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i >> 2) * 8 + 2 * t + (i & 1), qi = q0 + col;
        const int key = (i >> 1) & 1 ? key1 : key0;
        const bool ok = ((i >> 1) & 1 ? kv1 : kv0) && qi < a.Sq && !(a.causal && key > qi);
        const float p = ok ? exp2f(sc[i] * a.scale_log2 - s.rowa[st][col]) : 0.f;
        const bool keep = !a.dropout ||
            hash_keep((dhead * (uint32_t)a.Sq + (uint32_t)qi) * (uint32_t)a.Sk + (uint32_t)key,
                      a.seed, a.threshold);
        s.p[i][tid] = keep ? p : -p;        // the sign bit carries the keep bit
        sc[i] = keep ? p * a.inv_keep : 0.f;
      }
      bar_arrive(1, 256);
    } else {
      bar_sync(1, 256);                     // P^T is written
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i >> 2) * 8 + 2 * t + (i & 1);
        const float x = s.p[i][tid];
        const bool keep = !(__float_as_uint(x) >> 31);
        sc[i] = fabsf(x) * ((keep ? sc[i] * a.inv_keep : 0.f) - s.rowb[st][col]);
      }
      if (qt + 1 < nq) bar_arrive(2, 256);
    }
    wide_grad(acc, sc, wg == 0 ? s.walk1[st] : s.walk0[st]);   // dV += P_drop^T dO, dK += dS^T Q
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);   // this warp is done with the stage
    const int item = (qt - qt0 + 1) * nchunk - 1;
    if (warp == 0 && item + STAGES < n_items) issue(item + STAGES);
  }

  const bool dv = wg == 0;
  const Strides& gs = dv ? a.dvs : a.dks;
  bf16* out = (dv ? a.dv : a.dk) + (size_t)b * gs.sb + (size_t)h * gs.sh + c * W;
  store_rows(acc, out, gs.ss, key0, a.Sk, t, dv ? 1.f : a.scale);
}

template <int W, bool CHUNKED>
__global__ void __launch_bounds__(Wide<W, CHUNKED, false>::NTHREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map, const BwdArgs a) {
  using C = Wide<W, CHUNKED, false>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  auto& s = aligned_smem<WideSmem<W, CHUNKED, false>>(smem_raw);
  const int nchunk = CHUNKED ? gridDim.z : 1, c = CHUNKED ? blockIdx.z : 0;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int n_tiles = (a.Sk + BR - 1) / BR;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BR - 1) / BR + 1);
  wide_init(s);
  if (warp == C::WARPS) {                   // ---- producer warp ----
    if (!CHUNKED && lane == 0) wide_own(s, &q_map, &do_map, q0, h, b);
    for (int item = 0; item < n_tiles * nchunk; ++item)
      wide_issue(s, &q_map, &do_map, &k_map, &v_map, a, b, h, q0, 0, item, nchunk, c, lane);
    return;
  }

  // ---- the consumer warpgroup: S, dP, dS, dQ ----
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float lse0 = row0 < a.Sq ? a.lse[(size_t)bh * a.Sq + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[(size_t)bh * a.Sq + row1] * LOG2E : 0.f;
  const float d0 = row0 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row1] : 0.f;
  const uint32_t drop0 = (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;
  float acc[W / 2];                         // dQ, chunk c
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;

  if (!CHUNKED) mbar_wait(&s.own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BR;
    float sc[32], dp[32];                   // S and dP: 64 queries x 64 keys
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    int st = 0;
    for (int it = 0; it < nchunk; ++it) {
      const int item = j * nchunk + it;
      st = item % STAGES;
      mbar_wait(&s.full[st], (item / STAGES) & 1);
      const int os = CHUNKED ? st : 0;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      wide_scores<W>(sc, s.own0[os], s.walk0[st], it > 0);     // Q K^T
      wide_scores<W>(dp, s.own1[os], s.walk1[st], it > 0);     // dO V^T
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(dp);
      if (it + 1 < nchunk) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[st]);
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {          // dS, in place of S
      const int col = (i >> 2) * 8 + 2 * t + (i & 1), key = k0 + col;
      const bool hi = (i >> 1) & 1;
      const float p = a.causal && key > (hi ? row1 : row0)
                          ? 0.f
                          : exp2f(sc[i] * a.scale_log2 + s.rowa[st][col] - (hi ? lse1 : lse0));
      const bool keep = !a.dropout ||
          hash_keep((hi ? drop1 : drop0) + (uint32_t)key, a.seed, a.threshold);
      sc[i] = p * ((keep ? dp[i] * a.inv_keep : 0.f) - (hi ? d1 : d0));
    }
    wide_grad(acc, sc, s.walk0[st]);      // dQ += dS K
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }
  store_rows(acc, a.dq + (size_t)b * a.dqs.sb + (size_t)h * a.dqs.sh + c * W, a.dqs.ss, row0,
             a.Sq, t, a.scale);
}

// Dh is the full head dim: W itself, or nchunk * W when CHUNKED.
template <int W, bool CHUNKED>
int launch_wgmma(const BwdArgs& a, int B, int Dh, cudaStream_t stream) {
  constexpr int dkv_bytes = wide_smem_bytes<W, CHUNKED, true>();
  constexpr int dq_bytes = wide_smem_bytes<W, CHUNKED, false>();
  static_assert(dkv_bytes <= SMEM_LIMIT && dq_bytes <= SMEM_LIMIT, "shared memory over the limit");
  CUtensorMap m[4];
  const int err = make_bwd_maps(a, B, Dh, m);
  if (err != 0) return err;
  static bool dkv_ready = false, dq_ready = false;
  cudaError_t e = allow_smem(flash_bwd_dkv_wgmma_kernel<W, CHUNKED>, dkv_bytes, dkv_ready);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_wgmma_kernel<W, CHUNKED>, dq_bytes, dq_ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_wgmma_kernel<W, CHUNKED>
      <<<dim3((a.Sk + BR - 1) / BR, B * a.H, Dh / W), Wide<W, CHUNKED, true>::NTHREADS,
         dkv_bytes, stream>>>(m[0], m[1], m[2], m[3], a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma_kernel<W, CHUNKED>
      <<<dim3((a.Sq + BR - 1) / BR, B * a.H, Dh / W),
         Wide<W, CHUNKED, false>::NTHREADS, dq_bytes, stream>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

// D = rowsum(dO o O) in f32, one (b, h, query) row a thread, 16-byte loads:
// the JAX package computes it in XLA before its backward kernels.
__global__ void __launch_bounds__(256) flash_bwd_dvec_kernel(const BwdArgs a, int B, int Dh) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B * a.H * a.Sq) return;
  const int i = r % a.Sq, bh = r / a.Sq, b = bh / a.H, h = bh % a.H;
  const bf16* o = a.o + (size_t)b * a.os.sb + (size_t)h * a.os.sh + (size_t)i * a.os.ss;
  const bf16* d = a.dout + (size_t)b * a.dos.sb + (size_t)h * a.dos.sh + (size_t)i * a.dos.ss;
  float acc = 0.f;
  for (int c = 0; c < Dh; c += 8) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(o + c));
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(d + c));
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fx = __bfloat1622float2(x2[j]), fy = __bfloat1622float2(y2[j]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
  a.dvec[r] = acc;
}

}  // namespace

// q, k, v, dout, out, dq, dk, dv: bf16 (B, H, S, Dh) with element strides
// (sb, sh, ss) and the last dimension contiguous, Dh 64, 96, 128, 192 or
// 256 (one instance each) or over 256 a multiple of 256 or of 192 (the
// chunked route) (rows of q, k, v, dout and out on 16-byte lines, their
// bases 16-byte aligned: the kernels read them by TMA and 16-byte loads);
// out is the forward's output; mask: (B, Sk) uint8 (nonzero = attend) with
// row stride mask_sb, or null; lse: the forward's natural-log row LSE,
// contiguous f32 (B, H, Sq); dvec: contiguous f32 (B, H, Sq) scratch that
// receives D = rowsum(dO o O). dropout != 0 regenerates the forward's hash
// keep mask from (seed, threshold) and scales by inv_keep = 1/(1-rate),
// keyed as if (b, h) were (b + drop_b0, h + drop_h0) of drop_hg global
// heads. Launches the D kernel, the dKV kernel, then the dQ kernel, on
// `stream`; returns the first CUDA error.
extern "C" int flash_attention_bwd_bf16(FLASH_BWD_PARAMS) {
  const BwdArgs a = FLASH_BWD_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H * Sq;
  flash_bwd_dvec_kernel<<<(rows + 255) / 256, 256, 0, s>>>(a, B, Dh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (Dh) {
    case 64: return launch_hopper<Shipped<64>::Dkv, Shipped<64>::Dq>(a, B, s);
    case 96: return launch_hopper<Shipped<96>::Dkv, Shipped<96>::Dq>(a, B, s);
    case 128: return launch_hopper<Shipped<128>::Dkv, Shipped<128>::Dq>(a, B, s);
    case 192: return launch_wgmma<192, false>(a, B, Dh, s);
    case 256: return launch_wgmma<256, false>(a, B, Dh, s);
    default:
      if (Dh > 256 && Dh % 256 == 0) return launch_wgmma<256, true>(a, B, Dh, s);
      if (Dh > 256 && Dh % 192 == 0) return launch_wgmma<192, true>(a, B, Dh, s);
      return static_cast<int>(cudaErrorInvalidValue);   // no route takes it
  }
}
