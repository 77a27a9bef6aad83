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
// Two kernels, no atomics, so the gradients are bit-for-bit deterministic:
//   dKV: one block of 8 warps per (b, h, 128-key tile), each warp 16 keys.
//        It walks the 64-query tiles (32 at D = 128) of Q, dO, lse and D
//        (from the diagonal on, when causal) and keeps dK and dV in
//        registers, working on S^T so that P^T and dS^T come out of one
//        product in the A layout of the next.
//   dQ:  one block of 8 warps per (b, h, 128-query tile), each warp 16
//        queries. It walks the 32-key tiles of K, V and the key mask (up to
//        the diagonal, when causal) and keeps dQ in registers.
// Each recomputes S and P: 7 products as run for the 5 of the math.
//
// Bound on an H100: the 5 products over the attended keys,
// 10*H*Sq*dh*sum_b(attended keys of row b) flops at 989 TFLOP/s (a masked
// key adds nothing to dQ and gets dK = dV = 0), against Q, O, dO, dQ, dK, dV
// and the attended keys' K and V rows at 3.35 TB/s: at (8, 8, 1024, 96),
// 0.065 ms of products with every key attended, 0.042 ms under
// chip_smoke.py's key mask (5301 of 8192 keys); compute-bound. Both kernels
// walk every tile, masked or not.
//
// The design. The first design gathered every operand read down a column
// (dO and Q for dV and dK, K for dQ) two bf16 scalars at a time, and loaded
// each tile it walked synchronously between two barriers. Here:
//   * the walked tiles stream through a 2-stage cp.async ring (16-byte
//     copies, rows past S zero-filled), so the next tile loads while this
//     one is used; the block's own tiles (K, V in dKV; Q, dO in dQ) load
//     once with the first stage;
//   * every fragment is read with ldmatrix.x4 from rows padded to 208
//     bytes (13 16-byte units: eight rows of one unit fall in eight bank
//     groups), and the column reads with ldmatrix.x4.trans;
//   * 8 warps a block (128 keys or queries) instead of 4, which halves how
//     often each walked tile is loaded;
//   * dQ walks 32-key tiles so that it fits 128 registers a thread and two
//     blocks (16 warps) an SM, which on an H100 beats one block of 64-key
//     tiles by far. dKV's dK and dV alone take 96 registers a thread, so it
//     stays at one block of 8 warps: at 4 warps in 3 blocks (168 registers)
//     ptxas spills, also with its products issued one at a time, and a
//     shape that spills is not shipped.
//     What holds dKV back is that each warp reads every fragment of the
//     walked tile through ldmatrix and its warps move through the products
//     and the elementwise dS in step; wgmma (operands read once a
//     warpgroup from shared memory) is its fix.
// The products stay mma.sync.m16n8k16 with f32 accumulation; wgmma is the
// next redesign.
//
// Budget at D = 96. dKV: shared memory K + V 52 KB, 2 stages of Q + dO +
// lse + D (26.5 KB each): 105 KB; registers: dK + dV 96 f32, S^T + dP^T 64
// f32 and the P^T / dS^T operands per thread, one block of 256 threads an
// SM (up to 255 registers). dQ: Q + dO 52 KB, 2 stages of K + V + mask (13
// KB each): 78 KB, two blocks an SM; dQ 48 f32, S + dP 32 f32, under 128
// registers. ptxas -v must show no spills in any instance.
//
// Head dims: one instance each for D = 64, 96 and 128 (BwdShape below;
// the wrapper pads any other D <= 128 to the next one). A head dim over
// 128, padded by the wrapper to a multiple of 128, runs the wide-head pair
// at the end of this file (flash_bwd_dkv_wide_kernel, flash_bwd_dq_wide_kernel). Rows are padded to
// D + 8 elements in shared memory (144, 208 or 272 bytes: an odd number of
// 16-byte units, so eight rows of one unit fall in eight bank groups). D =
// 64 keeps D = 96's block shapes. At D = 128, dK + dV alone take 128 f32 a
// thread: dKV walks 32-query tiles instead of 64 (S^T and dP^T 32 f32, the
// operands 16), and dQ (dQ 64 f32) gives up the second block an SM for up
// to 255 registers; both to stay clear of spills, at some speed.
//
// The mask and causal semantics are the forward's: a masked key, a key past
// Sk, a query past Sq and a causal key j > i all get P = 0 (the TPU kernel's
// S <= -1e29 guard), so a fully-masked row gets dQ = 0 whatever its lse.
// The dropout mask is the hash keep mask of the forward (hash_dropout.cuh),
// keyed by ((b*H + h)*Sq + i)*Sk + j over the true Sq and Sk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"
#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int DKV_WARPS = 8;          // dKV: 16 keys a warp
constexpr int DKV_THREADS = DKV_WARPS * 32;
constexpr int DKV_ROWS = 16 * DKV_WARPS;   // keys a dKV block
constexpr int DKV_MIN_BLOCKS = 1;     // blocks an SM (__launch_bounds__)
constexpr int DQ_WARPS = 8;           // dQ: 16 queries a warp
constexpr int DQ_THREADS = DQ_WARPS * 32;
constexpr int DQ_ROWS = 16 * DQ_WARPS;     // queries a dQ block
constexpr int BK = 32;                // key tile walked by dQ
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// The block shape of each head-dim instance: the query tile dKV walks, and
// dQ's blocks an SM (2 caps it at 128 registers a thread).
template <int D> struct BwdShape;
template <> struct BwdShape<64> { static constexpr int BQ = 64, DQ_MIN_BLOCKS = 2; };
template <> struct BwdShape<96> { static constexpr int BQ = 64, DQ_MIN_BLOCKS = 2; };
template <> struct BwdShape<128> { static constexpr int BQ = 32, DQ_MIN_BLOCKS = 1; };

struct Strides {   // element strides of a (B, H, S, D) tensor, last dim contiguous
  int sb, sh, ss;
};

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const uint8_t* mask;   // (B, Sk), nonzero = attend, or null
  const float *lse, *dvec;   // contiguous (B*H, Sq)
  bf16 *dq, *dk, *dv;
  int H, Sq, Sk;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int mask_sb, causal;
  float scale, scale_log2;
  int dropout;
  uint32_t seed, threshold;
  float inv_keep;
  DropShard ds;          // the dropout mask's place in the global (B, H) grid
};

template <int D>
struct DkvSmem {
  static constexpr int LD = D + 8, BQ = BwdShape<D>::BQ;
  bf16 k[DKV_ROWS * LD], v[DKV_ROWS * LD];
  bf16 q[STAGES][BQ * LD], dout[STAGES][BQ * LD];
  float lse[STAGES][BQ], d[STAGES][BQ];      // the walked rows' lse and D
};

template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;
  bf16 q[DQ_ROWS * LD], dout[DQ_ROWS * LD];
  bf16 k[STAGES][BK * LD], v[STAGES][BK * LD];
  uint8_t valid[STAGES][BK];
};

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, DKV_MIN_BLOCKS)
flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int LD = D + 8, BQ = BwdShape<D>::BQ;
  constexpr int KSTEPS = D / 16, NT_D = D / 8;   // k-steps and 8-wide n-tiles of D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<D>& s = *reinterpret_cast<DkvSmem<D>*>(smem_raw);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * DKV_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const bf16* qb = a.q + (size_t)b * a.qs.sb + (size_t)h * a.qs.sh;
  const bf16* dob = a.dout + (size_t)b * a.dos.sb + (size_t)h * a.dos.sh;
  const float* lse_b = a.lse + (size_t)bh * a.Sq;
  const float* d_b = a.dvec + (size_t)bh * a.Sq;

  const int nq = (a.Sq + BQ - 1) / BQ;
  // causal: query tiles before the diagonal see no key of this block
  const int qt0 = a.causal ? k0 / BQ : 0;
  auto issue = [&](int qt, int st) {        // one walked tile into stage st
    const int q0 = qt * BQ;
    cp_tile<D, BQ, DKV_THREADS>(s.q[st], qb, q0, a.Sq, a.qs.ss);
    cp_tile<D, BQ, DKV_THREADS>(s.dout[st], dob, q0, a.Sq, a.dos.ss);
    for (int c = threadIdx.x; c < BQ; c += DKV_THREADS) {
      const bool in = q0 + c < a.Sq;
      cp_async_4(&s.lse[st][c], in ? lse_b + q0 + c : lse_b, in);
      cp_async_4(&s.d[st][c], in ? d_b + q0 + c : d_b, in);
    }
  };
  cp_tile<D, DKV_ROWS, DKV_THREADS>(s.k, a.k + (size_t)b * a.ks.sb + (size_t)h * a.ks.sh,
                                    k0, a.Sk, a.ks.ss);
  cp_tile<D, DKV_ROWS, DKV_THREADS>(s.v, a.v + (size_t)b * a.vs.sb + (size_t)h * a.vs.sh,
                                    k0, a.Sk, a.vs.ss);
  if (qt0 < nq) issue(qt0, 0);
  cp_async_commit();

  const int key0 = k0 + wr + g, key1 = key0 + 8;   // this thread's key rows
  const bool kv0 = key0 < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key0]);
  const bool kv1 = key1 < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key1]);

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) % STAGES, q0 = qt * BQ;
    if (qt + 1 < nq) issue(qt + 1, (qt + 1 - qt0) % STAGES);   // overlaps this tile
    cp_async_commit();
    cp_async_wait<1>();                      // this tile (and K, V) landed
    __syncthreads();
    const bf16* sQ = s.q[st];
    const bf16* sdO = s.dout[st];

    float sc[BQ / 8][4], dp[BQ / 8][4];      // S^T and dP^T, 16 keys x BQ queries
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr<LD>(s.k, wr, kk * 16, lane));
      ldsm_x4(va, a_addr<LD>(s.v, wr, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t qf[4], of[4];
        ldsm_x4(qf, bn_addr<LD>(sQ, np * 16, kk * 16, lane));
        ldsm_x4(of, bn_addr<LD>(sdO, np * 16, kk * 16, lane));
        mma_16816(sc[2 * np], ka, qf[0], qf[1]);       // K Q^T
        mma_16816(sc[2 * np + 1], ka, qf[2], qf[3]);
        mma_16816(dp[2 * np], va, of[0], of[1]);       // V dO^T
        mma_16816(dp[2 * np + 1], va, of[2], of[3]);
      }
    }

    // P^T, its dropped form, and dS^T, packed as A operands (k = queries)
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      float pd[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int qi = q0 + col;
        const int key = e < 2 ? key0 : key1;
        const bool ok = (e < 2 ? kv0 : kv1) && qi < a.Sq && !(a.causal && key > qi);
        const float p = ok ? exp2f(sc[nt][e] * a.scale_log2 - s.lse[st][col] * LOG2E) : 0.f;
        const bool keep = !a.dropout ||
            hash_keep((drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)qi) * (uint32_t)a.Sk +
                          (uint32_t)key, a.seed, a.threshold);
        pd[e] = keep ? p * a.inv_keep : 0.f;
        ds[e] = p * ((keep ? dp[nt][e] * a.inv_keep : 0.f) - s.d[st][col]);
      }
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pa[kk][hi] = pack_bf16(pd[0], pd[1]);
      pa[kk][hi + 1] = pack_bf16(pd[2], pd[3]);
      da[kk][hi] = pack_bf16(ds[0], ds[1]);
      da[kk][hi + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P_drop^T dO, dK += dS^T Q: B operands read down query columns
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < NT_D / 2; ++dp2) {
        uint32_t ob[4], qf[4];
        ldsm_x4_trans(ob, bt_addr<LD>(sdO, kk * 16, dp2 * 16, lane));
        ldsm_x4_trans(qf, bt_addr<LD>(sQ, kk * 16, dp2 * 16, lane));
        mma_16816(dv_acc[2 * dp2], pa[kk], ob[0], ob[1]);
        mma_16816(dv_acc[2 * dp2 + 1], pa[kk], ob[2], ob[3]);
        mma_16816(dk_acc[2 * dp2], da[kk], qf[0], qf[1]);
        mma_16816(dk_acc[2 * dp2 + 1], da[kk], qf[2], qf[3]);
      }
    }
    __syncthreads();                         // the stage may be refilled
  }
  cp_async_wait<0>();

  bf16* dkb = a.dk + (size_t)b * a.dks.sb + (size_t)h * a.dks.sh;
  bf16* dvb = a.dv + (size_t)b * a.dvs.sb + (size_t)h * a.dvs.sh;
#pragma unroll
  for (int dt = 0; dt < NT_D; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (key0 < a.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key0 * a.dks.ss + col) =
          __floats2bfloat162_rn(dk_acc[dt][0] * a.scale, dk_acc[dt][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key0 * a.dvs.ss + col) =
          __floats2bfloat162_rn(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (key1 < a.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key1 * a.dks.ss + col) =
          __floats2bfloat162_rn(dk_acc[dt][2] * a.scale, dk_acc[dt][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key1 * a.dvs.ss + col) =
          __floats2bfloat162_rn(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, BwdShape<D>::DQ_MIN_BLOCKS)
flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16, NT_D = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<D>& s = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * DQ_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const bf16* kb = a.k + (size_t)b * a.ks.sb + (size_t)h * a.ks.sh;
  const bf16* vb = a.v + (size_t)b * a.vs.sb + (size_t)h * a.vs.sh;
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;

  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + DQ_ROWS - 1) / BK + 1);
  auto issue = [&](int j, int st) {         // one walked tile into stage st
    const int k0 = j * BK;
    cp_tile<D, BK, DQ_THREADS>(s.k[st], kb, k0, a.Sk, a.ks.ss);
    cp_tile<D, BK, DQ_THREADS>(s.v[st], vb, k0, a.Sk, a.vs.ss);
    for (int c = threadIdx.x; c < BK; c += DQ_THREADS) {
      const int key = k0 + c;
      s.valid[st][c] = key < a.Sk && (mrow == nullptr || mrow[key]);
    }
  };
  cp_tile<D, DQ_ROWS, DQ_THREADS>(s.q, a.q + (size_t)b * a.qs.sb + (size_t)h * a.qs.sh,
                                  q0, a.Sq, a.qs.ss);
  cp_tile<D, DQ_ROWS, DQ_THREADS>(s.dout,
                                  a.dout + (size_t)b * a.dos.sb + (size_t)h * a.dos.sh, q0,
                                  a.Sq, a.dos.ss);
  issue(0, 0);
  cp_async_commit();

  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float lse0 = row0 < a.Sq ? a.lse[(size_t)bh * a.Sq + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[(size_t)bh * a.Sq + row1] * LOG2E : 0.f;
  const float d0 = row0 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row1] : 0.f;
  const uint32_t drop0 = (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;

  float dq_acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES, k0 = j * BK;
    if (j + 1 < n_tiles) issue(j + 1, (j + 1) % STAGES);   // overlaps this tile
    cp_async_commit();
    cp_async_wait<1>();                      // this tile (and Q, dO) landed
    __syncthreads();
    const bf16* sK = s.k[st];
    const bf16* sV = s.v[st];

    float sc[BK / 8][4], dp[BK / 8][4];      // S and dP, 16 queries x 32 keys
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, a_addr<LD>(s.q, wr, kk * 16, lane));
      ldsm_x4(oa, a_addr<LD>(s.dout, wr, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, bn_addr<LD>(sK, np * 16, kk * 16, lane));
        ldsm_x4(vf, bn_addr<LD>(sV, np * 16, kk * 16, lane));
        mma_16816(sc[2 * np], qa, kf[0], kf[1]);       // Q K^T
        mma_16816(sc[2 * np + 1], qa, kf[2], kf[3]);
        mma_16816(dp[2 * np], oa, vf[0], vf[1]);       // dO V^T
        mma_16816(dp[2 * np + 1], oa, vf[2], vf[3]);
      }
    }

    uint32_t da[BK / 16][4];                 // dS as A operands (k = keys)
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int key = k0 + col;
        const int row = e < 2 ? row0 : row1;
        const bool ok = s.valid[st][col] && row < a.Sq && !(a.causal && key > row);
        const float p = ok ? exp2f(sc[nt][e] * a.scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        const bool keep = !a.dropout ||
            hash_keep((e < 2 ? drop0 : drop1) + (uint32_t)key, a.seed, a.threshold);
        ds[e] = p * ((keep ? dp[nt][e] * a.inv_keep : 0.f) - (e < 2 ? d0 : d1));
      }
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      da[kk][hi] = pack_bf16(ds[0], ds[1]);
      da[kk][hi + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K: B operands read down key columns of sK
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < NT_D / 2; ++dp2) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, bt_addr<LD>(sK, kk * 16, dp2 * 16, lane));
        mma_16816(dq_acc[2 * dp2], da[kk], kf[0], kf[1]);
        mma_16816(dq_acc[2 * dp2 + 1], da[kk], kf[2], kf[3]);
      }
    }
    __syncthreads();                         // the stage may be refilled
  }
  cp_async_wait<0>();

  bf16* dqb = a.dq + (size_t)b * a.dqs.sb + (size_t)h * a.dqs.sh;
#pragma unroll
  for (int dt = 0; dt < NT_D; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row0 * a.dqs.ss + col) =
          __floats2bfloat162_rn(dq_acc[dt][0] * a.scale, dq_acc[dt][1] * a.scale);
    if (row1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row1 * a.dqs.ss + col) =
          __floats2bfloat162_rn(dq_acc[dt][2] * a.scale, dq_acc[dt][3] * a.scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;        // above 48 KB needs an opt-in
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = err == cudaSuccess;
  return err;
}

template <int D>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  static bool dkv_ready = false, dq_ready = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, sizeof(DkvSmem<D>), dkv_ready);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<D>, sizeof(DqSmem<D>), dq_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<dim3((a.Sk + DKV_ROWS - 1) / DKV_ROWS, B * a.H), DKV_THREADS,
                            sizeof(DkvSmem<D>), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<dim3((a.Sq + DQ_ROWS - 1) / DQ_ROWS, B * a.H), DQ_THREADS,
                           sizeof(DqSmem<D>), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the wide-head route: D > 128, a multiple of 128 ----------------------
//
// Past D = 128 a thread cannot hold a whole head row of dK and dV (or dQ).
// The route cuts the head dim into 128-column chunks, one block per (b, h,
// tile, chunk c), each writing only its chunk of the gradients:
//
//   S = sum_cc Q[:, cc] K[:, cc]^T,   dP = sum_cc dO[:, cc] V[:, cc]^T
//   dV[:, c] = (M o P / (1-r))^T dO[:, c],   dK[:, c] = dS^T Q[:, c] * scale
//   dQ[:, c] = dS K[:, c] * scale
//
// with P and dS as above; D = rowsum(dO o O) covers the full head dim (it
// comes from torch). Every chunk's block recomputes S and dP over the full
// head dim, walking the chunks of the walked tile one 128-column item at a
// time through a 2-stage cp.async ring; its own chunk comes last, so the
// Q and dO (dKV) or K (dQ) columns of the final products are the last
// item's. Each block holds only 128-column slabs, so any multiple of 128
// runs with the same shared memory. 4 warps, 16 rows each: dKV 64 keys
// walking 32-query tiles (dK and dV 128 f32 a thread), dQ 64 queries walking
// 32-key tiles; rows padded to 136 elements, ldmatrix operands, mma.sync.
// The route costs one recomputation of S and dP per chunk: nchunk times
// their products. It is right and simple, not fast.
constexpr int WIDE_COLS = 128;              // a head-dim chunk
constexpr int WIDE_LD = WIDE_COLS + 8;      // shared row stride (bf16)
constexpr int WIDE_THREADS = 128;           // 4 warps
constexpr int WIDE_ROWS = 64;               // a block's own rows, 16 a warp
constexpr int WIDE_WALK = 32;               // rows of a walked tile

struct WideBwdStage {   // one chunk of each operand
  bf16 own0[WIDE_ROWS * WIDE_LD], own1[WIDE_ROWS * WIDE_LD];   // K, V (dKV); Q, dO (dQ)
  bf16 walk0[WIDE_WALK * WIDE_LD], walk1[WIDE_WALK * WIDE_LD]; // Q, dO (dKV); K, V (dQ)
};
constexpr int WIDE_SMEM = 2 * sizeof(WideBwdStage);

// Start copying chunk `cc` of the block's own rows [r0, r0 + 64) of x0, x1
// and of the walked rows [w0, w0 + 32) of y0, y1 into stage st.
__device__ __forceinline__ void wide_issue(WideBwdStage& st, int cc, const bf16* x0,
                                           const bf16* x1, int x0_ss, int x1_ss, int r0,
                                           int n_rows, const bf16* y0, const bf16* y1,
                                           int y0_ss, int y1_ss, int w0, int n_walk) {
  const int col = cc * WIDE_COLS;
  cp_tile<WIDE_COLS, WIDE_ROWS, WIDE_THREADS>(st.own0, x0 + col, r0, n_rows, x0_ss);
  cp_tile<WIDE_COLS, WIDE_ROWS, WIDE_THREADS>(st.own1, x1 + col, r0, n_rows, x1_ss);
  cp_tile<WIDE_COLS, WIDE_WALK, WIDE_THREADS>(st.walk0, y0 + col, w0, n_walk, y0_ss);
  cp_tile<WIDE_COLS, WIDE_WALK, WIDE_THREADS>(st.walk1, y1 + col, w0, n_walk, y1_ss);
}

// acc0 += A0 B0^T and acc1 += A1 B1^T over one 128-column chunk: A from the
// stage's own rows (this warp's 16), B from its walked rows (32).
__device__ __forceinline__ void wide_scores(const WideBwdStage& st, int wr, int lane,
                                            float (&acc0)[WIDE_WALK / 8][4],
                                            float (&acc1)[WIDE_WALK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < WIDE_COLS / 16; ++kk) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, a_addr<WIDE_LD>(st.own0, wr, kk * 16, lane));
    ldsm_x4(a1, a_addr<WIDE_LD>(st.own1, wr, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < WIDE_WALK / 16; ++np) {
      uint32_t b0[4], b1[4];
      ldsm_x4(b0, bn_addr<WIDE_LD>(st.walk0, np * 16, kk * 16, lane));
      ldsm_x4(b1, bn_addr<WIDE_LD>(st.walk1, np * 16, kk * 16, lane));
      mma_16816(acc0[2 * np], a0, b0[0], b0[1]);
      mma_16816(acc0[2 * np + 1], a0, b0[2], b0[3]);
      mma_16816(acc1[2 * np], a1, b1[0], b1[1]);
      mma_16816(acc1[2 * np + 1], a1, b1[2], b1[3]);
    }
  }
}

__global__ void __launch_bounds__(WIDE_THREADS, 2)
flash_bwd_dkv_wide_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideBwdStage* stage = reinterpret_cast<WideBwdStage*>(smem_raw);
  const int nchunk = gridDim.z, c = blockIdx.z;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * WIDE_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const bf16* qb = a.q + (size_t)b * a.qs.sb + (size_t)h * a.qs.sh;
  const bf16* dob = a.dout + (size_t)b * a.dos.sb + (size_t)h * a.dos.sh;
  const bf16* kb = a.k + (size_t)b * a.ks.sb + (size_t)h * a.ks.sh;
  const bf16* vb = a.v + (size_t)b * a.vs.sb + (size_t)h * a.vs.sh;
  const float* lse_b = a.lse + (size_t)bh * a.Sq;
  const float* d_b = a.dvec + (size_t)bh * a.Sq;
  const int nq = (a.Sq + WIDE_WALK - 1) / WIDE_WALK;
  // causal: query tiles before the diagonal see no key of this block
  const int qt0 = a.causal ? min(nq, k0 / WIDE_WALK) : 0;
  const int n_items = (nq - qt0) * nchunk;  // item i: query tile qt0 + i / nchunk
  auto issue = [&](int item) {              // its chunks end with this block's own
    wide_issue(stage[item & 1], (c + 1 + item % nchunk) % nchunk, kb, vb, a.ks.ss,
               a.vs.ss, k0, a.Sk, qb, dob, a.qs.ss, a.dos.ss,
               (qt0 + item / nchunk) * WIDE_WALK, a.Sq);
  };

  const int key0 = k0 + wr + g, key1 = key0 + 8;   // this thread's key rows
  const bool kv0 = key0 < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key0]);
  const bool kv1 = key1 < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key1]);
  float dk_acc[WIDE_COLS / 8][4], dv_acc[WIDE_COLS / 8][4];
#pragma unroll
  for (int i = 0; i < WIDE_COLS / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  float sc[WIDE_WALK / 8][4], dp[WIDE_WALK / 8][4];   // S^T and dP^T, 16 keys x 32 queries
#pragma unroll
  for (int nt = 0; nt < WIDE_WALK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;

  if (n_items > 0) issue(0);
  cp_async_commit();
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) issue(i + 1);      // overlaps this item
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const WideBwdStage& st = stage[i & 1];
    wide_scores(st, wr, lane, sc, dp);      // K Q^T and V dO^T
    if (i % nchunk == nchunk - 1) {         // the tile's last chunk is c
      const int q0 = (qt0 + i / nchunk) * WIDE_WALK;
      uint32_t pa[WIDE_WALK / 16][4], da[WIDE_WALK / 16][4];
#pragma unroll
      for (int nt = 0; nt < WIDE_WALK / 8; ++nt) {
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + nt * 8 + 2 * t + (e & 1);
          const int key = e < 2 ? key0 : key1;
          const bool ok = (e < 2 ? kv0 : kv1) && qi < a.Sq && !(a.causal && key > qi);
          const float p = ok ? exp2f(sc[nt][e] * a.scale_log2 - lse_b[qi] * LOG2E) : 0.f;
          const float dq = qi < a.Sq ? d_b[qi] : 0.f;
          const bool keep = !a.dropout ||
              hash_keep((drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)qi) * (uint32_t)a.Sk +
                            (uint32_t)key, a.seed, a.threshold);
          pd[e] = keep ? p * a.inv_keep : 0.f;
          ds[e] = p * ((keep ? dp[nt][e] * a.inv_keep : 0.f) - dq);
          sc[nt][e] = dp[nt][e] = 0.f;      // the next tile starts from 0
        }
        const int kk = nt >> 1, hi = (nt & 1) * 2;
        pa[kk][hi] = pack_bf16(pd[0], pd[1]);
        pa[kk][hi + 1] = pack_bf16(pd[2], pd[3]);
        da[kk][hi] = pack_bf16(ds[0], ds[1]);
        da[kk][hi + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dV += P_drop^T dO[:, c], dK += dS^T Q[:, c]: down the query columns
#pragma unroll
      for (int kk = 0; kk < WIDE_WALK / 16; ++kk) {
#pragma unroll
        for (int dp2 = 0; dp2 < WIDE_COLS / 16; ++dp2) {
          uint32_t ob[4], qf[4];
          ldsm_x4_trans(ob, bt_addr<WIDE_LD>(st.walk1, kk * 16, dp2 * 16, lane));
          ldsm_x4_trans(qf, bt_addr<WIDE_LD>(st.walk0, kk * 16, dp2 * 16, lane));
          mma_16816(dv_acc[2 * dp2], pa[kk], ob[0], ob[1]);
          mma_16816(dv_acc[2 * dp2 + 1], pa[kk], ob[2], ob[3]);
          mma_16816(dk_acc[2 * dp2], da[kk], qf[0], qf[1]);
          mma_16816(dk_acc[2 * dp2 + 1], da[kk], qf[2], qf[3]);
        }
      }
    }
    __syncthreads();                        // the stage may be refilled
  }
  cp_async_wait<0>();

  bf16* dkb = a.dk + (size_t)b * a.dks.sb + (size_t)h * a.dks.sh + c * WIDE_COLS;
  bf16* dvb = a.dv + (size_t)b * a.dvs.sb + (size_t)h * a.dvs.sh + c * WIDE_COLS;
#pragma unroll
  for (int dt = 0; dt < WIDE_COLS / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (key0 < a.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key0 * a.dks.ss + col) =
          __floats2bfloat162_rn(dk_acc[dt][0] * a.scale, dk_acc[dt][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key0 * a.dvs.ss + col) =
          __floats2bfloat162_rn(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (key1 < a.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key1 * a.dks.ss + col) =
          __floats2bfloat162_rn(dk_acc[dt][2] * a.scale, dk_acc[dt][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key1 * a.dvs.ss + col) =
          __floats2bfloat162_rn(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

__global__ void __launch_bounds__(WIDE_THREADS, 2)
flash_bwd_dq_wide_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideBwdStage* stage = reinterpret_cast<WideBwdStage*>(smem_raw);
  const int nchunk = gridDim.z, c = blockIdx.z;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * WIDE_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const bf16* qb = a.q + (size_t)b * a.qs.sb + (size_t)h * a.qs.sh;
  const bf16* dob = a.dout + (size_t)b * a.dos.sb + (size_t)h * a.dos.sh;
  const bf16* kb = a.k + (size_t)b * a.ks.sb + (size_t)h * a.ks.sh;
  const bf16* vb = a.v + (size_t)b * a.vs.sb + (size_t)h * a.vs.sh;
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  int n_tiles = (a.Sk + WIDE_WALK - 1) / WIDE_WALK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + WIDE_ROWS - 1) / WIDE_WALK + 1);
  const int n_items = n_tiles * nchunk;     // item i: key tile i / nchunk
  auto issue = [&](int item) {              // its chunks end with this block's own
    wide_issue(stage[item & 1], (c + 1 + item % nchunk) % nchunk, qb, dob, a.qs.ss,
               a.dos.ss, q0, a.Sq, kb, vb, a.ks.ss, a.vs.ss, (item / nchunk) * WIDE_WALK,
               a.Sk);
  };

  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float lse0 = row0 < a.Sq ? a.lse[(size_t)bh * a.Sq + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[(size_t)bh * a.Sq + row1] * LOG2E : 0.f;
  const float d0 = row0 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row1] : 0.f;
  const uint32_t drop0 = (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;
  float dq_acc[WIDE_COLS / 8][4];
#pragma unroll
  for (int i = 0; i < WIDE_COLS / 8; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;
  float sc[WIDE_WALK / 8][4], dp[WIDE_WALK / 8][4];   // S and dP, 16 queries x 32 keys
#pragma unroll
  for (int nt = 0; nt < WIDE_WALK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;

  issue(0);
  cp_async_commit();
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) issue(i + 1);      // overlaps this item
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const WideBwdStage& st = stage[i & 1];
    wide_scores(st, wr, lane, sc, dp);      // Q K^T and dO V^T
    if (i % nchunk == nchunk - 1) {         // the tile's last chunk is c
      const int k0 = (i / nchunk) * WIDE_WALK;
      uint32_t da[WIDE_WALK / 16][4];       // dS as A operands (k = keys)
#pragma unroll
      for (int nt = 0; nt < WIDE_WALK / 8; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          const bool ok = key < a.Sk && (mrow == nullptr || mrow[key]) && row < a.Sq &&
                          !(a.causal && key > row);
          const float p = ok ? exp2f(sc[nt][e] * a.scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
          const bool keep = !a.dropout ||
              hash_keep((e < 2 ? drop0 : drop1) + (uint32_t)key, a.seed, a.threshold);
          ds[e] = p * ((keep ? dp[nt][e] * a.inv_keep : 0.f) - (e < 2 ? d0 : d1));
          sc[nt][e] = dp[nt][e] = 0.f;      // the next tile starts from 0
        }
        const int kk = nt >> 1, hi = (nt & 1) * 2;
        da[kk][hi] = pack_bf16(ds[0], ds[1]);
        da[kk][hi + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += dS K[:, c]: down the key columns
#pragma unroll
      for (int kk = 0; kk < WIDE_WALK / 16; ++kk) {
#pragma unroll
        for (int dp2 = 0; dp2 < WIDE_COLS / 16; ++dp2) {
          uint32_t kf[4];
          ldsm_x4_trans(kf, bt_addr<WIDE_LD>(st.walk0, kk * 16, dp2 * 16, lane));
          mma_16816(dq_acc[2 * dp2], da[kk], kf[0], kf[1]);
          mma_16816(dq_acc[2 * dp2 + 1], da[kk], kf[2], kf[3]);
        }
      }
    }
    __syncthreads();                        // the stage may be refilled
  }
  cp_async_wait<0>();

  bf16* dqb = a.dq + (size_t)b * a.dqs.sb + (size_t)h * a.dqs.sh + c * WIDE_COLS;
#pragma unroll
  for (int dt = 0; dt < WIDE_COLS / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row0 * a.dqs.ss + col) =
          __floats2bfloat162_rn(dq_acc[dt][0] * a.scale, dq_acc[dt][1] * a.scale);
    if (row1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row1 * a.dqs.ss + col) =
          __floats2bfloat162_rn(dq_acc[dt][2] * a.scale, dq_acc[dt][3] * a.scale);
  }
}

int launch_wide(const BwdArgs& a, int B, int nchunk, cudaStream_t stream) {
  static bool dkv_ready = false, dq_ready = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_wide_kernel, WIDE_SMEM, dkv_ready);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_wide_kernel, WIDE_SMEM, dq_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_wide_kernel<<<dim3((a.Sk + WIDE_ROWS - 1) / WIDE_ROWS, B * a.H, nchunk),
                              WIDE_THREADS, WIDE_SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wide_kernel<<<dim3((a.Sq + WIDE_ROWS - 1) / WIDE_ROWS, B * a.H, nchunk),
                             WIDE_THREADS, WIDE_SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: bf16 (B, H, S, Dh) with element strides
// (sb, sh, ss) and the last dimension contiguous, Dh 64, 96 or 128 (one
// instance each) or a multiple of 128 above (the wide-head route) (rows of
// q, k, v, dout on
// 16-byte lines); mask: (B, Sk) uint8 (nonzero = attend) with row stride
// mask_sb, or null; lse (the forward's natural-log row LSE) and dvec
// (D = rowsum(dO o O)): contiguous f32 (B, H, Sq). dropout != 0 regenerates
// the forward's hash keep mask from (seed, threshold) and scales by
// inv_keep = 1/(1-rate), keyed as if (b, h) were (b + drop_b0, h + drop_h0) of
// drop_hg global heads. Launches the dKV kernel, then the dQ kernel, on
// `stream`; returns the first CUDA error.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* lse, const void* dvec, void* dq, void* dk,
    void* dv, int B, int H, int Sq, int Sk, int Dh,
    int q_sb, int q_sh, int q_ss, int k_sb, int k_sh, int k_ss,
    int v_sb, int v_sh, int v_ss, int do_sb, int do_sh, int do_ss,
    int dq_sb, int dq_sh, int dq_ss, int dk_sb, int dk_sh, int dk_ss,
    int dv_sb, int dv_sh, int dv_ss, int mask_sb, int causal, float scale,
    int dropout, uint32_t seed, uint32_t threshold, float inv_keep,
    int drop_b0, int drop_h0, int drop_hg, void* stream) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.mask = static_cast<const uint8_t*>(mask);
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<const float*>(dvec);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.qs = {q_sb, q_sh, q_ss};
  a.ks = {k_sb, k_sh, k_ss};
  a.vs = {v_sb, v_sh, v_ss};
  a.dos = {do_sb, do_sh, do_ss};
  a.dqs = {dq_sb, dq_sh, dq_ss};
  a.dks = {dk_sb, dk_sh, dk_ss};
  a.dvs = {dv_sb, dv_sh, dv_ss};
  a.mask_sb = mask_sb;
  a.causal = causal;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  a.dropout = dropout;
  a.seed = seed;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  a.ds = {(uint32_t)drop_b0, (uint32_t)drop_h0, (uint32_t)drop_hg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return launch<64>(a, B, st);
    case 96: return launch<96>(a, B, st);
    case 128: return launch<128>(a, B, st);
    default:
      if (Dh > 128 && Dh % WIDE_COLS == 0)   // the wide-head route
        return launch_wide(a, B, Dh / WIDE_COLS, st);
      return static_cast<int>(cudaErrorInvalidValue);   // no instance
  }
}
