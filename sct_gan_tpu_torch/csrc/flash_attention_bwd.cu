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
// Head dims: one mma.sync instance each for D = 64, 96 and 128 (BwdShape
// below), and one TMA + wgmma instance each for 192 and 256 (the end of
// this file: flash_bwd_dkv_wgmma_kernel, flash_bwd_dq_wgmma_kernel), which
// also run head dims over 256 in chunks of 192 or 256 columns; the wrapper
// pads any other head dim to the next of these. In the mma.sync instances rows are padded to
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

// ---- head dims 192 and 256, and the chunked route over 256: TMA + wgmma ----
//
// The instances above keep a whole head row of their gradients in the
// registers of one warp's 16 rows; past 128 columns that does not fit, and
// mma.sync feeds every warp its own fragments. These kernels are built as
// K1 is (flash_attention_fwd.cu): the walked tiles stream through a ring of
// shared-memory stages by TMA (rank-4 maps from the caller's strides, the
// 64-byte swizzle of hopper_tile.cuh, rows past S read as zeros) with
// full/empty mbarriers, and consumer warpgroups run every product on
// wgmma: the score products S = Q K^T and dP = dO V^T (and their
// transposes) as m64n64k16 from shared memory, the gradient products as
// m64nNk16 with the 64 x 64 P or dS operand from registers (the score
// accumulator's layout is the A register layout) and the walked tile read
// MN-major through the transpose bit.
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
// Five products a tile, the math's; the mma.sync instances above run seven.
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
constexpr int BR = 64;                      // a block's own rows, and a walked tile's
constexpr int TILE = BR * CHUNK_BYTES_ROW;  // one 32-column swizzled box of BR rows
constexpr int SMEM_LIMIT = 232448;          // bytes of shared memory a block may use

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

template <typename T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {   // 1024-byte aligned
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

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

// Write a (64 x N) accumulator times `mul` to rows row0 / row0 + 8 (< n_rows) of out.
template <int N>
__device__ __forceinline__ void wide_store(const float (&acc)[N], bf16* out, int ss, int row0,
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
  wide_store(acc, out, gs.ss, key0, a.Sk, t, dv ? 1.f : a.scale);
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
  wide_store(acc, a.dq + (size_t)b * a.dqs.sb + (size_t)h * a.dqs.sh + c * W, a.dqs.ss, row0,
             a.Sq, t, a.scale);
}

// Dh is the full head dim: W itself, or nchunk * W when CHUNKED.
template <int W, bool CHUNKED>
int launch_wgmma(const BwdArgs& a, int B, int Dh, cudaStream_t stream) {
  constexpr int dkv_bytes = wide_smem_bytes<W, CHUNKED, true>();
  constexpr int dq_bytes = wide_smem_bytes<W, CHUNKED, false>();
  static_assert(dkv_bytes <= SMEM_LIMIT && dq_bytes <= SMEM_LIMIT, "shared memory over the limit");
  CUtensorMap qm, km, vm, dom;
  int err = make_head_map(&qm, a.q, B, a.H, a.Sq, Dh, a.qs.sb, a.qs.sh, a.qs.ss, BR);
  if (err == 0) err = make_head_map(&km, a.k, B, a.H, a.Sk, Dh, a.ks.sb, a.ks.sh, a.ks.ss, BR);
  if (err == 0) err = make_head_map(&vm, a.v, B, a.H, a.Sk, Dh, a.vs.sb, a.vs.sh, a.vs.ss, BR);
  if (err == 0)
    err = make_head_map(&dom, a.dout, B, a.H, a.Sq, Dh, a.dos.sb, a.dos.sh, a.dos.ss, BR);
  if (err != 0) return err;
  static bool dkv_ready = false, dq_ready = false;
  cudaError_t e = allow_smem(flash_bwd_dkv_wgmma_kernel<W, CHUNKED>, dkv_bytes, dkv_ready);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_wgmma_kernel<W, CHUNKED>, dq_bytes, dq_ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_wgmma_kernel<W, CHUNKED>
      <<<dim3((a.Sk + BR - 1) / BR, B * a.H, Dh / W), Wide<W, CHUNKED, true>::NTHREADS,
         dkv_bytes, stream>>>(qm, km, vm, dom, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma_kernel<W, CHUNKED>
      <<<dim3((a.Sq + BR - 1) / BR, B * a.H, Dh / W),
         Wide<W, CHUNKED, false>::NTHREADS, dq_bytes, stream>>>(qm, km, vm, dom, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: bf16 (B, H, S, Dh) with element strides
// (sb, sh, ss) and the last dimension contiguous, Dh 64, 96, 128, 192 or
// 256 (one instance each) or over 256 a multiple of 256 or of 192 (the
// chunked route) (rows of q, k, v, dout on 16-byte lines, their bases
// 16-byte aligned: 192 and up read them by TMA); mask: (B, Sk) uint8 (nonzero = attend) with row stride
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
    case 192: return launch_wgmma<192, false>(a, B, Dh, st);
    case 256: return launch_wgmma<256, false>(a, B, Dh, st);
    default:
      if (Dh > 256 && Dh % 256 == 0) return launch_wgmma<256, true>(a, B, Dh, st);
      if (Dh > 256 && Dh % 192 == 0) return launch_wgmma<192, true>(a, B, Dh, st);
      return static_cast<int>(cudaErrorInvalidValue);   // no route takes it
  }
}
