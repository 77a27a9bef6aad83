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
// Two kernels, no atomics, so the gradients are deterministic:
//   dKV: one block of 4 warps per (b, h, 64-key tile), each warp 16 keys.
//        It walks the query tiles (from the diagonal on, when causal) and
//        keeps dK and dV in registers, working on S^T so that P^T and dS^T
//        come out of one product in the A layout of the next.
//   dQ:  one block per (b, h, 64-query tile), each warp 16 queries. It walks
//        the key tiles (up to the diagonal, when causal) and keeps dQ in
//        registers.
// Together they compute what the TPU's fused kernel computes at nk == 1 and
// what its dKV + dQ pair computes at nk > 1; they recompute S and P twice
// (once per kernel), which a later performance change may share.
//
// What bounds it on an H100: 5 matrix products of 2*S*S*dh flops each per
// (b, h) (S^T, dP^T, dV, dK in one kernel; S, dP, dQ in the other: 7 as run)
// against ~10*S*dh bf16 bytes, so it is compute-bound. The simple design
// uses mma.sync.m16n8k16 with f32 accumulation; the operands that must be
// read down a column of a row-major tile (dO and Q for dV and dK, K for dQ)
// are gathered two bf16 at a time from shared memory rather than with
// ldmatrix.trans. Loads are synchronous 16-byte copies; TMA, wgmma and warp
// specialisation are later work.
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
#include "mma_tile.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NWARPS = 4;     // 16 rows each
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;        // bf16 row padding: spreads fragment reads over banks
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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
};

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BK + 2 * BQ) * (D + PAD) * (int)sizeof(bf16) + 2 * BQ * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16;   // k-steps over the head dim
  constexpr int NT_D = D / 8;      // 8-wide n-tiles of dK, dV
  constexpr int NT_Q = BQ / 8;     // 8-wide n-tiles of S^T (queries)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sdO = sQ + BQ * LD;
  float* sLse = reinterpret_cast<float*>(sdO + BQ * LD);   // log2 domain
  float* sD = sLse + BQ;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const bf16* qb = a.q + (size_t)b * a.qs.sb + (size_t)h * a.qs.sh;
  const bf16* kb = a.k + (size_t)b * a.ks.sb + (size_t)h * a.ks.sh;
  const bf16* vb = a.v + (size_t)b * a.vs.sb + (size_t)h * a.vs.sh;
  const bf16* dob = a.dout + (size_t)b * a.dos.sb + (size_t)h * a.dos.sh;
  const float* lse_b = a.lse + (size_t)bh * a.Sq;
  const float* d_b = a.dvec + (size_t)bh * a.Sq;

  load_tile<D, LD, NTHREADS>(sK, kb, k0, a.Sk, a.ks.ss);
  load_tile<D, LD, NTHREADS>(sV, vb, k0, a.Sk, a.vs.ss);

  const int key0 = k0 + wr + g, key1 = key0 + 8;   // this thread's key rows
  const bool kv0 = key0 < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key0]);
  const bool kv1 = key1 < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key1]);

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int nq = (a.Sq + BQ - 1) / BQ;
  // causal: query tiles before the diagonal see no key of this tile
  for (int qt = a.causal ? k0 / BQ : 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();                         // previous tile fully consumed
    load_tile<D, LD, NTHREADS>(sQ, qb, q0, a.Sq, a.qs.ss);
    load_tile<D, LD, NTHREADS>(sdO, dob, q0, a.Sq, a.dos.ss);
    for (int c = threadIdx.x; c < BQ; c += NTHREADS) {
      const bool in = q0 + c < a.Sq;
      sLse[c] = in ? lse_b[q0 + c] * LOG2E : 0.f;
      sD[c] = in ? d_b[q0 + c] : 0.f;
    }
    __syncthreads();

    float s[NT_Q][4], dp[NT_Q][4];           // S^T and dP^T, 16 keys x 64 queries
#pragma unroll
    for (int nt = 0; nt < NT_Q; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const bf16* pk = sK + (wr + g) * LD + kk * 16 + 2 * t;
      const bf16* pv = sV + (wr + g) * LD + kk * 16 + 2 * t;
      const uint32_t ka[4] = {ld32(pk), ld32(pk + 8 * LD), ld32(pk + 8), ld32(pk + 8 * LD + 8)};
      const uint32_t va[4] = {ld32(pv), ld32(pv + 8 * LD), ld32(pv + 8), ld32(pv + 8 * LD + 8)};
#pragma unroll
      for (int nt = 0; nt < NT_Q; ++nt) {
        const bf16* pq = sQ + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* pd = sdO + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[nt], ka, ld32(pq), ld32(pq + 8));    // K Q^T
        mma_16816(dp[nt], va, ld32(pd), ld32(pd + 8));   // V dO^T
      }
    }

    // P^T, its dropped form, and dS^T, packed as A operands (k = queries)
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT_Q; ++nt) {
      float pd[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int qi = q0 + col;
        const int key = e < 2 ? key0 : key1;
        const bool ok = (e < 2 ? kv0 : kv1) && qi < a.Sq && !(a.causal && key > qi);
        const float p = ok ? exp2f(s[nt][e] * a.scale_log2 - sLse[col]) : 0.f;
        const bool keep = !a.dropout ||
            hash_keep(((uint32_t)bh * (uint32_t)a.Sq + (uint32_t)qi) * (uint32_t)a.Sk +
                          (uint32_t)key, a.seed, a.threshold);
        pd[e] = keep ? p * a.inv_keep : 0.f;
        ds[e] = p * ((keep ? dp[nt][e] * a.inv_keep : 0.f) - sD[col]);
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
      const int r = kk * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < NT_D; ++dt) {
        const int c = dt * 8 + g;
        const bf16* pd = sdO + r * LD + c;
        const bf16* pq = sQ + r * LD + c;
        mma_16816(dv_acc[dt], pa[kk], ld_pair(pd, pd + LD), ld_pair(pd + 8 * LD, pd + 9 * LD));
        mma_16816(dk_acc[dt], da[kk], ld_pair(pq, pq + LD), ld_pair(pq + 8 * LD, pq + 9 * LD));
      }
    }
  }

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
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_D = D / 8;
  constexpr int NT_K = BK / 8;
  __shared__ __align__(16) bf16 sK[BK * LD];
  __shared__ __align__(16) bf16 sV[BK * LD];
  __shared__ bool sValid[BK];

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const bf16* qb = a.q + (size_t)b * a.qs.sb + (size_t)h * a.qs.sh;
  const bf16* kb = a.k + (size_t)b * a.ks.sb + (size_t)h * a.ks.sh;
  const bf16* vb = a.v + (size_t)b * a.vs.sb + (size_t)h * a.vs.sh;
  const bf16* dob = a.dout + (size_t)b * a.dos.sb + (size_t)h * a.dos.sh;

  // this warp's 16 rows of Q and dO as A operands, staged through sK / sV
  load_tile<D, LD, NTHREADS>(sK, qb, q0, a.Sq, a.qs.ss);
  load_tile<D, LD, NTHREADS>(sV, dob, q0, a.Sq, a.dos.ss);
  __syncthreads();
  uint32_t qf[KSTEPS][4], of[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const bf16* pq = sK + (wr + g) * LD + kk * 16 + 2 * t;
    const bf16* po = sV + (wr + g) * LD + kk * 16 + 2 * t;
    qf[kk][0] = ld32(pq); qf[kk][1] = ld32(pq + 8 * LD);
    qf[kk][2] = ld32(pq + 8); qf[kk][3] = ld32(pq + 8 * LD + 8);
    of[kk][0] = ld32(po); of[kk][1] = ld32(po + 8 * LD);
    of[kk][2] = ld32(po + 8); of[kk][3] = ld32(po + 8 * LD + 8);
  }

  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float lse0 = row0 < a.Sq ? a.lse[(size_t)bh * a.Sq + row0] * LOG2E : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[(size_t)bh * a.Sq + row1] * LOG2E : 0.f;
  const float d0 = row0 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row1] : 0.f;
  const uint32_t drop0 = ((uint32_t)bh * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;

  float dq_acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();                         // previous tile (or staging) consumed
    load_tile<D, LD, NTHREADS>(sK, kb, k0, a.Sk, a.ks.ss);
    load_tile<D, LD, NTHREADS>(sV, vb, k0, a.Sk, a.vs.ss);
    for (int c = threadIdx.x; c < BK; c += NTHREADS) {
      const int key = k0 + c;
      sValid[c] = key < a.Sk && (a.mask == nullptr || a.mask[(size_t)b * a.mask_sb + key]);
    }
    __syncthreads();

    float s[NT_K][4], dp[NT_K][4];           // S and dP, 16 queries x 64 keys
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const bf16* pk = sK + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* pv = sV + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[nt], qf[kk], ld32(pk), ld32(pk + 8));    // Q K^T
        mma_16816(dp[nt], of[kk], ld32(pv), ld32(pv + 8));   // dO V^T
      }
    }

    uint32_t da[BK / 16][4];                 // dS as A operands (k = keys)
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int key = k0 + col;
        const int row = e < 2 ? row0 : row1;
        const bool ok = sValid[col] && row < a.Sq && !(a.causal && key > row);
        const float p = ok ? exp2f(s[nt][e] * a.scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
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
      const int r = kk * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < NT_D; ++dt) {
        const bf16* pk = sK + r * LD + dt * 8 + g;
        mma_16816(dq_acc[dt], da[kk], ld_pair(pk, pk + LD), ld_pair(pk + 8 * LD, pk + 9 * LD));
      }
    }
  }

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

template <int D>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  static bool configured = false;            // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  flash_bwd_dkv_kernel<D><<<dim3((a.Sk + BK - 1) / BK, B * a.H), NTHREADS, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<dim3((a.Sq + BQ - 1) / BQ, B * a.H), NTHREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: bf16 (B, H, S, D) with element strides
// (sb, sh, ss) and the last dimension contiguous; mask: (B, Sk) uint8
// (nonzero = attend) with row stride mask_sb, or null; lse (the forward's
// natural-log row LSE) and dvec (D = rowsum(dO o O)): contiguous f32
// (B, H, Sq). dropout != 0 regenerates the forward's hash keep mask from
// (seed, threshold) and scales by inv_keep = 1/(1-rate). Launches the dKV
// kernel, then the dQ kernel, on `stream`; returns the first CUDA error.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* lse, const void* dvec, void* dq, void* dk,
    void* dv, int B, int H, int Sq, int Sk, int D,
    int q_sb, int q_sh, int q_ss, int k_sb, int k_sh, int k_ss,
    int v_sb, int v_sh, int v_ss, int do_sb, int do_sh, int do_ss,
    int dq_sb, int dq_sh, int dq_ss, int dk_sb, int dk_sh, int dk_ss,
    int dv_sb, int dv_sh, int dv_ss, int mask_sb, int causal, float scale,
    int dropout, uint32_t seed, uint32_t threshold, float inv_keep,
    void* stream) {
  if (D != 96) return static_cast<int>(cudaErrorInvalidValue);   // dh of the model
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
  return launch<96>(a, B, static_cast<cudaStream_t>(stream));
}
