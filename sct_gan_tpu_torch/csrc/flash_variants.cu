// Single-pass softmax variants of the flash forward for Hopper (sm_90a), to
// price the softmax's parts on the card. bf16 in and out.
//
// Replaces the TPU kernel of tools/time_flash_variants.py (its pallas_call at
// :75). That kernel holds a whole (512, 1024) score block in VMEM (nk == 1):
// the row max over all keys comes before any exponent, nothing is rescaled,
// and Q K^T and P V are each computed once. The modes, with s = 0.1 Q K^T
// (times log2(e) where exp2 is used):
//
//   nk1     p = exp(s - m), l = rowsum p, O = (bf16(p) V) / l
//   exp2    nk1 with exp2
//   mxsum   exp2, with l from the tensor core: P times an 8-column block of
//           ones beside P V, whose every column is rowsum(bf16(p))
//   bf16p   p = exp2(bf16(s - m)), two at a time (h2exp2 on bf16 pairs)
//   masked  nk1 and then p = where(s > -1e29, p, 0): the padded path's select
//   mmonly  O = bf16(s) V: the two products alone
//
// q, k and v may be one tensor (the tool calls f(x, x, x, ones)).
//
// What bounds it on an H100: 25.8 GFLOP of products at (8, 8, 1024, 96)
// (0.026 ms at the bf16 peak) against 25 MB of input and output:
// operations.
//
// Design: the keys of a query tile are split over a thread block cluster,
// and each block keeps its slice's scores in registers. On a TPU one core
// holds a (512, 1024) f32 score block in VMEM; a Hopper SM cannot (a
// 64 x 1024 block is 256 KB), but C = ceil(S / SL) SMs of a cluster can,
// each 64 x SL of it in the accumulators of a warpgroup:
//   * block c of the cluster takes the query tile's 64 rows and keys
//     [c SL, c SL + SL). One thread loads the block's Q, K and V by TMA at
//     the start, one box a 32-column chunk; rows past S read as zeros;
//   * S = Q K^T by wgmma (m64n64k16, both operands in shared memory) stays
//     in the accumulators: SL / 2 f32 a thread;
//   * each block writes its slice's row max into every block of the
//     cluster (distributed shared memory); after one cluster barrier each
//     reads the C maxima at home, so m is the max over all S keys before
//     any exponent;
//   * p = exp(s - m) in registers, packed to bf16 A fragments, and
//     O_c = P V_c by wgmma with P from registers and the slice of V read
//     MN-major through the transpose bit (hopper_tile.cuh): V is never
//     transposed; mxsum adds one m64n8k16 product of P with a block of
//     ones for l;
//   * the partial O and l of a row go to the block that writes the row:
//     staged in the block's V tile, then one bulk copy (cp.async.bulk
//     between shared memories) to each block of the cluster, into its K
//     tile, completing on its mbarrier. Block c sums rows [c BQ / C, (c +
//     1) BQ / C) over the slices, divides by l and writes them. Nothing is
//     rescaled: every slice used the global m. A cluster barrier, arrived
//     at once a block's rows are in and waited for at the end, keeps every
//     block's shared memory until the copies out of it are read.
// A cluster is ceil(S / 256) blocks, at most 6 (S up to 1536); S must be
// a multiple of 64.
//
// Budget: one warpgroup of BQ = 64 query rows a block and SL = 256-key
// slices (C = 4 at S = 1024). A thread holds S (128 f32), P packed (64) and
// O (D / 2) under the 255 registers that 128 threads allow (ptxas -v must
// show no spill); 113 KB of shared memory at D = 96, so two blocks share
// an SM and one block's loads and barriers run under the other's
// products; 145 KB at D = 128, one block an SM. On an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md §6 PR 18) every other shape tried was slower:
// 128-key slices (clusters of 8 to 12, three blocks an SM), two
// warpgroups a block (on 128 rows, or on one 512-key slice: clusters of
// 2, one block an SM), blocks that keep their K and V slices and walk the
// query tiles (a cluster barrier a tile); K and V multicast to two query
// tiles and P V issued a part at a time changed nothing.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int SMEM_LIMIT = 232448;
constexpr int KT = 64;                 // keys a product tile (one m64n64k16 column block)
constexpr int BQ = 64;                 // query rows a block: one warpgroup
constexpr int SL = 256;                // keys a block: its slice
constexpr int NTHREADS = 128;
constexpr int MAX_SEQ = 1536;          // keys the wrapper takes
constexpr int MAXC = (MAX_SEQ + SL - 1) / SL;   // the most blocks a cluster
static_assert(MAXC <= 8, "a portable cluster holds every slice");
constexpr float LOG2E = 1.4426950408889634f;

enum Mode { NK1 = 0, EXP2 = 1, MXSUM = 2, BF16P = 3, MASKED = 4, MMONLY = 5 };

// A head dim's instance.
template <int D_>
struct Cfg {
  static constexpr int D = D_, NT = SL / KT;
  static constexpr int NCHUNK = D / CHUNK_COLS;         // 32-column boxes a row
  static constexpr int Q_CHUNK = BQ * CHUNK_BYTES_ROW, KV_CHUNK = SL * CHUNK_BYTES_ROW;
  static constexpr int LDO = D + 4;                     // f32 row stride of O's partials
  // a block's partial rows (O, and l in column D) are staged in its V tile
  // and copied to the blocks that write them, into their K tiles, which no
  // block reads once every block has its scores: at most BQ + MAXC - 1
  // rows there
  static_assert(BQ * LDO * 4 <= NCHUNK * KV_CHUNK, "the partials fit the V tile");
  static_assert((BQ + MAXC) * LDO * 4 <= NCHUNK * KV_CHUNK, "the partials fit the K tile");
};

template <class C>
struct Smem {
  alignas(1024) unsigned char q[C::NCHUNK][C::Q_CHUNK];
  alignas(1024) unsigned char k[C::NCHUNK][C::KV_CHUNK];   // then the partials pushed here
  alignas(1024) unsigned char v[C::NCHUNK][C::KV_CHUNK];
  alignas(1024) uint32_t ones[256];     // mxsum: a 16 x 8 block of bf16 ones, any layout
  float smax[MAXC][BQ];                 // slice r's row max, pushed by block r
  uint64_t q_full, k_full, v_full, recv_full;
};

template <class T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Grid (C, query tiles, B*H), clusters of (C, 1, 1): block c = the key slice.
template <class C, int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_variants_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o, int S, float scale) {
  constexpr int D = C::D, NT = C::NT;
  constexpr bool USE_EXP2 = MODE == EXP2 || MODE == MXSUM || MODE == BF16P;
  extern __shared__ unsigned char smem_raw[];
  Smem<C>& s = aligned_smem<Smem<C>>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.x, nc = gridDim.x;       // key slice, slices
  const int q0 = blockIdx.y * BQ, bh = blockIdx.z;
  const int key0 = c * SL;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid / 32, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;      // this thread's rows of the tile
  const int per = (BQ + nc - 1) / nc;             // block r writes rows [r per, r per + per)
  const int rows = min(per, BQ - c * per);        // this block's

  if (tid == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.k_full, 1);
    mbar_init(&s.v_full, 1);
    mbar_init(&s.recv_full, 1);
    fence_barrier_init();
    // every slice's partials of this block's rows land on recv_full
    mbar_arrive_expect_tx(&s.recv_full, nc * rows * C::LDO * 4);
    // Q, then the slice's K and V, one box a 32-column chunk; rows past S
    // read as zeros
    mbar_arrive_expect_tx(&s.q_full, C::NCHUNK * C::Q_CHUNK);
#pragma unroll
    for (int ch = 0; ch < C::NCHUNK; ++ch)
      tma_load_4d(s.q[ch], &q_map, &s.q_full, ch * CHUNK_COLS, q0, 0, bh);
    mbar_arrive_expect_tx(&s.k_full, C::NCHUNK * C::KV_CHUNK);
#pragma unroll
    for (int ch = 0; ch < C::NCHUNK; ++ch)
      tma_load_4d(s.k[ch], &k_map, &s.k_full, ch * CHUNK_COLS, key0, 0, bh);
    mbar_arrive_expect_tx(&s.v_full, C::NCHUNK * C::KV_CHUNK);
#pragma unroll
    for (int ch = 0; ch < C::NCHUNK; ++ch)
      tma_load_4d(s.v[ch], &v_map, &s.v_full, ch * CHUNK_COLS, key0, 0, bh);
  }
  if (MODE == MXSUM) {
    for (int i = tid; i < 256; i += NTHREADS) s.ones[i] = 0x3F803F80u;   // two bf16 1.0
    fence_proxy_async();
  }
  __syncthreads();                          // the barriers are initialised

  // ---- S = Q K^T over the slice, in the accumulators ----
  float sc[NT][32];
  mbar_wait(&s.q_full, 0);
  mbar_wait(&s.k_full, 0);
#pragma unroll
  for (int n = 0; n < NT; ++n) fence_regs(sc[n]);
  wgmma_fence();
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int ch = ks / 2, off = (ks % 2) * 32;
      const uint64_t da = desc_b64(&s.q[ch][off], 16, 512);
      const uint64_t db = desc_b64(&s.k[ch][n * KT * CHUNK_BYTES_ROW + off], 16, 512);
      wgmma_m64n64k16_ss(sc[n], da, db, ks > 0);
    }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int n = 0; n < NT; ++n) fence_regs(sc[n]);

  // element x = 4 j + e of sc[n] is row r0 + 8 (e / 2), key key0 + 64 n + 8 j
  // + 2 t + (e % 2); keys past S (a last slice that S does not fill) get -inf
  // (mmonly: their K and V rows are zeros, so they add nothing as they are)
  const float sscale = USE_EXP2 ? scale * LOG2E : scale;
  const bool ragged = MODE != MMONLY && key0 + SL > S;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      float v = sc[n][x] * sscale;
      if (ragged && key0 + n * KT + 8 * (x / 4) + 2 * t + (x & 1) >= S) v = -INFINITY;
      sc[n][x] = v;
    }

  // ---- the row max over all S keys: each block pushes its slice's max to
  // every block of the cluster, and after a cluster barrier reads them at
  // home; the barrier also frees every block's K tile ----
  float m[2] = {0.f, 0.f};
  if (MODE != MMONLY) {
    float mx4[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};   // two chains a row
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int x = 0; x < 32; ++x)
        mx4[(x >> 1) & 1][x & 1] = fmaxf(mx4[(x >> 1) & 1][x & 1], sc[n][x]);
    float mx[2] = {fmaxf(mx4[0][0], mx4[0][1]), fmaxf(mx4[1][0], mx4[1][1])};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if (t == 0)
      for (int r = 0; r < nc; ++r) {
        float* peer = cluster.map_shared_rank(&s.smax[c][0], r);
        peer[r0] = mx[0];
        peer[r1] = mx[1];
      }
  }
  // the barrier's second half: every slice's max is here, and every block
  // is done with its K tile (mmonly, which needs no max, waits only before
  // it sends its partials, and packs P and runs P V under the barrier)
  cluster_arrive();
  if (MODE != MMONLY) {
    cluster_wait();
    m[0] = m[1] = -INFINITY;
    for (int r = 0; r < nc; ++r) {
      m[0] = fmaxf(m[0], s.smax[r][r0]);
      m[1] = fmaxf(m[1], s.smax[r][r1]);
    }
  }

  // ---- P in registers, packed to bf16 A fragments; the row sums ----
  uint32_t p[SL / 4];                       // p[4 kk + i]: A register i of k-step kk
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int x = 0; x < 32; x += 2) {
      const float mi = m[(x >> 1) & 1];
      const float s0 = sc[n][x], s1 = sc[n][x + 1];
      uint32_t pk;
      if (MODE == MMONLY) {
        pk = pack2(s0, s1);
      } else if (MODE == BF16P) {
        const __nv_bfloat162 e = h2exp2(__floats2bfloat162_rn(s0 - mi, s1 - mi));
        pk = *reinterpret_cast<const uint32_t*>(&e);
        const float2 f = __bfloat1622float2(e);
        rs[(x >> 1) & 1] += f.x + f.y;
      } else {
        float p0 = USE_EXP2 ? exp2f(s0 - mi) : expf(s0 - mi);
        float p1 = USE_EXP2 ? exp2f(s1 - mi) : expf(s1 - mi);
        if (MODE == MASKED) {
          p0 = s0 > -1e29f ? p0 : 0.f;
          p1 = s1 > -1e29f ? p1 : 0.f;
        }
        if (MODE != MXSUM) rs[(x >> 1) & 1] += p0 + p1;
        pk = pack2(p0, p1);
      }
      p[n * 16 + x / 2] = pk;
    }

  // ---- O_c = P V_c (and mxsum's l = P ones) ----
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float lacc[4] = {0.f, 0.f, 0.f, 0.f};
  mbar_wait(&s.v_full, 0);
  fence_regs(acc);
  fence_regs(lacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SL / 16; ++kk) {
    const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs(acc, pa, desc_b64(&s.v[0][kk * 16 * CHUNK_BYTES_ROW], C::KV_CHUNK, 512));
    if (MODE == MXSUM) wgmma_rs(lacc, pa, desc_b64(s.ones, 1024, 512));
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
  fence_regs(lacc);
  hold_regs(p);

  if (MODE == MXSUM) {                      // every column of P times ones is l
    rs[0] = lacc[0];
    rs[1] = lacc[2];
  } else if (MODE != MMONLY) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    }
  }

  // ---- each row's partial O and l go to the block that writes the row:
  // staged in this block's V tile (done with), then one bulk copy for each
  // block r of the cluster: rows [r per, r per + per) into slot c of r's K
  // tile, completing on r's recv_full ----
  float* part = reinterpret_cast<float*>(&s.v[0][0]);    // (row, LDO), l at column D
  __syncthreads();                          // every warp's P V has read the V tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? r0 : r1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(part + row * C::LDO + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    if (t == 0) part[row * C::LDO + D] = rs[i];
  }
  fence_proxy_async();                      // the copies read what the threads wrote
  __syncthreads();
  float* recv = reinterpret_cast<float*>(&s.k[0][0]);    // (slice, row) x LDO
  if (MODE == MMONLY) cluster_wait();
  if (tid < nc) {                           // thread r sends block r its rows
    const int r = tid, n = min(per, BQ - r * per);
    bulk_copy_to_cluster(cluster_addr(recv + (size_t)c * per * C::LDO, r),
                         part + (size_t)r * per * C::LDO, n * C::LDO * 4,
                         cluster_addr(&s.recv_full, r));
  }
  mbar_wait(&s.recv_full, 0);               // every slice's partials of this block's rows
  // this block's copies out have been read once every block's copies in
  // have landed: arrive now, wait before leaving
  cluster_arrive();

  // ---- block c sums its rows over the slices and writes O ----
  __nv_bfloat16* ob = o + ((size_t)bh * S + q0 + c * per) * D;
  for (int it = tid; it < rows * (D / 4); it += NTHREADS) {
    const int row = it / (D / 4), col = (it % (D / 4)) * 4;
    float4 y[MAXC];                         // every slice's loads in flight at once
    float ly[MAXC];
#pragma unroll
    for (int r = 0; r < MAXC; ++r)
      if (r < nc) {
        const float* src = recv + (size_t)(r * per + row) * C::LDO;
        y[r] = *reinterpret_cast<const float4*>(src + col);
        ly[r] = src[D];
      }
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < MAXC; ++r)
      if (r < nc) {                         // in slice order
        sum.x += y[r].x;
        sum.y += y[r].y;
        sum.z += y[r].z;
        sum.w += y[r].w;
        l += ly[r];
      }
    // O = acc / max(l, 1e-9), as the tool's kernel; mmonly divides by nothing
    const float inv = MODE == MMONLY ? 1.f : 1.f / fmaxf(l, 1e-9f);
    if (q0 + c * per + row < S) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + col);
      dst[0] = __floats2bfloat162_rn(sum.x * inv, sum.y * inv);
      dst[1] = __floats2bfloat162_rn(sum.z * inv, sum.w * inv);
    }
  }
  cluster_wait();
}

template <class C, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, float scale,
           cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem<C>) + 1024;   // + alignment slack
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the limit");
  const int nc = (S + SL - 1) / SL;
  // contiguous (BH, S, D) tensors: rank-4 maps (D, S, 1, BH)
  CUtensorMap qm, km, vm;
  const long long hs = (long long)S * C::D;
  int err = make_head_map(&qm, q, BH, 1, S, C::D, hs, hs, C::D, BQ);
  if (err == 0) err = make_head_map(&km, k, BH, 1, S, C::D, hs, hs, C::D, SL);
  if (err == 0) err = make_head_map(&vm, v, BH, 1, S, C::D, hs, hs, C::D, SL);
  if (err != 0) return err;
  const auto kernel = flash_variants_kernel<C, MODE>;
  static bool configured = false;           // once per instance (no call inside a capture)
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, (S + BQ - 1) / BQ, BH);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, qm, km, vm, static_cast<__nv_bfloat16*>(o), S, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mode(int mode, const void* q, const void* k, const void* v, void* o, int BH, int S,
                float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  switch (mode) {
    case NK1: return launch<C, NK1>(q, k, v, o, BH, S, scale, stream);
    case EXP2: return launch<C, EXP2>(q, k, v, o, BH, S, scale, stream);
    case MXSUM: return launch<C, MXSUM>(q, k, v, o, BH, S, scale, stream);
    case BF16P: return launch<C, BF16P>(q, k, v, o, BH, S, scale, stream);
    case MASKED: return launch<C, MASKED>(q, k, v, o, BH, S, scale, stream);
    case MMONLY: return launch<C, MMONLY>(q, k, v, o, BH, S, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: contiguous bf16 (B*H, S, D) on 16-byte lines, D in {96,
// 128}, S a multiple of 64 up to 1536 (q, k and v may be one tensor: the
// tool's f(x, x, x)); mode 0 nk1, 1 exp2, 2 mxsum, 3 bf16p, 4 masked, 5
// mmonly; scale multiplies Q K^T. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_variants_bf16(const void* q, const void* k, const void* v,
                                   void* o, int BH, int S, int D, int mode,
                                   float scale, void* stream) {
  if (BH <= 0 || S <= 0 || S % KT || S > MAX_SEQ) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 96) return launch_mode<96>(mode, q, k, v, o, BH, S, scale, s);
  if (D == 128) return launch_mode<128>(mode, q, k, v, o, BH, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
