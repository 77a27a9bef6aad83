// Single-query (decode-step) attention for Hopper (sm_90a), bf16 in and out:
// split-K over the cache (flash-decoding), the splits combined inside the
// same launch through a thread block cluster.
//
// Replaces the TPU kernel sct_gan_tpu/ops/decode_attention.py::_kernel (its
// pallas_call at line 83, via decode_attention): for one new token per
// (b, h),
//
//   o = softmax(q . K^T * scale, masked) V        q: (D,), K, V: (S, D)
//
// Bound on an H100: bytes. Each attended key's K and V rows are read once
// (2 x 192 bytes), plus q, o and the mask, for 4 flops a key and head dim:
// about 1 flop a byte, far under the card's ratio, so the CUDA cores' f32
// rate is ample and tensor cores would buy nothing: both products run on
// the CUDA cores. At 3.35 TB/s the (2, 8, 1024, 96) cross-attention step
// with 1924 attended keys needs 1.8 us, the (64, 8, 1024, 96) decode batch
// 60 us.
//
// What held the one-block-per-(b, h) design back was a latency chain, not
// bytes: 16 blocks at B = 2 on 132 SMs, each warp with one 192-byte row of
// K in flight, then V walked again. This design:
//
// * Grid (splits, H, B). The wrapper picks the split count
//   (ops/decode_attention.py::decode_splits) so that B * H * splits fills a
//   wave of 132 SMs where S allows, at most 8; split r takes the key tiles
//   [r * T / splits, (r + 1) * T / splits) of the T tiles of 64 keys, none
//   empty.
// * Loads: a split streams its K and V tiles through a 3-stage ring in
//   shared memory with cp.async.cg, 16 bytes a thread (a 192-byte row is 12
//   such units, so rows need only 16-byte alignment: the contiguous self
//   cache and the head views of the cross K/V, rows 1536 bytes apart, load
//   as they are). Two tiles are in flight while a third is computed; rows
//   past S are zero-filled. A tile whose mask bytes are all zero is never
//   loaded: each warp reads the split's mask bytes 32 tiles at a time
//   (coalesced, one vote a half tile) and walks the live tiles only. All
//   warps read the same bytes, so they agree without a barrier. A split with
//   no attended key reads no K or V and leaves m = -inf, l = 0.
// * Head dims: one instance each for D = 64, 96, 128 and 192 (DecodeShape
//   below). A row is D / 8 16-byte units (8, 12, 16 or 24); a block has 16
//   threads for each unit of a row: 128 to 384 threads. Any head dim dh <=
//   192 that is a multiple of 8 runs in place on the smallest instance
//   that holds it (80 on 96, 160 on 192): the copies of units at or past
//   dh / 8 are predicated off and zero-fill their place in the ring, q's
//   tail is zero in sq, and o is written only for its dh columns. That is
//   the arithmetic of a zero-padded copy without the copy. The tail is a
//   template flag (TAIL), so an instance at its own head dim runs the code
//   it ran before tails existed. A head dim over 192, any multiple of 8,
//   runs the wide-head route at the end of this file (decode_wide_kernel),
//   in place the same way (the wrapper pads a head dim that is not a
//   multiple of 8).
// * Scores: thread t takes key t % 64 of the tile and the part t / 64 of
//   the head dim (4 units; that part of q, pre-scaled, in f32 registers);
//   the D / 32 partial dots meet in shared memory. Bank conflicts: the 8
//   threads of a quarter warp (keys j0..j0+7) read one unit index each and
//   must hit 8 distinct 16-byte bank groups. At D = 96 a 192-byte row
//   starts 64 bytes past a multiple of 128, so rows j and j + 2 start in
//   the same bank group: each thread walks its 4 units starting at unit
//   (j / 2) % 4, with q rotated the same way in registers so that its
//   index stays static. At D = 64 and 128 every row (128 or 256 bytes)
//   starts in bank group 0 and a part has only 4 units, so no rotation can
//   spread 8 rows: instead the tile itself is stored swizzled, unit u of
//   row j at unit u ^ (j % 8) of that row (the copies write it so), and
//   the 8 rows of a quarter warp read 8 distinct bank groups. At D = 192
//   (384-byte rows) the same holds, and the swizzle keeps a unit inside its
//   group of 8, so it never leaves the row.
// * Online softmax across the split's tiles (warp 0 keeps the running m
//   and l in f32, base-2 exponents), then p V on the CUDA cores: thread t
//   owns the 16-byte unit t % (D / 8) of the head dim for keys
//   t / (D / 8) + 16 i of the tile, 8 f32 accumulators, and consecutive
//   threads read consecutive 16-byte units of V (no conflict; the swizzle
//   permutes units within each group of 8). The 16 key slots meet in
//   shared memory at the end, in a fixed order.
// * The combine, inside the launch: the splits of a (b, h) form one thread
//   block cluster (cudaLaunchKernelEx with a cluster dimension of `splits`,
//   at most 8, the portable size). Each block leaves its (m, l, o[D]) in
//   its shared memory; after a cluster barrier block 0 reads the others'
//   through distributed shared memory, combines them in split order and
//   writes o; a second barrier keeps the others' shared memory alive until
//   it has read. No global workspace, no atomics, no second kernel, and
//   the result does not depend on which block finishes first: two runs
//   give the same bits. With one split (large B) the block normalises and
//   writes o itself.
//
// Budget at D = 96: 72 KB of dynamic shared memory (3 stages x (K + V) x
// 64 keys x 192 bytes; the key slots' sums reuse it at the end) and 1920
// bytes static; 192 threads; __launch_bounds__(192, 3) caps registers at
// 112 so that 3 blocks fit an SM (ptxas: 96, no spill; the build phase of
// chip_smoke.py fails on a spill). D = 64: 48 KB, 128 threads, 4 blocks
// an SM; D = 128: 96 KB, 256 threads, 2 blocks an SM; both at most 128
// registers.
//
// D = 192 keeps the design whole: one block holds its split's whole row,
// so each split reads its K and V rows once. 144 KB dynamic (3 x 2 x 64 x
// 384 bytes) and 3456 bytes static, 384 threads. One block fits an SM
// (227 KB), so __launch_bounds__(384, 1) leaves ptxas up to 168 registers
// a thread (it uses 106; 64 / 96 / 128: 108 / 96 / 96), no spill. Two
// tiles of 48 KB are in flight while a third is computed, four times the
// ~25 KB an SM needs in flight for its share of 3.35 TB/s. Two blocks an
// SM would need a 2-stage ring (96 KB) and at most 80 registers a thread.
// The split count keeps the rule of the other instances.
//
// No instance at D = 256: one measured on an H100 (512 threads, a 192 KB
// ring, one block an SM) lost 7-12% to the wide-head route below, which
// runs two 256-thread blocks an SM (PERF.md §6); 256 stays on that route.
//
// Semantics (the JAX kernel's): masked keys get -inf; a fully-masked row
// gives zeros; any S >= 1.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 64;                     // keys a tile
constexpr int STAGES = 3;
constexpr int PART_UNITS = 4;                // scores: 16-byte units a part
constexpr int MAX_SPLITS = 8;                // a portable cluster
constexpr float LOG2E = 1.4426950408889634f;

// The thread layout of each head-dim instance.
template <int D>
struct DecodeShape {
  static constexpr int UNITS = D / 8;                   // 16-byte units a row
  static constexpr int PARTS = UNITS / PART_UNITS;      // scores: parts of D
  static constexpr int NTHREADS = TILE * PARTS;
  static constexpr int SLOTS = NTHREADS / UNITS;        // p V: 16 key slots
  static constexpr int TILE_ELEMS = TILE * D;
  static constexpr int SMEM_BYTES = STAGES * 2 * TILE_ELEMS * 2;
  static constexpr bool SWIZZLE = UNITS % 8 == 0;       // see the header
  static constexpr int MIN_BLOCKS = D == 64 ? 4 : D == 96 ? 3 : D == 128 ? 2 : 1;
  static_assert(D <= 192, "past 192 the wide-head route");
  static_assert(PARTS * PART_UNITS == UNITS, "whole parts");
  static_assert(SLOTS * UNITS == NTHREADS && TILE % SLOTS == 0, "p V slots");
  static_assert(SLOTS * D * 4 <= SMEM_BYTES, "the slots' sums reuse the ring");
  static_assert(NTHREADS >= D, "one thread a column in the combine");
};

// Where unit `unit` of tile row `row` is stored: swizzled at D = 64 and 128.
template <int D>
__device__ __forceinline__ int unit_at(int row, int unit) {
  return DecodeShape<D>::SWIZZLE ? unit ^ (row & 7) : unit;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The live tiles of one split, in order: a tile is live when one of its
// keys is attended. Every thread keeps its own copy; called by all threads
// alike, every warp gets the same answers from the same mask bytes.
struct LiveTiles {
  const uint8_t* mask;   // the batch row's mask, or null: every tile live
  int end, S;            // the split's end tile; the keys
  int w0;                // first tile of the window whose bits are held
  uint32_t bits;         // bit i: tile w0 + i is live

  // The bits of the 32 tiles from w: the warp reads their mask bytes
  // coalesced, 32 a load, eight loads in flight, one vote a half tile.
  __device__ void load_window(int w) {
    const int lane = threadIdx.x & 31;
    const int j_end = min(S, end * TILE);
    const int halves = 2 * min(32, end - w);
    w0 = w;
    bits = 0;
    for (int k0 = 0; k0 < halves; k0 += 8) {
      bool on[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = w * TILE + (k0 + e) * 32 + lane;
        on[e] = j < j_end && mask[j] != 0;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (__any_sync(0xffffffffu, on[e])) bits |= 1u << ((k0 + e) >> 1);
    }
  }

  // The first live tile at or after t, or `end`. t never decreases.
  __device__ int next(int t) {
    if (mask == nullptr) return min(t, end);
    while (t < end) {
      if (t >= w0 + 32) load_window(t);
      const uint32_t rest = bits >> (t - w0);
      if (rest) return t + __ffs(rest) - 1;
      t = w0 + 32;
    }
    return end;
  }
};

// Start copying the K and V rows of `tile` into ring stage `st` (K then V):
// 16 bytes a copy, 4 of K and 4 of V a thread; rows past S, and with TAIL
// the units past the true head dim dh, are zero-filled; unit u of a row
// lands at unit_at(row, u).
template <int D, bool TAIL>
__device__ __forceinline__ void load_tile(__nv_bfloat16* st, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, int k_ss, int v_ss,
                                          int tile, int S, int dh) {
  using Shape = DecodeShape<D>;
  constexpr int UNITS = Shape::UNITS, NTHREADS = Shape::NTHREADS;
  static_assert(TILE * UNITS == 4 * NTHREADS, "4 copies a thread");
#pragma unroll
  for (int i = 0; i < TILE * UNITS / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int row = c / UNITS, unit = c % UNITS;
    const int key = tile * TILE + row;
    const bool valid = key < S && (!TAIL || unit < dh / 8);
    const size_t r = valid ? key : 0;          // a zero-fill reads nothing:
    const int u = TAIL && !valid ? 0 : unit;   // point it at a unit of row 0
    const int at = row * D + unit_at<D>(row, unit) * 8;
    hopper::cp_async_16(st + at, kb + r * k_ss + u * 8, valid);
    hopper::cp_async_16(st + Shape::TILE_ELEMS + at, vb + r * v_ss + u * 8, valid);
  }
}

// TAIL: the true head dim dh is under D (a multiple of 8); without it dh
// is D and every predicate on it folds away.
template <int D, bool TAIL>
__global__ void __launch_bounds__(DecodeShape<D>::NTHREADS, DecodeShape<D>::MIN_BLOCKS)
decode_splitk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                     __nv_bfloat16* __restrict__ o, int S, int dh_arg, int q_sb, int q_sh,
                     int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
                     int o_sb, int o_sh, int mask_sb, float scale_log2) {
  using Shape = DecodeShape<D>;
  constexpr int UNITS = Shape::UNITS, PARTS = Shape::PARTS, SLOTS = Shape::SLOTS;
  constexpr int TILE_ELEMS = Shape::TILE_ELEMS;
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][K, V][TILE][D]
  __shared__ float sq[D];
  __shared__ float part[PARTS][TILE];
  __shared__ float ps[TILE];
  __shared__ float alpha_s;
  __shared__ float split_o[D];     // this split's unnormalised o, m and l,
  __shared__ float split_ml[2];    // read by block 0 of the cluster

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh = TAIL ? dh_arg : D;
  const __nv_bfloat16* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const __nv_bfloat16* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const __nv_bfloat16* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;

  const int tiles = (S + TILE - 1) / TILE;
  const int t_begin = static_cast<int>((long long)split * tiles / nsplit);
  const int t_end = static_cast<int>((long long)(split + 1) * tiles / nsplit);

  // the split's first two live tiles start loading before anything else
  LiveTiles live{mb, t_end, S, t_begin - 32, 0u};
  int cur = live.next(t_begin);
  if (cur < t_end) load_tile<D, TAIL>(ring, kb, vb, k_ss, v_ss, cur, S, dh);
  hopper::cp_async_commit();
  int nxt = live.next(cur + 1);
  if (nxt < t_end) load_tile<D, TAIL>(ring + 2 * TILE_ELEMS, kb, vb, k_ss, v_ss, nxt, S, dh);
  hopper::cp_async_commit();
  int ahead = live.next(nxt + 1);

  if (tid < D / 2) {                        // q's tail past dh is zero
    const float2 f = !TAIL || 2 * tid < dh
        ? __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qb)[tid])
        : make_float2(0.f, 0.f);
    sq[2 * tid] = f.x * scale_log2;
    sq[2 * tid + 1] = f.y * scale_log2;
  }
  __syncthreads();
  // scores: key kj of the tile, part pi of the head dim; at D = 96 the
  // units are rotated (none where the tile is swizzled)
  const int kj = tid % TILE, pi = tid / TILE;
  const int rot = Shape::SWIZZLE ? 0 : (kj >> 1) % PART_UNITS;
  float qr[PART_UNITS * 8];
#pragma unroll
  for (int c = 0; c < PART_UNITS; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[c * 8 + e] = sq[(pi * PART_UNITS + (c + rot) % PART_UNITS) * 8 + e];
  // p V: unit pu of the head dim, key slot ks
  const int pu = tid % UNITS, ks = tid / UNITS;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;     // warp 0's

  for (int i = 0; cur < t_end; ++i) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();              // tile i has landed; stage (i + 2) % 3 is free
    if (ahead < t_end)
      load_tile<D, TAIL>(ring + ((i + 2) % STAGES) * 2 * TILE_ELEMS, kb, vb, k_ss, v_ss, ahead,
                         S, dh);
    hopper::cp_async_commit();
    const __nv_bfloat16* kt = ring + (i % STAGES) * 2 * TILE_ELEMS;
    const __nv_bfloat16* vt = kt + TILE_ELEMS;

    bool on0 = true, on1 = true;  // warp 0: are keys lane and lane + 32 attended
    if (warp == 0) {
      const int j0 = cur * TILE + lane, j1 = j0 + 32;
      on0 = j0 < S && (mb == nullptr || mb[j0] != 0);
      on1 = j1 < S && (mb == nullptr || mb[j1] != 0);
    }

    float s = 0.f;
    const __nv_bfloat16* krow = kt + kj * D;
#pragma unroll
    for (int c = 0; c < PART_UNITS; ++c) {
      const int unit = pi * PART_UNITS + (c + rot) % PART_UNITS;
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + unit_at<D>(kj, unit) * 8);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p2[e]);
        s = fmaf(qr[c * 8 + 2 * e], f.x, s);
        s = fmaf(qr[c * 8 + 2 * e + 1], f.y, s);
      }
    }
    part[pi][kj] = s;
    __syncthreads();

    if (warp == 0) {              // the online softmax over this tile
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        s0 += part[p][lane];
        s1 += part[p][lane + 32];
      }
      s0 = on0 ? s0 : -INFINITY;
      s1 = on1 ? s1 : -INFINITY;
      // finite: a live tile has an attended key
      const float m_new = fmaxf(m_run, warp_max(fmaxf(s0, s1)));
      const float a = exp2f(m_run - m_new);        // 0 on the first tile
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      l_run = l_run * a + warp_sum(p0 + p1);
      m_run = m_new;
      ps[lane] = p0;
      ps[lane + 32] = p1;
      if (lane == 0) alpha_s = a;
    }
    __syncthreads();

    const float a = alpha_s;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= a;
#pragma unroll
    for (int r = 0; r < TILE / SLOTS; ++r) {
      const int j = ks + r * SLOTS;
      const float p = ps[j];
      const uint4 raw = *reinterpret_cast<const uint4*>(vt + j * D + unit_at<D>(j, pu) * 8);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p2[e]);
        acc[2 * e] = fmaf(p, f.x, acc[2 * e]);
        acc[2 * e + 1] = fmaf(p, f.y, acc[2 * e + 1]);
      }
    }
    cur = nxt;
    nxt = ahead;
    ahead = live.next(ahead + 1);
  }

  hopper::cp_async_wait<0>();
  __syncthreads();                // the ring is free: the key slots meet there
  float* slots = reinterpret_cast<float*>(smem);   // [SLOTS][D]
  float4* dst = reinterpret_cast<float4*>(slots + ks * D + pu * 8);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (tid == 0) {
    split_ml[0] = m_run;
    split_ml[1] = l_run;
  }
  __syncthreads();
  float od = 0.f;
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) od += slots[r * D + tid];
  }
  __nv_bfloat16* ob = o + (size_t)b * o_sb + (size_t)h * o_sh;
  if (nsplit == 1) {                // o is written for its dh columns only
    if (tid < dh) {
      const float l = split_ml[1];
      ob[tid] = __float2bfloat16(l > 0.f ? od / l : 0.f);
    }
    return;
  }
  if (tid < D) split_o[tid] = od;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                 // every split's (m, l, o) is in place
  if (cluster.block_rank() == 0 && tid < dh) {
    float mr[MAX_SPLITS], lr[MAX_SPLITS], orr[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      mr[r] = -INFINITY;
      lr[r] = orr[r] = 0.f;
      if (r < nsplit) {
        const float* ml = cluster.map_shared_rank(split_ml, r);
        mr[r] = ml[0];
        lr[r] = ml[1];
        orr[r] = cluster.map_shared_rank(split_o, r)[tid];
      }
    }
    float m_max = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) m_max = fmaxf(m_max, mr[r]);
    float l = 0.f, acc_o = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {      // in split order
      const float w = mr[r] == -INFINITY ? 0.f : exp2f(mr[r] - m_max);
      l = fmaf(lr[r], w, l);
      acc_o = fmaf(orr[r], w, acc_o);
    }
    ob[tid] = __float2bfloat16(l > 0.f ? acc_o / l : 0.f);
  }
  cluster.sync();                 // block 0 has read the others' shared memory
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
           int H, int S, int dh, int q_sb, int q_sh, int k_sb, int k_sh, int k_ss, int v_sb,
           int v_sh, int v_ss, int o_sb, int o_sh, int mask_sb, int splits, float scale,
           cudaStream_t stream) {
  using Shape = DecodeShape<D>;
  const bool tail = dh < D;
  const auto kernel = tail ? decode_splitk_kernel<D, true> : decode_splitk_kernel<D, false>;
  static bool configured[2] = {false, false};   // above 48 KB needs an opt-in
  if (!configured[tail]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[tail] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H, B);
  cfg.blockDim = dim3(Shape::NTHREADS);
  cfg.dynamicSmemBytes = Shape::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(o), S, dh, q_sb, q_sh,
      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, mask_sb, scale * LOG2E);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- the wide-head route: D > 192, a multiple of 8 -------------------------
//
// The instances stage whole K and V rows; past D = 256 three stages of them
// outgrow shared memory (384: 288 KB), and at 256 one block an SM lost to
// this route. It cuts o's head dim dh into nchunk = ceil(dh / 128) chunks
// of 128 columns: grid (splits, H, B x nchunk), one cluster of `splits`
// blocks per (b, h, chunk c), combined as above. Each block computes the
// scores over the full row, one 128-column K slab at a time, and
// accumulates only V's chunk c:
//
//   per live tile: s = sum over chunks cc of q[cc] . K[:, cc]   (nchunk items)
//                  o[c] += softmax-weights . V[:, c]            (one item)
//
// Every item is one 64-key x 128-column slab (16 KB) through the same
// 3-stage cp.async ring, stored swizzled as the 128 instance's tiles (unit u
// of row j at u ^ (j % 8): a 256-byte row starts in bank group 0); 256
// threads, the 128 instance's score and p V layouts. q, pre-scaled, lives
// in shared memory (D f32) and each thread reads its part of the current
// chunk. Any multiple of 8 runs with the same ring: as in the instances
// (and under the same TAIL flag, set when dh is not a multiple of 128),
// the copies of units at or past dh / 8 zero-fill their place, q's tail is
// zero in sq, and the last chunk writes only its columns under dh.
//
// Bound: the bytes, as the instances': each attended key's K and V rows
// once. The route reads each K row once per chunk (nchunk times in all),
// and V once: it is right and simple, not fast.
constexpr int WIDE_COLS = 128;                          // a head-dim chunk
constexpr int WIDE_UNITS = WIDE_COLS / 8;               // 16-byte units of a slab row
constexpr int WIDE_PARTS = WIDE_UNITS / PART_UNITS;     // scores: parts of a chunk
constexpr int WIDE_THREADS = TILE * WIDE_PARTS;         // 256
constexpr int WIDE_SLOTS = WIDE_THREADS / WIDE_UNITS;   // p V: 16 key slots
constexpr int WIDE_SLAB = TILE * WIDE_COLS;             // elements of a slab
constexpr int WIDE_RING_BYTES = STAGES * WIDE_SLAB * 2;
static_assert(WIDE_SLOTS * WIDE_COLS * 4 <= WIDE_RING_BYTES, "slots reuse the ring");
static_assert(TILE * WIDE_UNITS == 4 * WIDE_THREADS, "4 copies a thread");

// An item of a split's walk: chunk s < nchunk of K's rows of `tile` (a score
// item), or, at s == nchunk, V's chunk c (the value item). tile == end: done.
struct WideItem {
  int tile, s;
};

// Start copying the slab of `item` into ring stage `st`, swizzled; rows
// past S, and with TAIL units past the head dim's `units`, are zero-filled.
template <bool TAIL>
__device__ __forceinline__ void load_wide_slab(__nv_bfloat16* st, const __nv_bfloat16* kb,
                                               const __nv_bfloat16* vb, int k_ss, int v_ss,
                                               WideItem item, int nchunk, int c, int S,
                                               int units) {
  const bool is_k = item.s < nchunk;
  const int chunk = is_k ? item.s : c;
  const __nv_bfloat16* src = (is_k ? kb : vb) + chunk * WIDE_COLS;
  const int ss = is_k ? k_ss : v_ss;
#pragma unroll
  for (int i = 0; i < TILE * WIDE_UNITS / WIDE_THREADS; ++i) {
    const int idx = threadIdx.x + i * WIDE_THREADS;
    const int row = idx / WIDE_UNITS, unit = idx % WIDE_UNITS;
    const int key = item.tile * TILE + row;
    const bool valid = key < S && (!TAIL || chunk * WIDE_UNITS + unit < units);
    const size_t r = valid ? key : 0;          // a zero-fill reads nothing:
    const int u = TAIL && !valid ? 0 : unit;   // point it at the chunk's row 0
    hopper::cp_async_16(st + row * WIDE_COLS + (unit ^ (row & 7)) * 8,
                        src + r * ss + u * 8, valid);
  }
}

template <bool TAIL>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
decode_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                   __nv_bfloat16* __restrict__ o, int S, int dh_arg, int nchunk, int q_sb,
                   int q_sh,
                   int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
                   int o_sh, int mask_sb, float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);   // [STAGES][TILE][128]
  float* sq = reinterpret_cast<float*>(smem + WIDE_RING_BYTES);    // [D], pre-scaled q
  __shared__ float part[WIDE_PARTS][TILE];
  __shared__ float ps[TILE];
  __shared__ float alpha_s;
  __shared__ float split_o[WIDE_COLS];   // this split's unnormalised o chunk, m, l
  __shared__ float split_ml[2];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z / nchunk, c = blockIdx.z % nchunk;
  const int D = nchunk * WIDE_COLS;
  const int dh = TAIL ? dh_arg : D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const __nv_bfloat16* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const __nv_bfloat16* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;

  const int tiles = (S + TILE - 1) / TILE;
  const int t_begin = static_cast<int>((long long)split * tiles / nsplit);
  const int t_end = static_cast<int>((long long)(split + 1) * tiles / nsplit);
  LiveTiles live{mb, t_end, S, t_begin - 32, 0u};
  auto advance = [&](WideItem it) -> WideItem {   // the item after `it`
    if (it.tile >= t_end) return it;
    if (it.s < nchunk) return {it.tile, it.s + 1};
    return {live.next(it.tile + 1), 0};
  };
  auto issue = [&](WideItem it, int st) {
    if (it.tile < t_end)
      load_wide_slab<TAIL>(ring + st * WIDE_SLAB, kb, vb, k_ss, v_ss, it, nchunk, c, S, dh / 8);
    hopper::cp_async_commit();
  };
  // the split's first two items start loading before anything else
  WideItem cur{live.next(t_begin), 0};
  WideItem nxt = advance(cur);
  issue(cur, 0);
  issue(nxt, 1);
  WideItem ahead = advance(nxt);

  for (int i = tid; i < D / 2; i += WIDE_THREADS) {   // q's tail past dh is zero
    const float2 f = !TAIL || 2 * i < dh
        ? __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qb)[i])
        : make_float2(0.f, 0.f);
    sq[2 * i] = f.x * scale_log2;
    sq[2 * i + 1] = f.y * scale_log2;
  }
  __syncthreads();
  const int kj = tid % TILE, pi = tid / TILE;      // scores: key kj, part pi of a chunk
  const int pu = tid % WIDE_UNITS, ks = tid / WIDE_UNITS;   // p V: unit pu, key slot ks
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;     // warp 0's
  float s_acc = 0.f;                        // this thread's score, summed over chunks

  for (int i = 0; cur.tile < t_end; ++i) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();              // item i has landed; stage (i + 2) % 3 is free
    issue(ahead, (i + 2) % STAGES);
    const __nv_bfloat16* slab = ring + (i % STAGES) * WIDE_SLAB;
    if (cur.s < nchunk) {         // a score item: K's chunk cur.s
      const float* qc = sq + cur.s * WIDE_COLS;
      const __nv_bfloat16* krow = slab + kj * WIDE_COLS;
#pragma unroll
      for (int u = 0; u < PART_UNITS; ++u) {
        const int unit = pi * PART_UNITS + u;
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + (unit ^ (kj & 7)) * 8);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p2[e]);
          s_acc = fmaf(qc[unit * 8 + 2 * e], f.x, s_acc);
          s_acc = fmaf(qc[unit * 8 + 2 * e + 1], f.y, s_acc);
        }
      }
      if (cur.s == nchunk - 1) {  // the tile's scores are whole
        part[pi][kj] = s_acc;
        s_acc = 0.f;
        __syncthreads();
        if (warp == 0) {          // the online softmax over this tile
          const int j0 = cur.tile * TILE + lane, j1 = j0 + 32;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int p = 0; p < WIDE_PARTS; ++p) {
            s0 += part[p][lane];
            s1 += part[p][lane + 32];
          }
          s0 = j0 < S && (mb == nullptr || mb[j0] != 0) ? s0 : -INFINITY;
          s1 = j1 < S && (mb == nullptr || mb[j1] != 0) ? s1 : -INFINITY;
          // finite: a live tile has an attended key
          const float m_new = fmaxf(m_run, warp_max(fmaxf(s0, s1)));
          const float a = exp2f(m_run - m_new);    // 0 on the first tile
          const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
          l_run = l_run * a + warp_sum(p0 + p1);
          m_run = m_new;
          ps[lane] = p0;
          ps[lane + 32] = p1;
          if (lane == 0) alpha_s = a;
        }
      }
    } else {                      // the value item: V's chunk c
      const float a = alpha_s;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= a;
#pragma unroll
      for (int r = 0; r < TILE / WIDE_SLOTS; ++r) {
        const int j = ks + r * WIDE_SLOTS;
        const float p = ps[j];
        const uint4 raw =
            *reinterpret_cast<const uint4*>(slab + j * WIDE_COLS + (pu ^ (j & 7)) * 8);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p2[e]);
          acc[2 * e] = fmaf(p, f.x, acc[2 * e]);
          acc[2 * e + 1] = fmaf(p, f.y, acc[2 * e + 1]);
        }
      }
    }
    cur = nxt;
    nxt = ahead;
    ahead = advance(ahead);
  }

  hopper::cp_async_wait<0>();
  __syncthreads();                // the ring is free: the key slots meet there
  float* slots = reinterpret_cast<float*>(smem);   // [WIDE_SLOTS][128]
  float4* dst = reinterpret_cast<float4*>(slots + ks * WIDE_COLS + pu * 8);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (tid == 0) {
    split_ml[0] = m_run;
    split_ml[1] = l_run;
  }
  __syncthreads();
  float od = 0.f;
  if (tid < WIDE_COLS) {
#pragma unroll
    for (int r = 0; r < WIDE_SLOTS; ++r) od += slots[r * WIDE_COLS + tid];
  }
  __nv_bfloat16* ob = o + (size_t)b * o_sb + (size_t)h * o_sh + c * WIDE_COLS;
  const int cols = TAIL ? min(WIDE_COLS, dh - c * WIDE_COLS) : WIDE_COLS;   // o's, in chunk c
  if (nsplit == 1) {
    if (tid < cols) {
      const float l = split_ml[1];
      ob[tid] = __float2bfloat16(l > 0.f ? od / l : 0.f);
    }
    return;
  }
  if (tid < WIDE_COLS) split_o[tid] = od;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                 // every split's (m, l, o) is in place
  if (cluster.block_rank() == 0 && tid < cols) {
    float mr[MAX_SPLITS], lr[MAX_SPLITS], orr[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      mr[r] = -INFINITY;
      lr[r] = orr[r] = 0.f;
      if (r < nsplit) {
        const float* ml = cluster.map_shared_rank(split_ml, r);
        mr[r] = ml[0];
        lr[r] = ml[1];
        orr[r] = cluster.map_shared_rank(split_o, r)[tid];
      }
    }
    float m_max = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) m_max = fmaxf(m_max, mr[r]);
    float l = 0.f, acc_o = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {      // in split order
      const float w = mr[r] == -INFINITY ? 0.f : exp2f(mr[r] - m_max);
      l = fmaf(lr[r], w, l);
      acc_o = fmaf(orr[r], w, acc_o);
    }
    ob[tid] = __float2bfloat16(l > 0.f ? acc_o / l : 0.f);
  }
  cluster.sync();                 // block 0 has read the others' shared memory
}

int launch_wide(const void* q, const void* k, const void* v, const void* mask, void* o,
                int B, int H, int S, int Dh, int q_sb, int q_sh, int k_sb, int k_sh,
                int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh, int mask_sb,
                int splits, float scale, cudaStream_t stream) {
  const int nchunk = (Dh + WIDE_COLS - 1) / WIDE_COLS;
  if ((long long)B * nchunk > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = WIDE_RING_BYTES + nchunk * WIDE_COLS * 4;
  const bool tail = Dh % WIDE_COLS != 0;
  const auto kernel = tail ? decode_wide_kernel<true> : decode_wide_kernel<false>;
  static int configured[2] = {0, 0};        // above 48 KB needs an opt-in
  if (smem > configured[tail]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[tail] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H, B * nchunk);
  cfg.blockDim = dim3(WIDE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(o), S, Dh, nchunk,
      q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, mask_sb, scale * LOG2E);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: bf16 (B, H, 1, Dh); k, v: bf16 (B, H, S, Dh), Dh a multiple of 8.
// Up to 192 it runs on the smallest instance of 64, 96, 128 and 192 that
// holds it; above, the wide-head route (B x ceil(Dh / 128) at most
// 65535). Each with element strides (sb, sh, ss) and the last
// dimension contiguous (the q/o sequence strides are unused); q and o on
// 4-byte lines, k and v rows on 16-byte lines. mask: (B, S) uint8 (nonzero
// = attend) with row stride mask_sb, or null for "all S keys visible".
// splits: blocks (one cluster) per (b, h), 1..8 and at most the 64-key
// tiles of S. Returns a cudaError_t.
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    int B, int H, int S, int Dh, int q_sb, int q_sh, int q_ss, int k_sb,
    int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh,
    int o_ss, int mask_sb, int splits, float scale, void* stream) {
  (void)q_ss;
  (void)o_ss;
  if (S < 1 || B < 1 || B > 65535 || H < 1 || H > 65535 || splits < 1 ||
      splits > MAX_SPLITS || splits > (S + TILE - 1) / TILE || Dh < 8 || Dh % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_ARGS q, k, v, mask, o, B, H, S, Dh, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, \
    v_ss, o_sb, o_sh, mask_sb, splits, scale, st
  if (Dh <= 64) return launch<64>(DECODE_ARGS);
  if (Dh <= 96) return launch<96>(DECODE_ARGS);
  if (Dh <= 128) return launch<128>(DECODE_ARGS);
  if (Dh <= 192) return launch<192>(DECODE_ARGS);
#undef DECODE_ARGS
  return launch_wide(q, k, v, mask, o, B, H, S, Dh, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh,
                     v_ss, o_sb, o_sh, mask_sb, splits, scale, st);   // the wide-head route
}
