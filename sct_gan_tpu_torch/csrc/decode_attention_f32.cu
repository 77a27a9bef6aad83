// Single-query (decode-step) attention for Hopper (sm_90a) over f32 KV
// caches: the f32 instance of K5 (decode_attention.cu is the bf16 one).
//
// Replaces the TPU kernel sct_gan_tpu/ops/decode_attention.py::_kernel (its
// pallas_call at line 83) where the caches are f32, as the JAX TASC decoder
// keeps them (sct_gan_tpu/variants/tasc.py:267, models/layers.py:299-308)
// and as f32 generation of ModelConfig(compute_dtype="float32") does:
//
//   o = softmax(q . K^T * scale, masked) V        q: (D,), K, V: (S, D) f32
//
// q comes in f32 (the wrapper upcasts a bf16 query exactly) and o goes out
// in the query's dtype: f32, or bf16 when o_bf16 (the JAX kernel's output
// dtype, line 74). All arithmetic is f32.
//
// Bound on an H100: bytes. Each attended key's K and V rows are read once
// (2 x 4 D bytes) for 4 D flops: half a flop a byte, so both products run
// on the CUDA cores. At (64, 8, 1024, 96) every key attended that is 403 MB
// of cache, 0.12 ms at 3.35 TB/s.
//
// Design: the bf16 kernel's split-K with the splits combined in one thread
// block cluster (its header says why), at f32 rows:
// * grid (splits, H, B); split r takes the 64-key tiles [r T / splits,
//   (r + 1) T / splits) of the T tiles (the wrapper's decode_splits);
// * K and V tiles through a 3-stage cp.async ring, 16 bytes (4 f32) a copy,
//   a tile whose mask bytes are all zero never loaded (LiveTiles below);
//   rows past S zero-filled. A row is D / 4 units (16, 24, 32): unit u of
//   row j is stored at u ^ (j % 8) (every row starts in bank group 0, and
//   the swizzle spreads the 8 rows a quarter warp reads);
// * scores: thread t takes key t % 64 and the part t / 64 of the head dim
//   (16 f32 of q, pre-scaled, in registers); the D / 16 partial dots meet
//   in shared memory; warp 0 runs the online softmax (natural exponent,
//   f32 results are held at 1e-5);
// * p V: thread t owns the 16-byte unit t % (D / 4) of the head dim for
//   the 16 key slots t / (D / 4) + 16 i, summed in a fixed order at the end;
// * the combine: each block leaves (m, l, o) in its shared memory, block 0
//   of the cluster reads the others' and writes o; two runs give the same
//   bits.
// Budget: 3 stages x (K, V) x 64 keys x 4 D bytes: 96 / 144 / 192 KB at D =
// 64 / 96 / 128 with 256 / 384 / 512 threads (two blocks an SM at 64, one
// at 96 and 128).
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

template <int D>
struct DecodeF32 {
  static constexpr int UNITS = D / 4;                   // 16-byte units a row
  static constexpr int PARTS = UNITS / PART_UNITS;      // scores: parts of D
  static constexpr int NTHREADS = TILE * PARTS;
  static constexpr int SLOTS = NTHREADS / UNITS;        // p V: 16 key slots
  static constexpr int TILE_ELEMS = TILE * D;
  static constexpr int SMEM_BYTES = STAGES * 2 * TILE_ELEMS * 4;
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
  static_assert(UNITS % 8 == 0, "the swizzle permutes groups of 8 units");
  static_assert(SLOTS * UNITS == NTHREADS && TILE % SLOTS == 0, "p V slots");
  static_assert(SLOTS * D * 4 <= SMEM_BYTES, "the slots' sums reuse the ring");
  static_assert(NTHREADS >= D, "one thread a column in the combine");
};

__device__ __forceinline__ int unit_at(int row, int unit) { return unit ^ (row & 7); }

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

// The live tiles of one split, in order (the bf16 kernel's walk): a tile is
// live when one of its keys is attended. Called by all threads alike.
struct LiveTiles {
  const uint8_t* mask;   // the batch row's mask, or null: every tile live
  int end, S;            // the split's end tile; the keys
  int w0;                // first tile of the window whose bits are held
  uint32_t bits;         // bit i: tile w0 + i is live

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

// Start copying the K and V rows of `tile` into ring stage `st`: 4 copies of
// K and 4 of V a thread; rows past S zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* st, const float* kb, const float* vb,
                                          int k_ss, int v_ss, int tile, int S) {
  using Shape = DecodeF32<D>;
  constexpr int UNITS = Shape::UNITS, NTHREADS = Shape::NTHREADS;
  static_assert(TILE * UNITS == 4 * NTHREADS, "4 copies a thread");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int row = c / UNITS, unit = c % UNITS;
    const int key = tile * TILE + row;
    const bool valid = key < S;
    const size_t r = valid ? key : 0;          // a zero-fill reads nothing
    const int at = row * D + unit_at(row, unit) * 4;
    hopper::cp_async_16(st + at, kb + r * k_ss + unit * 4, valid);
    hopper::cp_async_16(st + Shape::TILE_ELEMS + at, vb + r * v_ss + unit * 4, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(DecodeF32<D>::NTHREADS, DecodeF32<D>::MIN_BLOCKS)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const uint8_t* __restrict__ mask,
                  void* __restrict__ o, int o_bf16, int S, int q_sb, int q_sh, int k_sb,
                  int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh,
                  int mask_sb, float scale) {
  using Shape = DecodeF32<D>;
  constexpr int UNITS = Shape::UNITS, PARTS = Shape::PARTS, SLOTS = Shape::SLOTS;
  constexpr int TILE_ELEMS = Shape::TILE_ELEMS;
  extern __shared__ __align__(128) uint8_t smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [STAGES][K, V][TILE][D]
  __shared__ float sq[D];
  __shared__ float part[PARTS][TILE];
  __shared__ float ps[TILE];
  __shared__ float alpha_s;
  __shared__ float split_o[D];     // this split's unnormalised o, m and l,
  __shared__ float split_ml[2];    // read by block 0 of the cluster

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const float* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const float* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;

  const int tiles = (S + TILE - 1) / TILE;
  const int t_begin = static_cast<int>((long long)split * tiles / nsplit);
  const int t_end = static_cast<int>((long long)(split + 1) * tiles / nsplit);

  LiveTiles live{mb, t_end, S, t_begin - 32, 0u};
  int cur = live.next(t_begin);
  if (cur < t_end) load_tile<D>(ring, kb, vb, k_ss, v_ss, cur, S);
  hopper::cp_async_commit();
  int nxt = live.next(cur + 1);
  if (nxt < t_end) load_tile<D>(ring + 2 * TILE_ELEMS, kb, vb, k_ss, v_ss, nxt, S);
  hopper::cp_async_commit();
  int ahead = live.next(nxt + 1);

  if (tid < D) sq[tid] = qb[tid] * scale;
  __syncthreads();
  // scores: key kj of the tile, part pi of the head dim
  const int kj = tid % TILE, pi = tid / TILE;
  float qr[PART_UNITS * 4];
#pragma unroll
  for (int i = 0; i < PART_UNITS * 4; ++i) qr[i] = sq[pi * PART_UNITS * 4 + i];
  // p V: unit pu of the head dim, key slot ks
  const int pu = tid % UNITS, ks = tid / UNITS;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float m_run = -INFINITY, l_run = 0.f;     // warp 0's

  for (int i = 0; cur < t_end; ++i) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();              // tile i has landed; stage (i + 2) % 3 is free
    if (ahead < t_end)
      load_tile<D>(ring + ((i + 2) % STAGES) * 2 * TILE_ELEMS, kb, vb, k_ss, v_ss, ahead, S);
    hopper::cp_async_commit();
    const float* kt = ring + (i % STAGES) * 2 * TILE_ELEMS;
    const float* vt = kt + TILE_ELEMS;

    bool on0 = true, on1 = true;  // warp 0: are keys lane and lane + 32 attended
    if (warp == 0) {
      const int j0 = cur * TILE + lane, j1 = j0 + 32;
      on0 = j0 < S && (mb == nullptr || mb[j0] != 0);
      on1 = j1 < S && (mb == nullptr || mb[j1] != 0);
    }

    float s = 0.f;
    const float* krow = kt + kj * D;
#pragma unroll
    for (int c = 0; c < PART_UNITS; ++c) {
      const float4 f = *reinterpret_cast<const float4*>(
          krow + unit_at(kj, pi * PART_UNITS + c) * 4);
      s = fmaf(qr[4 * c], f.x, s);
      s = fmaf(qr[4 * c + 1], f.y, s);
      s = fmaf(qr[4 * c + 2], f.z, s);
      s = fmaf(qr[4 * c + 3], f.w, s);
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
      const float a = expf(m_run - m_new);          // 0 on the first tile
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      l_run = l_run * a + warp_sum(p0 + p1);
      m_run = m_new;
      ps[lane] = p0;
      ps[lane + 32] = p1;
      if (lane == 0) alpha_s = a;
    }
    __syncthreads();

    const float a = alpha_s;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] *= a;
#pragma unroll
    for (int r = 0; r < TILE / SLOTS; ++r) {
      const int j = ks + r * SLOTS;
      const float p = ps[j];
      const float4 f = *reinterpret_cast<const float4*>(vt + j * D + unit_at(j, pu) * 4);
      acc[0] = fmaf(p, f.x, acc[0]);
      acc[1] = fmaf(p, f.y, acc[1]);
      acc[2] = fmaf(p, f.z, acc[2]);
      acc[3] = fmaf(p, f.w, acc[3]);
    }
    cur = nxt;
    nxt = ahead;
    ahead = live.next(ahead + 1);
  }

  hopper::cp_async_wait<0>();
  __syncthreads();                // the ring is free: the key slots meet there
  float* slots = reinterpret_cast<float*>(smem);   // [SLOTS][D]
  *reinterpret_cast<float4*>(slots + ks * D + pu * 4) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
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
  auto store = [&](float x) {
    if (o_bf16)
      static_cast<__nv_bfloat16*>(o)[(size_t)b * o_sb + (size_t)h * o_sh + tid] =
          __float2bfloat16(x);
    else
      static_cast<float*>(o)[(size_t)b * o_sb + (size_t)h * o_sh + tid] = x;
  };
  if (nsplit == 1) {
    if (tid < D) {
      const float l = split_ml[1];
      store(l > 0.f ? od / l : 0.f);
    }
    return;
  }
  if (tid < D) split_o[tid] = od;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                 // every split's (m, l, o) is in place
  if (cluster.block_rank() == 0 && tid < D) {
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
      const float w = mr[r] == -INFINITY ? 0.f : expf(mr[r] - m_max);
      l = fmaf(lr[r], w, l);
      acc_o = fmaf(orr[r], w, acc_o);
    }
    store(l > 0.f ? acc_o / l : 0.f);
  }
  cluster.sync();                 // block 0 has read the others' shared memory
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, int o_bf16,
           int B, int H, int S, int q_sb, int q_sh, int k_sb, int k_sh, int k_ss, int v_sb,
           int v_sh, int v_ss, int o_sb, int o_sh, int mask_sb, int splits, float scale,
           cudaStream_t stream) {
  using Shape = DecodeF32<D>;
  static bool configured = false;           // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
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
      &cfg, decode_f32_kernel<D>, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask), o, o_bf16, S, q_sb, q_sh,
      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, mask_sb, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: f32 (B, H, 1, Dh); k, v: f32 (B, H, S, Dh), Dh 64, 96 or 128; o: (B, H,
// 1, Dh), bf16 when o_bf16 else f32. Each with element strides (sb, sh, ss)
// and the last dimension contiguous (the q/o sequence strides are unused);
// q and o on 4-byte lines, k and v rows on 16-byte lines. mask: (B, S)
// uint8 (nonzero = attend) with row stride mask_sb, or null for "all S keys
// visible". splits: blocks (one cluster) per (b, h), 1..8 and at most the
// 64-key tiles of S. Returns a cudaError_t.
extern "C" int decode_attention_f32(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    int B, int H, int S, int Dh, int q_sb, int q_sh, int q_ss, int k_sb,
    int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh,
    int o_ss, int mask_sb, int splits, float scale, int o_bf16, void* stream) {
  (void)q_ss;
  (void)o_ss;
  if (S < 1 || B < 1 || B > 65535 || H < 1 || H > 65535 || splits < 1 ||
      splits > MAX_SPLITS || splits > (S + TILE - 1) / TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_ARGS q, k, v, mask, o, o_bf16, B, H, S, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, \
    v_sh, v_ss, o_sb, o_sh, mask_sb, splits, scale, st
  switch (Dh) {
    case 64: return launch<64>(DECODE_ARGS);
    case 96: return launch<96>(DECODE_ARGS);
    case 128: return launch<128>(DECODE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);   // no instance takes it
  }
#undef DECODE_ARGS
}
