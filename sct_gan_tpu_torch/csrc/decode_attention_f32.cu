// Single-query (decode-step) attention for Hopper (sm_90a) over f32 KV
// caches: the f32 instance of K5 (decode_attention.cu is the bf16 one).
//
// Replaces the TPU kernel sct_gan_tpu/ops/decode_attention.py::_kernel (its
// pallas_call at line 83) where the caches are f32, as the JAX TASC decoder
// keeps them (sct_gan_tpu/variants/tasc.py:264-268, models/layers.py:299-308)
// and as f32 generation of ModelConfig(compute_dtype="float32") does:
//
//   o = softmax(q . K^T * scale, masked) V        q: (D,), K, V: (S, D) f32
//
// q comes in bf16 or f32 and is read as it is; o goes out in q's dtype (the
// JAX kernel's output dtype, line 74). All arithmetic is f32.
//
// Bound on an H100: bytes. Each attended key's K and V rows are read once
// (2 x 4 D bytes) for 4 D flops: half a flop a byte, so both products run
// on the CUDA cores. At (2, 8, 1024, 96) under a source mask of 1924 keys
// that is 11.8 MB, 3.5 us at 3.35 TB/s; at (64, 8, 1024, 96) every key
// attended, 403 MB, 0.12 ms.
//
// At B = 2 a step moves 11.8 MB, so its time is the HBM's (about 4 us of
// it) plus what the kernel does before the first byte is asked for and
// after the last one lands. The earlier kernel (the bf16 one's design on
// f32 rows) spent 15 us; its time in parts on the card (PERF.md §6):
// 6.6 us went to the split combine (two cluster barriers, the remote loads
// one at a time), 1 us to the mask read ahead of the first copy, the rest
// to three block barriers and a serial softmax on warp 0 per tile. This
// design:
//
// * Grid (splits, H, B), the splits of a (b, h) one thread block cluster of
//   up to 16 blocks (non-portable above 8). Split r takes the key tiles
//   [r T / splits, (r + 1) T / splits) of the T tiles (the wrapper's
//   decode_splits_f32 picks the count: a power of two, 8 at B = 2, 16
//   where 8 would leave a split more than 4 tiles; clusters whose size is
//   not a power of two measured slower). One split launches no cluster.
// * Warps own keys: warp w takes keys [w G, (w + 1) G) of every tile (G =
//   TK / 8), copies their K and V rows into its part of each ring stage,
//   waits on its own mbarrier and keeps its own online softmax (m, l, o;
//   base-2 exponents). No warp waits for another until the split's end:
//   no barrier per tile, no warp idle while another works.
// * Copies: rows that are contiguous (row stride = head dim: the self
//   caches cut to pos + 1 keys) go as one bulk copy (cp.async.bulk) per
//   warp and tile for each of K and V; strided rows (the cross K/V's head
//   views of (B, S, H * D)) as 16-byte cp.asyncs spread over the warp's
//   lanes, their completion made the mbarrier's arrivals
//   (cp.async.mbarrier.arrive.noinc). One bulk copy a row was measured
//   first: the copy engine takes ~40 clocks a request, 37% slower at B =
//   64 and 5% at B = 2 with 384-byte rows. No tensor map: the cache view
//   changes every step, and encoding a map on the host per call would add
//   host time to a host-bound loop. The rows keep their layout (row stride
//   D), so any head dim that is a multiple of 4 (whole 16-byte rows) runs
//   in place: a lane's columns past D take no part. No key past S is
//   copied.
// * The ring has as many stages as fit RING_BYTES (two blocks an SM; 3
//   stages for one block where a stage is larger, D = 97 to 128): at the
//   B = 2 step every live tile of a split is in flight before any compute
//   (at B = 64, where the HBM bounds it, a warp has one stage in flight
//   while it computes the other; 3 stages with one block an SM, the
//   stage refilled before its softmax, and L2 prefetches of the next rows
//   were each slower). A
//   warp reads its split's mask bytes first (one vote per 32 keys, up to
//   32 tiles at a time), requests its rows of the first tile at once, so
//   that no copy waits on the mask, then reads the votes and requests only
//   its rows that hold an attended key (its keys of a dead first tile are
//   copied and dropped).
// * Scores: lane l holds q's 16-byte units l, l + 32, ... (pre-scaled by
//   scale * log2 e) and dots them with the same units of the warp's G keys,
//   every load asked for before any product (conflict-free: a warp reads
//   consecutive units of one row); one reduce-scatter of G - 1 + 5 -
//   log2 G shuffles leaves each key's score on 32 / G lanes. p V: lane l sums
//   p_j V[j] over its units.
// * The combine (`finish`): the 8 warps meet once in shared memory (one
//   barrier; each warp's o in its own part of ring stage 0, which it has
//   read to the end) and are combined in warp order. Then each split stores its (m, l, o) into
//   block 0's shared memory (st.shared::cluster) and arrives on the cluster
//   barrier; only block 0 waits, and combines the splits in split order. A
//   relaxed cluster arrival at the start, waited for just before those
//   stores, makes sure every block of the cluster runs before any writes
//   into block 0. No atomics, no second kernel: two runs give the same
//   bits. With one split the block writes o itself.
// * Tiles shrink as the head dim grows, so that a stage stays at most 64
//   KB, and 48 KB (two blocks an SM) from D = 132 to 384: 64 keys up to
//   128 (32-key tiles at 128 were 16% slower at B = 64), 32 up to 192, 16
//   up to 512, 8 (one key a warp) up to 1024; instances <U, TK> with U
//   16-byte units a lane (D <= 128 U). Of the 8-key instances, <6, 8>
//   (127 registers) runs two blocks an SM on RING_BYTES as those below it
//   do (2 stages from 516 to 768: 3.6% faster at (64, 1, 1024, 768) than 3
//   stages at one block an SM, the same at B = 2), and <8, 8> (q, o and a
//   row are 96 registers a lane: 160 in all) one block an SM with as many
//   stages as shared memory holds beside the splits' partials: at D = 1024
//   and 16 splits, 2 stages of 64 KB and 64 KB of partials. Past 1024 the
//   column-chunk route at the end of this file.
// Budget at D = 96: a 48 KB stage (64 keys x 2 x 384 bytes), 2 stages and
// the splits' partials: ~99 KB; 256 threads.
//
// Semantics (the JAX kernel's): masked keys get -inf; a fully-masked row
// gives zeros; any S >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int NTHREADS = WARPS * 32;
constexpr int MAX_SPLITS = 16;               // a non-portable cluster
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 96 * 1024;        // two blocks an SM
constexpr int MAX_DYN_SMEM = 223 * 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int tile_keys(int d) {
  return d <= 128 ? 64 : d <= 192 ? 32 : d <= 512 ? 16 : 8;
}

// the bytes a stage of head dim d holds: K and V rows of one tile
__host__ __device__ constexpr int stage_bytes(int d) { return 2 * tile_keys(d) * d * 4; }

// raise the transaction count of the current phase without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(hopper::smem_u32(bar)), "r"(bytes) : "memory");
}

// cp.async's completion as one arrival on an mbarrier: the arrival this
// thread owes the phase (noinc), made once its earlier cp.asyncs land
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(hopper::smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w) : "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void axpy4(float p, float4 x, float4& acc) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

// q's 16-byte unit at element `at` (4 columns, bf16 or f32, on 4-byte lines),
// times qs
__device__ __forceinline__ float4 q_unit(const void* q, size_t at, int bf16, float qs) {
  float e4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    e4[e] = (bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at + e])
                  : static_cast<const float*>(q)[at + e]) * qs;
  return make_float4(e4[0], e4[1], e4[2], e4[3]);
}

// x[i] is this lane's part of key i's score. After log2 G halving steps
// (lanes with bit o set keep the upper half of the keys they still hold)
// and the plain sums over the remaining lane bits, every lane holds the
// whole score of key lane / (32 / G).
template <int G>
__device__ __forceinline__ float reduce_scatter(float (&x)[G], int lane) {
#pragma unroll
  for (int half = G / 2, o = 16; half >= 1; half /= 2, o /= 2) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? x[i] : x[i + half];
      const float keep = up ? x[i + half] : x[i];
      x[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  float s = x[0];
#pragma unroll
  for (int o = 16 / G; o >= 1; o /= 2) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// The walk over a split's live tiles (a tile is live when it holds an
// attended key), one warp's: lane i holds the key bits of tile win0 + i
// (bit j: key j of the tile is attended and below S), `live` which lanes'
// bits are not 0. Every lane of the warp runs it alike.
template <int TK>
struct Walk {
  const uint8_t* mask;     // the batch row's mask, or null: every key
  int t_end, S, lane;
  int win0;
  uint64_t wbits;
  uint32_t live;

  // the mask bytes of 256 keys from tile w0 (1 past S: the votes read
  // only the window's keys), asked for now, read later
  __device__ void request(int w0, uint32_t (&raw)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = w0 * TK + e * 32 + lane;
      raw[e] = mask != nullptr && j < S ? mask[j] : 1u;
    }
  }

  // the key bits of tiles [w0, w0 + 32) of the split; `first`, when given,
  // holds the bytes of its first 256 keys (`request`)
  __device__ void load_window(int w0, const uint32_t (*first)[8] = nullptr) {
    win0 = w0;
    const int keys = min(32, t_end - w0) * TK;
    wbits = 0;
    for (int c0 = 0; c0 < keys; c0 += 8 * 32) {
      uint32_t raw[8];
      if (c0 == 0 && first != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e) raw[e] = (*first)[e];
      } else {
        request(w0 + c0 / TK, raw);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = w0 * TK + c0 + e * 32 + lane;
        const uint64_t vote = __ballot_sync(FULL, c0 + e * 32 < keys && j < S && raw[e] != 0);
        const int c = (c0 + e * 32) / 32;            // 32-key chunk of the window
        if constexpr (TK >= 32) {
          if (lane == c / (TK / 32)) wbits |= vote << (32 * (c % (TK / 32)));
        } else {                                      // 32 / TK tiles a chunk
          constexpr int PER = 32 / TK;
#pragma unroll
          for (int i = 0; i < PER; ++i)
            if (lane == PER * c + i) wbits = (vote >> (TK * i)) & ((1ull << TK) - 1);
        }
      }
    }
    if (lane >= keys / TK) wbits = 0;   // a chunk's keys past the window
    live = __ballot_sync(FULL, wbits != 0);
  }

  // the first live tile at or after t (its key bits in `bits`), or t_end
  __device__ int next(int t, uint64_t& bits) {
    while (t < t_end) {
      if (t >= win0 + 32) load_window(t);
      const uint32_t rest = live >> (t - win0);
      if (rest) {
        t += __ffs(rest) - 1;
        bits = __shfl_sync(FULL, wbits, t - win0);
        return t;
      }
      t = win0 + 32;
    }
    return t_end;
  }
};

// Ends a split. The warps' (m, l, o) meet in shared memory, warp w's o at
// wo + w * wstride (`cols` columns, at most 4 a thread; l is this lane's
// part of the warp's sum), and are combined in warp order. With one split
// the block writes o (cols columns from ob, in q's dtype); else each split
// stores its (m, l, o) into block 0's shared memory (so, sm, sl) and
// arrives on the cluster barrier, and block 0 alone waits and combines the
// splits in split order. The caller made a relaxed cluster arrival at its
// start, which the wait here consumes: every block of the cluster runs
// before any writes into block 0.
template <int U>
__device__ __forceinline__ void finish(float m, float l, const float4 (&acc)[U], float* wo,
                                       int wstride, float* so, float* wm, float* wl, float* sm,
                                       float* sl, int cols, void* ob, int bf16) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int units = cols / 4;
#pragma unroll
  for (int x = 16; x >= 1; x /= 2) l += __shfl_xor_sync(FULL, l, x);
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = (lane + 32 * u) * 4;
    if (c < cols) *reinterpret_cast<float4*>(wo + warp * wstride + c) = acc[u];
  }
  __syncthreads();
  float M = -INFINITY, L = 0.f;
  float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < units) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = wm[w] == -INFINITY ? 0.f : exp2f(wm[w] - M);
      L = fmaf(wl[w], f, L);
      axpy4(f, *reinterpret_cast<const float4*>(wo + w * wstride + tid * 4), O);
    }
  }
  auto store = [&](float l_all, float4 x) {
    const float r = l_all > 0.f ? 1.f / l_all : 0.f;
    const float y[4] = {x.x * r, x.y * r, x.z * r, x.w * r};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (bf16)
        static_cast<__nv_bfloat16*>(ob)[tid * 4 + e] = __float2bfloat16(y[e]);
      else
        static_cast<float*>(ob)[tid * 4 + e] = y[e];
    }
  };
  if (nsplit == 1) {
    if (tid < units) store(L, O);
    return;
  }

  // ---- the splits meet in block 0: one cluster barrier -------------------
  hopper::cluster_wait();              // every block of the cluster runs
  if (tid < units) st_cluster(hopper::cluster_addr(so + split * cols + tid * 4, 0), O);
  if (tid == 0) {
    st_cluster(hopper::cluster_addr(&sm[split], 0), M);
    st_cluster(hopper::cluster_addr(&sl[split], 0), L);
  }
  hopper::cluster_arrive();
  if (split != 0) return;
  hopper::cluster_wait();
  if (tid < units) {
    float mm = -INFINITY;
    for (int r = 0; r < nsplit; ++r) mm = fmaxf(mm, sm[r]);
    float l_all = 0.f;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < nsplit; ++r) {         // in split order
      const float f = sm[r] == -INFINITY ? 0.f : exp2f(sm[r] - mm);
      l_all = fmaf(sl[r], f, l_all);
      axpy4(f, *reinterpret_cast<const float4*>(so + r * cols + tid * 4), x);
    }
    store(l_all, x);
  }
}

template <int U, int TK>
__global__ void __launch_bounds__(NTHREADS, U <= 6 ? 2 : 1)
decode_f32_kernel(const void* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const uint8_t* __restrict__ mask,
                  void* __restrict__ o, int bf16, int S, int D, int q_sb, int q_sh,
                  int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
                  int o_sh, int mask_sb, int stages, float scale) {
  constexpr int G = TK / WARPS;                // keys of a tile a warp takes
  constexpr int LPK = 32 / G;                  // lanes that share a key
  static_assert(G >= 1 && G <= 8, "a warp's key bits of a tile fit 8 bits");
  extern __shared__ __align__(128) uint8_t smem[];
  const int tile_elems = TK * D;
  float* ring = reinterpret_cast<float*>(smem);      // [stages][K, V][TK][D]
  float* so = ring + stages * 2 * tile_elems;        // [splits][D], block 0's
  __shared__ __align__(8) uint64_t full[MAX_STAGES][WARPS];
  __shared__ float wm[WARPS], wl[WARPS], sm[MAX_SPLITS], sl[MAX_SPLITS];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const float* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;
  const int tiles = (S + TK - 1) / TK;
  const int t_begin = static_cast<int>((long long)split * tiles / nsplit);
  const int t_end = static_cast<int>((long long)(split + 1) * tiles / nsplit);
  // contiguous rows go as bulk copies (lane 0), strided ones as the lanes'
  // 16-byte cp.asyncs, each lane then owing each fill one arrival
  const bool k_bulk = k_ss == D, v_bulk = v_ss == D;
  const bool spread = !(k_bulk && v_bulk);

  if (nsplit > 1) cluster_arrive_relaxed();   // waited for before the combine
  if (lane == 0) {                     // this warp's barriers, its own
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&full[s][warp], spread ? 32 : 1);
    hopper::fence_barrier_init();
  }
  __syncwarp();

  // fill f of the ring: this warp's K and V rows of tile t whose key bits
  // (g) are set, none past S; an arrival either way
  auto fill = [&](int f, int t, uint32_t g) {
    const int s = f % stages;
    const int row0 = t * TK + warp * G;
    const int rows = g == 0 ? 0 : max(0, min(G, S - row0));
    const uint32_t bytes = rows * D * 4;
    float* kd = ring + s * 2 * tile_elems + warp * G * D;
    float* vd = kd + tile_elems;
    const float* ks = kb + (size_t)row0 * k_ss;
    const float* vs = vb + (size_t)row0 * v_ss;
    uint64_t* bar = &full[s][warp];
    if (lane == 0) {
      const uint32_t tx = (k_bulk + v_bulk) * bytes;
      if (spread)
        mbar_expect_tx(bar, tx);
      else
        hopper::mbar_arrive_expect_tx(bar, tx);
      if (k_bulk && bytes) hopper::bulk_load(kd, ks, bytes, bar);
      if (v_bulk && bytes) hopper::bulk_load(vd, vs, bytes, bar);
    }
    if (spread) {
      for (int r = 0; r < rows; ++r) {
        for (int at = lane * 4; at < D; at += 128) {
          if (!k_bulk) hopper::cp_async_16(kd + r * D + at, ks + (size_t)r * k_ss + at, true);
          if (!v_bulk) hopper::cp_async_16(vd + r * D + at, vs + (size_t)r * v_ss + at, true);
        }
      }
      cp_async_mbar_arrive(bar);
    }
  };

  // the mask bytes first, the first tile's rows blind, then the votes
  Walk<TK> walk{mb, t_end, S, lane, 0, 0u, 0u};
  uint32_t first[8];
  walk.request(t_begin, first);
  fill(0, t_begin, ~0u);
  walk.load_window(t_begin, &first);

  // ---- q: this lane's units, pre-scaled for base-2 exponents ------------
  float4 qr[U];
  int col[U];                          // this lane's columns (past D: 0)
  const float qs = scale * LOG2E;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = (lane + 32 * u) * 4;
    col[u] = c < D ? c : 0;
    qr[u] = c < D ? q_unit(q, (size_t)b * q_sb + (size_t)h * q_sh + c, bf16, qs)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // ---- this warp's rows of the next live tiles, ahead of its compute ----
  Walk<TK> ahead = walk;               // the fills' walk
  uint64_t bits = __shfl_sync(FULL, walk.wbits, 0), abits = 0;   // tile t_begin's
  const uint32_t gmask = (1u << G) - 1;
  int cur = t_begin, last = t_begin, fills = 1;
  for (; fills < stages; ++fills) {
    last = ahead.next(last + 1, abits);
    if (last >= t_end) break;
    fill(fills, last, static_cast<uint32_t>(abits >> (warp * G)) & gmask);
  }

  // ---- this warp's keys of each tile, its own online softmax ------------
  float m = -INFINITY, l = 0.f;
  float4 acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0, phase = 0; cur < t_end;) {
    hopper::mbar_wait(&full[s][warp], phase);
    const uint32_t g = static_cast<uint32_t>(bits >> (warp * G)) & gmask;
    if (g != 0) {
      // every load first (a lane past D reads its row's first unit, a key
      // past S a row never copied: neither reaches a live key's sum)
      const float* kt = ring + s * 2 * tile_elems + warp * G * D;
      const float* vt = kt + tile_elems;
      float4 x[G][U];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u) x[j][u] = *reinterpret_cast<const float4*>(kt + j * D + col[u]);
      float part[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        part[j] = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) part[j] = dot4(qr[u], x[j][u], part[j]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u) x[j][u] = *reinterpret_cast<const float4*>(vt + j * D + col[u]);
      const float sc_all = reduce_scatter<G>(part, lane);
      const bool on = (g >> (lane / LPK)) & 1;
      const float sc = on ? sc_all : -INFINITY;
      float mt = sc;
#pragma unroll
      for (int sh = 16; sh >= LPK; sh /= 2) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, sh));
      const float m_new = fmaxf(m, mt);          // finite: a key is attended
      const float alpha = hopper::fast_exp2(m - m_new);   // 0 while m is -inf
      const float p = on ? hopper::fast_exp2(sc - m_new) : 0.f;
      l = fmaf(l, alpha, lane % LPK == 0 ? p : 0.f);
      m = m_new;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[u].x *= alpha;
        acc[u].y *= alpha;
        acc[u].z *= alpha;
        acc[u].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float pj = __shfl_sync(FULL, p, j * LPK);
        if ((g >> j) & 1) {                      // a dead key's row may be junk
#pragma unroll
          for (int u = 0; u < U; ++u) axpy4(pj, x[j][u], acc[u]);
        }
      }
    }
    __syncwarp();                      // every lane has read the stage
    if (last < t_end) {                // refill it with this warp's next rows
      last = ahead.next(last + 1, abits);
      if (last < t_end) fill(fills++, last, static_cast<uint32_t>(abits >> (warp * G)) & gmask);
    }
    cur = walk.next(cur + 1, bits);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }

  // ---- the warps meet, then the splits; each warp's o goes into its own
  // part of stage 0 (every fill it asked for has landed and been read) --
  __syncwarp();
  void* ob = bf16 ? static_cast<void*>(static_cast<__nv_bfloat16*>(o) + (size_t)b * o_sb +
                                       (size_t)h * o_sh)
                  : static_cast<void*>(static_cast<float*>(o) + (size_t)b * o_sb +
                                       (size_t)h * o_sh);
  finish<U>(m, l, acc, ring, G * D, so, wm, wl, sm, sl, D, ob, bf16);
}

template <int U, int TK>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, int bf16,
           int B, int H, int S, int D, int q_sb, int q_sh, int k_sb, int k_sh, int k_ss,
           int v_sb, int v_sh, int v_ss, int o_sb, int o_sh, int mask_sb, int splits,
           float scale, cudaStream_t stream) {
  static bool configured = false;           // above 48 KB and 8 blocks: opt-ins
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_f32_kernel<U, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_f32_kernel<U, TK>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  // two blocks an SM (U <= 6): RING_BYTES where two stages fit it, else a
  // ring of 3 stages for one block; one block an SM (U = 8): as many
  // stages as fit. Never past the shared memory the splits' partials leave
  const int extra = splits * D * 4, sb = stage_bytes(D);
  int stages = U > 6 ? MAX_STAGES : RING_BYTES / sb >= 2 ? RING_BYTES / sb : 3;
  stages = min(min(stages, MAX_STAGES), (MAX_DYN_SMEM - extra) / sb);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = stages * sb + extra;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;           // one split: no cluster
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_f32_kernel<U, TK>, q, static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask), o, bf16, S, D, q_sb,
      q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, mask_sb, stages, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- past D = 1024: the column-chunk route ---------------------------------
//
// Past 1024 a stage of 8 whole K and V rows (64 D bytes) leaves no room for
// two stages and the splits' partials. This route cuts o's head dim into
// chunks of WIDE_COLS columns: grid (splits, H, B x nchunk), one cluster of
// `splits` blocks per (b, h, chunk c). The splits and the warps' keys are
// the 8-key instances' (warp w takes key w of each 8-key tile of its
// split), and so is the arithmetic: each warp computes its key's score
// over the whole row (q and K read from global memory, WIDE_COLS columns a
// pass, a lane's units of a pass loaded before any product), keeps its own
// online softmax and accumulates V's chunk c only; `finish` combines the
// warps and the splits. A masked key's rows are never read. No ring: a warp
// has one key's rows in flight. Each K row is read once per chunk (nchunk
// times in all, all but the first likely from L2), V once: right and
// simple, not fast. Shared memory: the warps' and splits' partials, 96 KB
// at 16 splits, so two blocks fit an SM.
constexpr int WIDE_COLS = 1024;
constexpr int WIDE_U = WIDE_COLS / 128;      // 16-byte units a lane of a chunk
constexpr int WIDE_TK = 8;

__global__ void __launch_bounds__(NTHREADS, 2)
decode_f32_wide_kernel(const void* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ mask,
                       void* __restrict__ o, int bf16, int S, int D, int nchunk, int q_sb,
                       int q_sh, int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
                       int o_sb, int o_sh, int mask_sb, float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* wo = reinterpret_cast<float*>(smem);        // [WARPS][WIDE_COLS]
  float* so = wo + WARPS * WIDE_COLS;                 // [splits][cols], block 0's
  __shared__ float wm[WARPS], wl[WARPS], sm[MAX_SPLITS], sl[MAX_SPLITS];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z / nchunk, c = blockIdx.z % nchunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = c * WIDE_COLS, cols = min(WIDE_COLS, D - c0);
  const size_t q_at = (size_t)b * q_sb + (size_t)h * q_sh;
  const float* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const float* vb = v + (size_t)b * v_sb + (size_t)h * v_sh + c0;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;
  const int tiles = (S + WIDE_TK - 1) / WIDE_TK;
  const int t_begin = static_cast<int>((long long)split * tiles / nsplit);
  const int t_end = static_cast<int>((long long)(split + 1) * tiles / nsplit);
  if (nsplit > 1) cluster_arrive_relaxed();   // waited for in finish
  const float qs = scale * LOG2E;

  float m = -INFINITY, l = 0.f;
  float4 acc[WIDE_U];
#pragma unroll
  for (int u = 0; u < WIDE_U; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = t_begin; t < t_end; ++t) {
    const int j = t * WIDE_TK + warp;          // this warp's key of the tile
    if (j >= S || (mb != nullptr && mb[j] == 0)) continue;
    const float* kr = kb + (size_t)j * k_ss;
    float sc = 0.f;
    for (int p0 = 0; p0 < D; p0 += WIDE_COLS) {
      float4 x[WIDE_U];
#pragma unroll
      for (int u = 0; u < WIDE_U; ++u) {
        const int at = p0 + (lane + 32 * u) * 4;
        x[u] = at < D ? __ldg(reinterpret_cast<const float4*>(kr + at))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < WIDE_U; ++u) {
        const int at = p0 + (lane + 32 * u) * 4;
        if (at < D) sc = dot4(q_unit(q, q_at + at, bf16, qs), x[u], sc);
      }
    }
#pragma unroll
    for (int x = 16; x >= 1; x /= 2) sc += __shfl_xor_sync(FULL, sc, x);   // every lane's
    const float m_new = fmaxf(m, sc);
    const float alpha = hopper::fast_exp2(m - m_new);   // 0 while m is -inf
    const float p = hopper::fast_exp2(sc - m_new);
    l = fmaf(l, alpha, p);
    m = m_new;
    const float* vr = vb + (size_t)j * v_ss;
#pragma unroll
    for (int u = 0; u < WIDE_U; ++u) {
      const int at = (lane + 32 * u) * 4;
      if (at < cols) {
        const float4 y = __ldg(reinterpret_cast<const float4*>(vr + at));
        acc[u].x *= alpha;
        acc[u].y *= alpha;
        acc[u].z *= alpha;
        acc[u].w *= alpha;
        axpy4(p, y, acc[u]);
      }
    }
  }
  void* ob = bf16 ? static_cast<void*>(static_cast<__nv_bfloat16*>(o) + (size_t)b * o_sb +
                                       (size_t)h * o_sh + c0)
                  : static_cast<void*>(static_cast<float*>(o) + (size_t)b * o_sb +
                                       (size_t)h * o_sh + c0);
  // every lane holds l: lane 0 gives it to the warp's sum
  finish<WIDE_U>(m, lane == 0 ? l : 0.f, acc, wo, WIDE_COLS, so, wm, wl, sm, sl, cols, ob,
                 bf16);
}

int launch_wide(const void* q, const void* k, const void* v, const void* mask, void* o,
                int bf16, int B, int H, int S, int D, int q_sb, int q_sh, int k_sb, int k_sh,
                int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh, int mask_sb,
                int splits, float scale, cudaStream_t stream) {
  const int nchunk = (D + WIDE_COLS - 1) / WIDE_COLS;
  if ((long long)B * nchunk > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = (WARPS + MAX_SPLITS) * WIDE_COLS * 4;
  static bool configured = false;           // above 48 KB and 8 blocks: opt-ins
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_f32_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_f32_wide_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H, B * nchunk);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = (WARPS + splits) * WIDE_COLS * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;           // one split: no cluster
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_f32_wide_kernel, q, static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask), o, bf16, S, D, nchunk,
      q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, mask_sb, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, H, 1, Dh) bf16 when bf16 else f32; k, v: f32 (B, H, S, Dh), Dh any
// multiple of 4 (up to 1024 on an instance, above on the column-chunk route,
// B x ceil(Dh / 1024) at most 65535); o: (B, H, 1, Dh) in q's dtype. Each
// with element strides (sb, sh, ss) and the last dimension contiguous (the
// q/o sequence strides are unused); q and o on 4-byte lines, k and v rows
// on 16-byte lines. mask: (B, S) uint8 (nonzero = attend) with row stride
// mask_sb, or null for "all S keys visible". splits: blocks (one cluster)
// per (b, h, column chunk), 1..16 and at most the tiles of S (64 keys up
// to Dh = 128, 32 up to 192, 16 up to 512, 8 above). Returns a
// cudaError_t.
extern "C" int decode_attention_f32(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    int B, int H, int S, int Dh, int q_sb, int q_sh, int q_ss, int k_sb,
    int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh,
    int o_ss, int mask_sb, int splits, float scale, int bf16, void* stream) {
  (void)q_ss;
  (void)o_ss;
  if (S < 1 || B < 1 || B > 65535 || H < 1 || H > 65535 || Dh < 4 || Dh % 4 != 0 ||
      splits < 1 || splits > MAX_SPLITS || splits > (S + tile_keys(Dh) - 1) / tile_keys(Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_ARGS q, k, v, mask, o, bf16, B, H, S, Dh, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, \
    v_sh, v_ss, o_sb, o_sh, mask_sb, splits, scale, st
  if (Dh <= 128) return launch<1, 64>(DECODE_ARGS);
  if (Dh <= 192) return launch<2, 32>(DECODE_ARGS);
  if (Dh <= 256) return launch<2, 16>(DECODE_ARGS);
  if (Dh <= 384) return launch<3, 16>(DECODE_ARGS);
  if (Dh <= 512) return launch<4, 16>(DECODE_ARGS);
  if (Dh <= 768) return launch<6, 8>(DECODE_ARGS);
  if (Dh <= 1024) return launch<8, 8>(DECODE_ARGS);
  return launch_wide(DECODE_ARGS);                 // the column-chunk route
#undef DECODE_ARGS
}
