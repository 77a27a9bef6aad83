// Blocking variants of the single-query decode attention for Hopper (sm_90a),
// bf16 in and out.
//
// Replaces the TPU kernels of tools/time_decode_kernel_variants.py (its
// pallas_calls at :77, v2, and :113, v3), which asked whether fewer and
// larger programs read the K/V cache faster than one program per (b, h).
// Both keep the TPU's blocking, one block per batch row (grid (B,)):
//
//   v2  the block walks the H heads one after the other, each head's K
//       then its V, read through the cache's (b, h, s) strides;
//   v3  the block reads K and V as the batch row's one (H*S, D) slab, in
//       linear chunks that do not follow the heads.
//
// (v1, one block per (b, h), is K5 itself: decode_attention.cu.)
//
// What bounds it on an H100: the bytes of K and V, each attended row read
// once: 90.6 MB at B = 32, H = 8, S = 1024, D = 96 under the tool's mask
// (about 10% of keys off), 0.027 ms at 3.35 TB/s. Both variants launch B
// blocks, 32 at B = 32, so 32 of the 132 SMs must pull it all: about 2.8
// MB a block, 105 GB/s an SM near the bound. A decode step does about one
// flop a byte, so both products run on the CUDA cores. The earlier design
// lost 20x to this bound through a latency chain: one 192-byte K row in
// flight a warp, three passes a head with block barriers between them.
// This one keeps the bytes in flight:
//
// * A producer warp streams the block's rows into a ring of STAGES stages
//   of ROWS = 128 rows (16, 24 or 32 KB at D = 64, 96, 128; 8, 7 and 5
//   stages, over 130 KB in flight) on mbarriers; eight consumer warps
//   compute. The producer runs ahead across head boundaries.
//   - v2: a stage is two 64-key tiles of one head's K (or V), each one 2-D
//     TMA box of 64 rows x D through the strides (make_rows_map): head h's
//     K tiles, then its V tiles, then head h + 1's. Tiles whose mask bytes
//     are all zero are never loaded (the live-tile list is built once per
//     block from the mask bits, the same for every head).
//   - v3: a stage is one linear chunk of 128 slab rows (16-32 KB), one
//     cp.async.bulk. Chunks straddle heads (at S = 300 a chunk holds the
//     end of one head and the start of the next); the consumers split
//     each chunk's rows by head. The V chunk of a row comes after the K
//     chunk that completes the row's head: K chunk k, then every V chunk
//     whose last head ends in K chunk k.
// * The softmax keeps the TPU's form: a head's scores go to a row in shared
//   memory (a ring of 8192 f32, indexed by key in v2 and by slab row in
//   v3), the head's max and sum are taken once all its scores are in (three
//   consumer barriers a head), and its V rows weigh p / l rounded to bf16,
//   as the plain version rounds it. Nothing is rescaled.
// * Work split: a row is LPR lanes (4 at D = 96, 8 at 64 and 128), each
//   lane UPL 16-byte units of it (units part, part + LPR, ...), so a
//   quarter warp reads eight distinct bank groups; a score's LPR partial
//   dots meet by shuffles. For p V each lane keeps UPL x 8 f32 sums over
//   its rows; at the end of a head they meet by shuffles and in shared
//   memory, and the head's row of o is written.
// * The consumers are bound by latency, not by the load pipe: on an NVIDIA
//   H100 80GB HBM3 at 700 W the producer alone (consumers releasing each
//   stage unread) pulls 66 GB/s a block, the whole kernel 41 (v2). So a
//   thread runs two passes of rows at a time with their loads issued
//   first, four FMA chains a dot, q of the next head fetched a head ahead,
//   and v3 follows the heads without dividing; sixteen consumer warps and
//   a ring of four stages timed the same or slower (PERF.md §6 PR 18).
//
// Limits: v2 up to 8192 keys (the score ring), v3 up to 4096 keys (the
// ring holds a head and the rows in flight behind it). Head dims 64, 96 and
// 128. v2 reads K and V through a TMA map (16-byte strides), v3 needs the
// slab dense (row stride D); the wrapper copies what is not.
//
// Semantics (K5's): o = softmax(q . K^T * scale, masked) V; masked keys
// weigh nothing; a fully-masked row gives zeros; q is scaled in f32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_tile.cuh"

namespace {

using namespace hopper;

constexpr int SMEM_LIMIT = 232448;     // bytes of shared memory a block may use
constexpr int TILE = 64;               // keys a tile: v2's skip unit
constexpr int ROWS = 128;              // rows a ring stage
constexpr int NCW = 8;                 // consumer warps
constexpr int NC = NCW * 32;
constexpr int NTHREADS = NC + 32;      // and the producer warp
constexpr int RING = 8192;             // f32 scores (a power of two)
constexpr int NSTAT = 512;             // heads' 1 / l (a power of two)
constexpr int MAX_KEYS = 8192;         // v2: one head's scores
constexpr int MAX_SLAB_KEYS = 4096;    // v3: a head and the rows in flight
constexpr int MAX_TILES = MAX_KEYS / TILE;
constexpr int CONSUMERS = 1;           // named barrier of the consumer warps
constexpr float LOG2E = 1.4426950408889634f;

// What a ring stage holds, written by the producer before the stage's
// arrival releases it.
struct Item {
  int kind;        // 0: K rows, 1: V rows
  int head;        // v2: the head
  int row0, n;     // v3: the chunk's first slab row and its rows
  int tile[2];     // v2: the 64-key tiles of stage rows 0-63, 64-127 (-1: none)
  int last;        // v2: the head's last stage of this kind
};

// The shared memory besides the ring.
template <int D>
struct Fixed {
  float ring[RING];                 // scores, then p = 2^(s - m)
  float inv_l[NSTAT];               // 1 / l of head h at h % NSTAT
  float part[2][NCW][D];            // a head's o, one row a warp
  uint32_t mbits[MAX_KEYS / 32];    // bit j: key j is attended
  int live[MAX_TILES];              // v2: the live tiles, in order
  float red[2][NCW];
  int n_live;
};

template <int D_>
struct Shape {
  static constexpr int D = D_;
  static constexpr int UNITS = D / 8;              // 16-byte units a row
  static constexpr int LPR = D == 96 ? 4 : 8;      // lanes a row
  static constexpr int UPL = UNITS / LPR;          // units a lane: 1, 3, 2
  static constexpr int RPW = 32 / LPR;             // rows a warp a pass
  static constexpr int RPP = RPW * NCW;            // rows a pass
  static constexpr int STAGE_BYTES = ROWS * D * 2;
  static constexpr int FREE = SMEM_LIMIT - 1024 - (int)sizeof(Fixed<D>) - 512;
  static constexpr int STAGES = FREE / STAGE_BYTES < 8 ? FREE / STAGE_BYTES : 8;
  static_assert(UPL * LPR == UNITS, "whole units a lane");
  static_assert(STAGES >= 4, "a ring of four stages at least");
  // v3: a fast warp writes scores at most STAGES items ahead of a slow one
  static_assert((STAGES + 2) * ROWS + MAX_SLAB_KEYS <= RING, "the score ring");
};

template <class C>
struct Smem {
  alignas(1024) unsigned char stage[C::STAGES][C::STAGE_BYTES];
  Fixed<C::D> f;
  Item item[C::STAGES];
  uint64_t full[C::STAGES], empty[C::STAGES];
};

struct DecArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;           // v3: the slabs
  const __nv_bfloat16* v;
  const uint8_t* mask;              // (B, S), nonzero = attend, or null
  __nv_bfloat16* o;
  int H, S, q_sb, q_sh, k_sb, v_sb, o_sb, o_sh, mask_sb;
  float scale_log2;
};

template <class T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
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

// the two bf16 of a word as f32
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ bool attended(const uint32_t* mbits, int j) {
  return (mbits[j >> 5] >> (j & 31)) & 1u;
}

// A consumer thread: its lanes' row within a pass and its part of the row.
template <class C>
struct Lane {
  int part, grp;                    // units part + LPR * c; row grp of a pass
  __device__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    part = lane % C::LPR;
    grp = warp * C::RPW + lane / C::LPR;
  }
};

// this thread's units of q for head h, as bf16 pairs: issued a head ahead,
// so the load's latency hides under the head before
template <class C>
__device__ __forceinline__ void fetch_q(uint32_t (&qw)[C::UPL * 4], const DecArgs& a, int b,
                                        int h, int part) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      a.q + (size_t)b * a.q_sb + (size_t)h * a.q_sh);
#pragma unroll
  for (int c = 0; c < C::UPL; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) qw[c * 4 + e] = src[(part + C::LPR * c) * 4 + e];
}

// the next head's q, scaled in f32, and the fetch of the one after
template <class C>
__device__ __forceinline__ void next_q(float (&qr)[C::UPL * 8], uint32_t (&qw)[C::UPL * 4],
                                       const DecArgs& a, int b, int h, int part) {
#pragma unroll
  for (int e = 0; e < C::UPL * 4; ++e) {
    qr[2 * e] = lo_f(qw[e]) * a.scale_log2;
    qr[2 * e + 1] = hi_f(qw[e]) * a.scale_log2;
  }
  if (h + 1 < a.H) fetch_q<C>(qw, a, b, h + 1, part);
}

// Scores of n stage rows from `first`: row i goes to ring[pos(i)] (pos < 0:
// no score). Every consumer thread calls it with the same n. Two passes at
// a time, their loads first: eight independent chains a thread.
template <class C, class Pos>
__device__ __forceinline__ void score_rows(const unsigned char* stage, int first, int n,
                                           const float (&qr)[C::UPL * 8], float* ring,
                                           const Lane<C>& ln, Pos pos) {
  const uint4* rows = reinterpret_cast<const uint4*>(stage);
  for (int p0 = 0; p0 < n; p0 += 2 * C::RPP) {
    int i[2];
    uint4 u[2][C::UPL];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      i[k] = p0 + k * C::RPP + ln.grp;
      const uint4* row = rows + (size_t)(first + (i[k] < n ? i[k] : 0)) * C::UNITS;
#pragma unroll
      for (int c = 0; c < C::UPL; ++c) u[k][c] = row[ln.part + C::LPR * c];
    }
    float s[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < C::UPL; ++c) {
        const uint32_t w[4] = {u[k][c].x, u[k][c].y, u[k][c].z, u[k][c].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sp[(e & 1) * 2] = fmaf(qr[c * 8 + 2 * e], lo_f(w[e]), sp[(e & 1) * 2]);
          sp[(e & 1) * 2 + 1] = fmaf(qr[c * 8 + 2 * e + 1], hi_f(w[e]), sp[(e & 1) * 2 + 1]);
        }
      }
      s[k] = (sp[0] + sp[1]) + (sp[2] + sp[3]);
    }
#pragma unroll
    for (int o = 1; o < C::LPR; o <<= 1)
#pragma unroll
      for (int k = 0; k < 2; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
    if (ln.part == 0)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int at = i[k] < n ? pos(i[k]) : -1;
        if (at >= 0) ring[at] = s[k];
      }
  }
}

// acc += (p / l rounded to bf16) * V over n stage rows from `first`; row i's
// p at ring[pos(i)] (pos < 0: the row weighs nothing). Two passes at a
// time, their loads first.
template <class C, class Pos>
__device__ __forceinline__ void pv_rows(const unsigned char* stage, int first, int n,
                                        float inv, const float* ring,
                                        float (&acc)[C::UPL * 8], const Lane<C>& ln, Pos pos) {
  const uint4* rows = reinterpret_cast<const uint4*>(stage);
  for (int p0 = 0; p0 < n; p0 += 2 * C::RPP) {
    float w[2];
    uint4 u[2][C::UPL];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = p0 + k * C::RPP + ln.grp;
      const int at = i < n ? pos(i) : -1;
      w[k] = at >= 0 ? __bfloat162float(__float2bfloat16(ring[at] * inv)) : 0.f;
      const uint4* row = rows + (size_t)(first + (at >= 0 ? i : 0)) * C::UNITS;
#pragma unroll
      for (int c = 0; c < C::UPL; ++c) u[k][c] = row[ln.part + C::LPR * c];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < C::UPL; ++c) {
        const uint32_t x[4] = {u[k][c].x, u[k][c].y, u[k][c].z, u[k][c].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[c * 8 + 2 * e] = fmaf(w[k], lo_f(x[e]), acc[c * 8 + 2 * e]);
          acc[c * 8 + 2 * e + 1] = fmaf(w[k], hi_f(x[e]), acc[c * 8 + 2 * e + 1]);
        }
      }
  }
}

// Head h's scores are all in the ring, key j at (base + j) % RING: its max m
// and p = 2^(s - m) (0 for a masked key) in place, and 1 / l (0 when every
// key is masked) at inv_l[h % NSTAT]. All consumer threads; three barriers.
template <int D>
__device__ __forceinline__ void head_stats(Fixed<D>& f, int h, int base, int S) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bar_sync(CONSUMERS, NC);          // every score of the head is written
  float mx = -INFINITY;
  for (int j = tid; j < S; j += NC)
    if (attended(f.mbits, j)) mx = fmaxf(mx, f.ring[(base + j) & (RING - 1)]);
  mx = warp_max(mx);
  if (lane == 0) f.red[0][warp] = mx;
  bar_sync(CONSUMERS, NC);
  float m = f.red[0][0];
#pragma unroll
  for (int w = 1; w < NCW; ++w) m = fmaxf(m, f.red[0][w]);
  const float mb = m == -INFINITY ? 0.f : m;      // fully masked: every p is 0
  float sum = 0.f;
  for (int j = tid; j < S; j += NC) {
    const int at = (base + j) & (RING - 1);
    const float p = attended(f.mbits, j) ? exp2f(f.ring[at] - mb) : 0.f;
    f.ring[at] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  if (lane == 0) f.red[1][warp] = sum;
  bar_sync(CONSUMERS, NC);
  if (tid == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) l += f.red[1][w];
    f.inv_l[h & (NSTAT - 1)] = l > 0.f ? 1.f / l : 0.f;
  }
  bar_sync(CONSUMERS, NC);          // p and 1 / l are in place
}

// Head h's V rows are all in acc: the threads' sums meet (shuffles over the
// lanes of one part, then one row a warp in shared memory) and row h of o
// is written; acc is zeroed for the next head. One barrier.
template <class C>
__device__ __forceinline__ void head_output(Fixed<C::D>& f, float (&acc)[C::UPL * 8],
                                            const DecArgs& a, int b, int h, const Lane<C>& ln) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int o = C::LPR; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < C::UPL * 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  float (*part)[C::D] = f.part[h & 1];
  if (lane < C::LPR) {
#pragma unroll
    for (int c = 0; c < C::UPL; ++c) {
      float4* dst = reinterpret_cast<float4*>(&part[warp][(ln.part + C::LPR * c) * 8]);
      dst[0] = make_float4(acc[c * 8], acc[c * 8 + 1], acc[c * 8 + 2], acc[c * 8 + 3]);
      dst[1] = make_float4(acc[c * 8 + 4], acc[c * 8 + 5], acc[c * 8 + 6], acc[c * 8 + 7]);
    }
  }
#pragma unroll
  for (int e = 0; e < C::UPL * 8; ++e) acc[e] = 0.f;
  bar_sync(CONSUMERS, NC);
  if (tid < C::D / 2) {
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      x0 += part[w][2 * tid];
      x1 += part[w][2 * tid + 1];
    }
    reinterpret_cast<__nv_bfloat162*>(a.o + (size_t)b * a.o_sb + (size_t)h * a.o_sh)[tid] =
        __floats2bfloat162_rn(x0, x1);
  }
}

// The producer warp's lane 0: wait for stage st of item i to be free.
template <class C>
__device__ __forceinline__ int claim(Smem<C>& s, int i) {
  const int st = i % C::STAGES;
  mbar_wait(&s.empty[st], ((i / C::STAGES) & 1) ^ 1);
  return st;
}

// v2's producer: for each head, its live K tiles two a stage, then its V
// tiles; each tile one TMA box of 64 rows x D (rows past S are zeros).
template <class C>
__device__ __forceinline__ void produce_v2(Smem<C>& s, const CUtensorMap* k_map,
                                           const CUtensorMap* v_map, int b, int H) {
  const int n_live = s.f.n_live, np = (n_live + 1) / 2;
  constexpr uint32_t TILE_BYTES = TILE * C::D * 2;
  int i = 0;
  for (int h = 0; h < H; ++h)
    for (int kind = 0; kind < 2; ++kind)
      for (int p = 0; p < np; ++p, ++i) {
        const int st = claim(s, i);
        const int t0 = s.f.live[2 * p], t1 = 2 * p + 1 < n_live ? s.f.live[2 * p + 1] : -1;
        Item& it = s.item[st];
        it.kind = kind;
        it.head = h;
        it.tile[0] = t0;
        it.tile[1] = t1;
        it.last = p == np - 1;
        mbar_arrive_expect_tx(&s.full[st], (t1 >= 0 ? 2 : 1) * TILE_BYTES);
        const CUtensorMap* map = kind == 0 ? k_map : v_map;
        tma_load_4d(s.stage[st], map, &s.full[st], 0, t0 * TILE, h, b);
        if (t1 >= 0) tma_load_4d(s.stage[st] + TILE_BYTES, map, &s.full[st], 0, t1 * TILE, h, b);
      }
}

// v3: the last K chunk that a V chunk waits for (its last head's end)
__device__ __forceinline__ int k_need(int c, int S, int total) {
  const int last = min(total, (c + 1) * ROWS) - 1;
  return (((last / S) + 1) * S - 1) / ROWS;
}

// v3's producer: the slab in chunks of ROWS rows, one bulk copy each; K
// chunk k, then every V chunk whose last head ends in it.
template <class C>
__device__ __forceinline__ void produce_v3(Smem<C>& s, const DecArgs& a, int b) {
  const int total = a.H * a.S, nch = (total + ROWS - 1) / ROWS;
  const __nv_bfloat16* kb = a.k + (size_t)b * a.k_sb;
  const __nv_bfloat16* vb = a.v + (size_t)b * a.v_sb;
  int i = 0, kv = 0;
  auto issue = [&](int kind, int c) {
    const int st = claim(s, i++);
    const int row0 = c * ROWS, n = min(ROWS, total - row0);
    Item& it = s.item[st];
    it.kind = kind;
    it.row0 = row0;
    it.n = n;
    const uint32_t bytes = (uint32_t)n * C::D * 2;
    mbar_arrive_expect_tx(&s.full[st], bytes);
    bulk_load(s.stage[st], (kind == 0 ? kb : vb) + (size_t)row0 * C::D, bytes, &s.full[st]);
  };
  for (int k = 0; k < nch; ++k) {
    issue(0, k);
    while (kv < nch && k_need(kv, a.S, total) == k) issue(1, kv++);
  }
}

template <class C, int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
decode_perbatch_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ DecArgs a) {
  extern __shared__ unsigned char smem_raw[];
  Smem<C>& s = aligned_smem<Smem<C>>(smem_raw);
  Fixed<C::D>& f = s.f;
  const int b = blockIdx.x, S = a.S, H = a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the batch row's mask bits, then (v2) its live tiles; the barriers
  const uint8_t* mb = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  const int words = (S + 31) / 32;
  for (int w = warp; w < words; w += NTHREADS / 32) {
    const int j = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, j < S && (mb == nullptr || mb[j] != 0));
    if (lane == 0) f.mbits[w] = bits;
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&s.full[i], 1);         // the producer's arrival with its bytes
      mbar_init(&s.empty[i], NCW);      // one lane a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (MODE == 2 && warp == 0) {
    const int tiles = (S + TILE - 1) / TILE;
    int n = 0;
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool on = t < tiles && (f.mbits[2 * t] | (2 * t + 1 < words ? f.mbits[2 * t + 1] : 0u));
      const uint32_t vote = __ballot_sync(0xffffffffu, on);
      if (on) f.live[n + __popc(vote & ((1u << lane) - 1u))] = t;
      n += __popc(vote);
    }
    if (lane == 0) f.n_live = n;
  }
  __syncthreads();

  if (warp == NCW) {                // the producer warp
    if (lane == 0) {
      if (MODE == 2)
        produce_v2(s, &k_map, &v_map, b, H);
      else
        produce_v3(s, a, b);
    }
    return;
  }

  const Lane<C> ln;
  float qr[C::UPL * 8], acc[C::UPL * 8];
#pragma unroll
  for (int e = 0; e < C::UPL * 8; ++e) acc[e] = 0.f;
  uint32_t qw[C::UPL * 4];          // the next head's q, in flight
  fetch_q<C>(qw, a, b, 0, ln.part);
  int qh = -1;                      // the head whose q is in qr; heads come in order

  if (MODE == 2) {
    const int n_live = f.n_live, np = (n_live + 1) / 2;
    if (n_live == 0) {              // every key masked: o is zero
      for (int x = tid; x < H * (C::D / 2); x += NC) {
        const int h = x / (C::D / 2), c = x % (C::D / 2);
        reinterpret_cast<__nv_bfloat162*>(a.o + (size_t)b * a.o_sb + (size_t)h * a.o_sh)[c] =
            __floats2bfloat162_rn(0.f, 0.f);
      }
      return;
    }
    const int items = H * 2 * np;
    for (int i = 0; i < items; ++i) {
      const int st = i % C::STAGES;
      mbar_wait(&s.full[st], (i / C::STAGES) & 1);
      const Item it = s.item[st];
      const int n = it.tile[1] >= 0 ? 2 * TILE : TILE;
      // stage row r is key tile[r / 64] * 64 + r % 64; past S: no row
      const int k0 = it.tile[0] * TILE, k1 = it.tile[1] * TILE - TILE;
      auto pos = [=](int r) {
        const int j = (r < TILE ? k0 : k1) + r;
        return j < S ? j : -1;
      };
      if (it.kind == 0) {
        if (it.head != qh) {
          next_q<C>(qr, qw, a, b, it.head, ln.part);
          qh = it.head;
        }
        score_rows<C>(s.stage[st], 0, n, qr, f.ring, ln, pos);
      } else {
        pv_rows<C>(s.stage[st], 0, n, f.inv_l[it.head & (NSTAT - 1)], f.ring, acc, ln, pos);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[st]);
      if (it.last) {
        if (it.kind == 0)
          head_stats<C::D>(f, it.head, 0, S);
        else
          head_output<C>(f, acc, a, b, it.head, ln);
      }
    }
  } else {
    const int total = H * S, items = 2 * ((total + ROWS - 1) / ROWS);
    int hk = 0, hv = 0;             // the heads of the next K row and the next V row
    for (int i = 0; i < items; ++i) {
      const int st = i % C::STAGES;
      mbar_wait(&s.full[st], (i / C::STAGES) & 1);
      const Item it = s.item[st];
      const int end = it.row0 + it.n;
      // the chunk's rows, split by head; a head that ends with the chunk is
      // finished once the stage is released
      auto finish = [&](int h) {
        if (it.kind == 0)
          head_stats<C::D>(f, h, h * S, S);
        else
          head_output<C>(f, acc, a, b, h, ln);
      };
      int last = -1;
      int h = it.kind == 0 ? hk : hv;
      for (int r = it.row0; r < end;) {
        const int e = min((h + 1) * S, end);
        // segment row x is slab row r + x, key r + x - h S
        auto pos = [&](int x) { return (r + x) & (RING - 1); };
        if (it.kind == 0) {
          if (h != qh) {
            next_q<C>(qr, qw, a, b, h, ln.part);
            qh = h;
          }
          score_rows<C>(s.stage[st], r - it.row0, e - r, qr, f.ring, ln, pos);
        } else {
          pv_rows<C>(s.stage[st], r - it.row0, e - r, f.inv_l[h & (NSTAT - 1)], f.ring, acc,
                     ln, pos);
        }
        if (e == (h + 1) * S) {
          if (e < end)
            finish(h);
          else
            last = h;
          ++h;
        }
        r = e;
      }
      if (it.kind == 0)
        hk = h;
      else
        hv = h;
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[st]);
      if (last >= 0) finish(last);
    }
  }
}

template <int D, int MODE>
int launch(const DecArgs& a, int B, int k_sh, int k_ss, int v_sh, int v_ss,
           cudaStream_t stream) {
  using C = Shape<D>;
  constexpr int bytes = sizeof(Smem<C>) + 1024;    // + alignment slack
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the limit");
  CUtensorMap km, vm;
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  if (MODE == 2) {
    int err = make_rows_map(&km, a.k, B, a.H, a.S, D, a.k_sb, k_sh, k_ss, TILE);
    if (err == 0) err = make_rows_map(&vm, a.v, B, a.H, a.S, D, a.v_sb, v_sh, v_ss, TILE);
    if (err != 0) return err;
  }
  const auto kernel = decode_perbatch_kernel<C, MODE>;
  static bool configured = false;           // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<B, NTHREADS, bytes, stream>>>(km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mode(int mode, const DecArgs& a, int B, int k_sh, int k_ss, int v_sh, int v_ss,
                cudaStream_t stream) {
  if (mode == 2) return launch<D, 2>(a, B, k_sh, k_ss, v_sh, v_ss, stream);
  return launch<D, 3>(a, B, k_sh, k_ss, v_sh, v_ss, stream);
}

}  // namespace

// q, o: bf16 (B, H, 1, D) with element strides (sb, sh), rows on 4-byte
// lines; k, v: bf16 (B, H, S, D) with element strides (sb, sh, ss), the
// last dimension contiguous; D in {64, 96, 128}. mode 2 (v2, S <= 8192)
// reads K and V through those strides by TMA: base and strides on 16-byte
// lines. mode 3 (v3, S <= 4096) reads them as dense (B, H*S, D) slabs: row
// h*S + j of batch row b at b*sb + (h*S + j)*D, so ss must be D (sh is
// unused) and the base and sb on 16-byte lines. mask: (B, S) uint8
// (nonzero = attend) with row stride mask_sb, or null. Returns
// cudaGetLastError().
extern "C" int decode_variants_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    int mode, int B, int H, int S, int D, int q_sb, int q_sh, int k_sb,
    int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh,
    int mask_sb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (D != 64 && D != 96 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 2 ? S > MAX_KEYS : mode == 3 ? S > MAX_SLAB_KEYS : true)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 3 && (k_ss != D || v_ss != D || k_sb % 8 || v_sb % 8 ||
                    reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  DecArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.H = H;
  a.S = S;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.v_sb = v_sb;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.mask_sb = mask_sb;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_mode<64>(mode, a, B, k_sh, k_ss, v_sh, v_ss, s);
  if (D == 96) return launch_mode<96>(mode, a, B, k_sh, k_ss, v_sh, v_ss, s);
  return launch_mode<128>(mode, a, B, k_sh, k_ss, v_sh, v_ss, s);
}
