// Blocking variants of the single-query decode attention for Hopper (sm_90a),
// bf16 in and out.
//
// Replaces the TPU kernels of tools/time_decode_kernel_variants.py (its
// pallas_calls at :77, v2, and :113, v3), which asked whether fewer and
// larger programs read the K/V cache faster than one program per (b, h):
//
//   v2  one block per batch row; the block loops over the H heads, its 8
//       warps working on one head at a time with K5's three passes (scores
//       to shared memory, the block's max and sum, p V) and K5's barriers;
//   v3  one block per batch row that reads K and V as one (H*S, D) slab:
//       warp w takes the head slices w, w + 8, ... of the slab and does all
//       three passes of its head alone, with warp shuffles and no block
//       barrier between heads.
//
// (v1, one block per (b, h), is K5 itself: decode_attention.cu.)
//
// What bounds it on an H100: the bytes of K and V, each read once: 100.7 MB
// at B = 32, H = 8, S = 1024, D = 96, 0.030 ms at 3.35 TB/s. Both variants
// launch B blocks, 32 at B = 32, fewer than the 132 SMs, where K5 launches
// B*H; they are here to measure what that costs on this card.
//
// Semantics (K5's): o = softmax(q . K^T * scale, masked) V; masked keys get
// -inf and read nothing; a fully-masked row gives zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int D = 96;                 // the model's head dim
constexpr int P = D / 2;              // bf16 pairs of a row
constexpr int PL = (P + 31) / 32;     // pairs per lane
constexpr int MAX_KEYS = 8192;        // v2: one head's scores in shared memory
constexpr int MAX_SLAB_KEYS = 4096;   // v3: NWARPS heads' scores

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

// Block-wide reduction of one value per thread; every thread gets the result.
template <bool IS_MAX>
__device__ float block_reduce(float x, float* red) {
  x = IS_MAX ? warp_max(x) : warp_sum(x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                   // red may still be read by a prior call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// the dot product of one K row with q (held as float pairs, PL per lane)
__device__ __forceinline__ float row_dot(const __nv_bfloat16* row, const float2 (&qv)[PL],
                                         int lane) {
  const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(row);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int c = lane + 32 * i;
    if (c < P) {
      const float2 kv = __bfloat1622float2(r[c]);
      acc += qv[i].x * kv.x + qv[i].y * kv.y;
    }
  }
  return warp_sum(acc);
}

// acc += p * (one V row), PL pairs per lane
__device__ __forceinline__ void row_axpy(float (&acc)[PL][2], float p,
                                         const __nv_bfloat16* row, int lane) {
  const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(row);
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int c = lane + 32 * i;
    if (c < P) {
      const float2 vv = __bfloat1622float2(r[c]);
      acc[i][0] += p * vv.x;
      acc[i][1] += p * vv.y;
    }
  }
}

__device__ __forceinline__ void load_q(float2 (&qv)[PL], const __nv_bfloat16* qh, int lane) {
  const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(qh);
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int c = lane + 32 * i;
    qv[i] = c < P ? __bfloat1622float2(r[c]) : make_float2(0.f, 0.f);
  }
}

// v2: grid (B,); the block loops over heads, all warps on one head.
__global__ void __launch_bounds__(NTHREADS)
decode_perbatch_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                       __nv_bfloat16* __restrict__ o, int H, int S, int q_sb, int q_sh,
                       int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss,
                       int o_sb, int o_sh, int mask_sb, float scale) {
  extern __shared__ float scores[];  // (S,), one head at a time
  __shared__ float red[NWARPS];
  __shared__ float part[NWARPS][D];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;

  for (int h = 0; h < H; ++h) {
    const __nv_bfloat16* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
    const __nv_bfloat16* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
    float2 qv[PL];
    load_q(qv, q + (size_t)b * q_sb + (size_t)h * q_sh, lane);
    __syncthreads();                 // the last head's scores and parts are read

    for (int j = warp; j < S; j += NWARPS) {   // pass 1: scores
      float dot = -INFINITY;
      if (mb == nullptr || mb[j]) dot = row_dot(kb + (size_t)j * k_ss, qv, lane) * scale;
      if (lane == 0) scores[j] = dot;
    }
    __syncthreads();

    float mx = -INFINITY;            // pass 2: softmax statistics
    for (int j = threadIdx.x; j < S; j += NTHREADS) mx = fmaxf(mx, scores[j]);
    mx = block_reduce<true>(mx, red);
    const float base = mx == -INFINITY ? 0.f : mx;   // fully masked: p = 0
    float sum = 0.f;
    for (int j = threadIdx.x; j < S; j += NTHREADS) {
      const float p = expf(scores[j] - base);
      scores[j] = p;
      sum += p;
    }
    sum = block_reduce<false>(sum, red);         // its barriers publish scores
    const float inv = sum > 0.f ? 1.f / sum : 0.f;

    float acc[PL][2];                // pass 3: p . V
#pragma unroll
    for (int i = 0; i < PL; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int j = warp; j < S; j += NWARPS) {
      const float p = scores[j];
      if (p != 0.f) row_axpy(acc, p, vb + (size_t)j * v_ss, lane);   // warp-uniform
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = lane + 32 * i;
      if (c < P) {
        part[warp][2 * c] = acc[i][0];
        part[warp][2 * c + 1] = acc[i][1];
      }
    }
    __syncthreads();
    __nv_bfloat16* ob = o + (size_t)b * o_sb + (size_t)h * o_sh;
    for (int d = threadIdx.x; d < D; d += NTHREADS) {
      float r = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) r += part[w][d];
      ob[d] = __float2bfloat16(r * inv);
    }
  }
}

// v3: grid (B,); K and V are (B, H*S, D) slabs; warp w owns heads w, w + 8, ...
__global__ void __launch_bounds__(NTHREADS)
decode_slab_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                   __nv_bfloat16* __restrict__ o, int H, int S, int q_sb, int q_sh,
                   int k_sb, int k_ss, int v_sb, int v_ss, int o_sb, int o_sh,
                   int mask_sb, float scale) {
  extern __shared__ float scores[];  // (NWARPS, S): one row a warp
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * mask_sb;
  float* sc = scores + (size_t)warp * S;

  for (int h = warp; h < H; h += NWARPS) {
    // head h is rows h*S .. h*S + S - 1 of the batch row's slab
    const __nv_bfloat16* kb = k + (size_t)b * k_sb + (size_t)h * S * k_ss;
    const __nv_bfloat16* vb = v + (size_t)b * v_sb + (size_t)h * S * v_ss;
    float2 qv[PL];
    load_q(qv, q + (size_t)b * q_sb + (size_t)h * q_sh, lane);

    float mx = -INFINITY;            // pass 1: scores and their max
    for (int j = 0; j < S; ++j) {
      float dot = -INFINITY;
      if (mb == nullptr || mb[j]) dot = row_dot(kb + (size_t)j * k_ss, qv, lane) * scale;
      mx = fmaxf(mx, dot);           // dot is the same in every lane
      if (lane == 0) sc[j] = dot;
    }
    __syncwarp();
    const float base = mx == -INFINITY ? 0.f : mx;   // fully masked: p = 0
    float sum = 0.f;                 // pass 2: exponents and their sum
    for (int j = lane; j < S; j += 32) {
      const float p = expf(sc[j] - base);
      sc[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float inv = sum > 0.f ? 1.f / sum : 0.f;

    float acc[PL][2];                // pass 3: p . V
#pragma unroll
    for (int i = 0; i < PL; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float p = sc[j];
      if (p != 0.f) row_axpy(acc, p, vb + (size_t)j * v_ss, lane);   // warp-uniform
    }
    __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(
        o + (size_t)b * o_sb + (size_t)h * o_sh);
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = lane + 32 * i;
      if (c < P) ob[c] = __floats2bfloat162_rn(acc[i][0] * inv, acc[i][1] * inv);
    }
    __syncwarp();                    // sc is rewritten for the warp's next head
  }
}

}  // namespace

// q, o: bf16 (B, H, 1, D); k, v: bf16 (B, H, S, D) with element strides
// (sb, sh, ss), the last dimension contiguous and rows on 4-byte lines;
// D = 96. mode 2 (v2) reads K and V through those strides; mode 3 (v3)
// reads them as (B, H*S, D) slabs, row h*S + j of batch row b at
// b*sb + (h*S + j)*ss (its sh are unused). mask: (B, S) uint8 (nonzero =
// attend) with row stride mask_sb, or null. Returns cudaGetLastError().
extern "C" int decode_variants_bf16(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    int mode, int B, int H, int S, int D_, int q_sb, int q_sh, int k_sb,
    int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh,
    int mask_sb, float scale, void* stream) {
  if (D_ != D || B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (mode == 2) {
    if (S > MAX_KEYS) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = (size_t)S * sizeof(float);   // at most 32 KB
    decode_perbatch_kernel<<<B, NTHREADS, bytes, s>>>(
        qp, kp, vp, mp, op, H, S, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
        o_sb, o_sh, mask_sb, scale);
  } else if (mode == 3) {
    // raised once, at the largest S (no call inside a graph capture)
    const size_t bytes = (size_t)NWARPS * S * sizeof(float);
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        NWARPS * MAX_SLAB_KEYS * (int)sizeof(float));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (S > MAX_SLAB_KEYS) return static_cast<int>(cudaErrorInvalidValue);
    decode_slab_kernel<<<B, NTHREADS, bytes, s>>>(
        qp, kp, vp, mp, op, H, S, q_sb, q_sh, k_sb, k_ss, v_sb, v_ss, o_sb, o_sh,
        mask_sb, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
