// Flash-attention parts for Hopper (sm_90a): K1's pipeline with one of three
// elementwise bodies, to take K1's time apart on the card. bf16 in and out.
//
// Replaces the TPU kernel of tools/time_flash_parts.py (its pallas_call at
// :81), which timed three bodies under identical memory traffic and grid, at
// scale 0.1 with s = 0.1 Q K^T:
//
//   full    O = softmax(s) V as the online softmax: running row max and sum,
//           the accumulator rescaled by 2^(m_old - m_new) at every tile
//   noexp   p = clip(s, 0, 1), l = rowsum p, O = (p V) / max(l, 1e-9): no
//           max, no exponent, no rescale
//   mmonly  O = bf16(s) V: the two matrix products alone
//
// q, k and v may be one tensor (the tool calls f(x, x, x)): the three tensor
// maps then cover one buffer.
//
// What bounds it on an H100: at (8, 8, 1024, 96) it does 25.8 GFLOP of
// matrix products, 0.026 ms at 989 TFLOP/s, against 25 MB of input and
// output (0.008 ms at 3.35 TB/s), so it is bound by operations. What it
// measures is how much of K1's time its body takes: the three modes run the
// same grid, the same loads and the same two products.
//
// The design is K1's Hopper forward at head dims 96 and 128 (the pipeline
// of flash_fwd_hopper.cuh, flash_attention_fwd.cu's flash_fwd_hopper_kernel)
// with the body swapped: flash_parts_hopper_kernel<FwdShape<D>, MODE>.
//   * a producer warpgroup whose first warp issues the TMA loads, Q once and
//     then every 64-key K and V tile in order through a ring of mbarrier
//     stages (K1's walk over live key tiles, with no key mask), and gives
//     its registers to the consumers (setmaxnreg);
//   * two consumer warpgroups of 64 query rows in ping-pong turns on named
//     barriers; S = Q K^T on wgmma m64n64k16 from shared memory, P V on
//     wgmma with P packed from the S accumulators in registers and V read
//     MN-major through the transpose bit, so V is never transposed;
//   * tile j's S is issued with tile j-1's P V, and tile j's body runs while
//     P V is on the tensor cores.
// The bodies: full is K1's unmasked, dropout-free online softmax (fwd_softmax
// with EDGE and DROP off: ex2.approx, log2(e) folded into the scale, the max
// taken on raw scores, so it needs scale > 0); noexp the clip and this
// thread's share of the row sum, reduced over the four threads of an
// accumulator group once at the end, with nothing to rescale; mmonly the
// scale and the bf16 pack. The epilogue divides by max(l, 1e-9) (by 1 in
// mmonly), as the tool's _fin. Shared memory and registers are K1's
// instance's: Q (128 rows) and a ring of 4 stages, 168 registers a thread at
// most (ptxas -v must show no spill). S must be a multiple of 64 (the
// tool's is 1024); a block's query rows past S read zeros and are not
// written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_hopper.cuh"
#include "hopper_tile.cuh"

namespace {

using namespace hopper;

enum Mode { FULL = 0, NOEXP = 1, MMONLY = 2 };

// MODE's body (flash_fwd_hopper.cuh's hooks). a.scale_log2 holds the score
// scale times log2(e) in full only; noexp and mmonly get the plain scale
// there (launch). noexp keeps this thread's share of each row's sum in
// l_run until the epilogue.
template <class C, int MODE>
struct Parts {
  static __device__ __forceinline__ void tile(float (&sc)[BK / 2],
                                              const uint32_t (&kb)[C::WORDS], int k0,
                                              int wrow, int row0, int t, const FwdArgs& a,
                                              uint32_t drop0, float (&m_run)[2],
                                              float (&l_run)[2], float (&alpha)[2]) {
    if constexpr (MODE == FULL) {           // K1's interior body: no mask, no dropout
      fwd_softmax<C, false, false>(sc, kb, k0, row0, t, a, drop0, m_run, l_run, alpha);
    } else {
      float rs2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // noexp: two chains a row
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = sc[i] * a.scale_log2;
        if constexpr (MODE == NOEXP) {
          x = fminf(fmaxf(x, 0.f), 1.f);
          rs2[(i >> 1) & 1][i & 1] += x;
        }
        sc[i] = x;
      }
      if constexpr (MODE == NOEXP) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] += rs2[r][0] + rs2[r][1];
      }
    }
  }

  static __device__ __forceinline__ void rescale(float (&acc)[C::D / 2],
                                                 const float (&alpha)[2]) {
    if constexpr (MODE == FULL) {
#pragma unroll
      for (int i = 0; i < C::D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
  }

  static __device__ __forceinline__ void store(const float (&acc)[C::D / 2], const FwdArgs& a,
                                               int b, int, int row0, int row1, int t,
                                               const float (&)[2],
                                               const float (&l_run)[2]) {
    float l[2] = {l_run[0], l_run[1]};
    if constexpr (MODE == NOEXP) {          // the row sums over the accumulator group
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
    }
    // O = acc / max(l, 1e-9), as the tool's _fin; mmonly divides by 1
    const float inv0 = MODE == MMONLY ? 1.f : 1.f / fmaxf(l[0], 1e-9f);
    const float inv1 = MODE == MMONLY ? 1.f : 1.f / fmaxf(l[1], 1e-9f);
    __nv_bfloat16* ob = a.o + (size_t)b * a.o_sb;
#pragma unroll
    for (int dt = 0; dt < C::D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (row0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * a.o_ss + col) =
            __floats2bfloat162_rn(acc[dt * 4] * inv0, acc[dt * 4 + 1] * inv0);
      if (row1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * a.o_ss + col) =
            __floats2bfloat162_rn(acc[dt * 4 + 2] * inv1, acc[dt * 4 + 3] * inv1);
    }
  }
};

// One block a (query tile of BQ rows, b*H + h), every key tile in order.
template <class C, int MODE>
__global__ void __launch_bounds__(C::NTHREADS, 1)
flash_parts_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ FwdArgs a) {
  fwd_block<C, Parts<C, MODE>>(q_map, k_map, v_map, a);
}

// q, k, v, o contiguous (BH, S, D): one head a batch row of the maps.
template <class C, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, float scale,
           cudaStream_t stream) {
  constexpr int bytes = sizeof(FwdSmem<C>) + 1024;   // + alignment slack
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the limit");
  const int sb = S * C::D;
  // scale_log2: only full works in the log2 domain
  const FwdArgs a{nullptr, static_cast<__nv_bfloat16*>(o), nullptr, 1, S, S, sb, 0, C::D,
                  0, 0, MODE == FULL ? scale * LOG2E : scale, 0, 0u, 0u, 1.f,
                  DropShard{0u, 0u, 1u}};
  CUtensorMap qm, km, vm;
  int err = make_head_map(&qm, q, BH, 1, S, C::D, sb, sb, C::D, C::BQ);
  if (err == 0) err = make_head_map(&km, k, BH, 1, S, C::D, sb, sb, C::D, BK);
  if (err == 0) err = make_head_map(&vm, v, BH, 1, S, C::D, sb, sb, C::D, BK);
  if (err != 0) return err;
  static bool configured = false;           // above 48 KB needs an opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_parts_hopper_kernel<C, MODE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((S + C::BQ - 1) / C::BQ, BH);
  flash_parts_hopper_kernel<C, MODE><<<grid, C::NTHREADS, bytes, stream>>>(qm, km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mode(int mode, const void* q, const void* k, const void* v, void* o, int BH,
                int S, float scale, cudaStream_t stream) {
  using C = FwdShape<D>;
  switch (mode) {
    case FULL: return launch<C, FULL>(q, k, v, o, BH, S, scale, stream);
    case NOEXP: return launch<C, NOEXP>(q, k, v, o, BH, S, scale, stream);
    case MMONLY: return launch<C, MMONLY>(q, k, v, o, BH, S, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: contiguous bf16 (B*H, S, D), 16-byte aligned, D in {96, 128},
// S a multiple of 64; mode 0 full, 1 noexp, 2 mmonly; scale multiplies Q K^T
// (full needs scale > 0). Returns the first error: a shape or scale the
// kernel does not take, a refused tensor map, or cudaGetLastError() after
// the launch.
extern "C" int flash_parts_bf16(const void* q, const void* k, const void* v,
                                void* o, int BH, int S, int D, int mode,
                                float scale, void* stream) {
  if (BH <= 0 || S <= 0 || S % BK || (mode == FULL && !(scale > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 96) return launch_mode<96>(mode, q, k, v, o, BH, S, scale, s);
  if (D == 128) return launch_mode<128>(mode, q, k, v, o, BH, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
