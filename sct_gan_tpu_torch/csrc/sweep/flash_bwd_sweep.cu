// The candidate tile shapes of the flash-attention backward pair at one head
// dim, for the block sweep (sct_gan_tpu_torch/tools/sweep_flash_blocks.py,
// the port of tools/sweep_flash_blocks.py). The build sets SWEEP_D (64, 96
// or 128) and makes one library per head dim, only when the tool runs; the
// kernels are flash_bwd_hopper.cuh's templates, the shipped shape
// (Shipped<D>) among the candidates.
//
// part 0 is the dKV kernel, part 1 the dQ kernel. A candidate is a shape:
// dKV (keys a block, ring stages, blocks an SM asked), dQ (64 queries a
// block, ring stages, blocks an SM asked).
#include <type_traits>

#include "../flash_bwd_hopper.cuh"

#ifndef SWEEP_D
#error "build with -DSWEEP_D=64, 96 or 128"
#endif

namespace {

constexpr int D = SWEEP_D;

template <class... Cs>
struct List {
  static constexpr int size = sizeof...(Cs);
};

using DkvCandidates = List<DkvShape<D, 2, 2, 1>, DkvShape<D, 2, 3, 1>, DkvShape<D, 2, 4, 1>,
                           DkvShape<D, 1, 2, 2>, DkvShape<D, 1, 3, 2>>;
using DqCandidates = List<DqShape<D, 2, 1>, DqShape<D, 3, 1>, DqShape<D, 4, 1>,
                          DqShape<D, 2, 2>, DqShape<D, 3, 2>, DqShape<D, 2, 3>>;

// f(C{}) for the idx-th shape C of the list; -1 past its end.
template <class F, class... Cs>
int visit(List<Cs...>, int idx, F&& f) {
  int i = 0, r = -1;
  ((i++ == idx ? (r = f(Cs{}), 0) : 0), ...);
  return r;
}

template <class F>
int visit_part(int part, int idx, F&& f) {
  return part == 0 ? visit(DkvCandidates{}, idx, f) : visit(DqCandidates{}, idx, f);
}

}  // namespace

extern "C" int flash_bwd_sweep_count(int part) {
  return part == 0 ? DkvCandidates::size : DqCandidates::size;
}

// out: rows a block, ring stages, blocks an SM asked, shipped (0 or 1),
// blocks an SM resident (the occupancy calculator, registers and shared
// memory both), shared memory bytes a block. Returns 0 or a CUDA error.
extern "C" int flash_bwd_sweep_shape(int part, int idx, int* out) {
  return visit_part(part, idx, [&](auto c) {
    using C = decltype(c);
    int resident = 0;
    cudaError_t e;
    if constexpr (C::DKV) {
      static bool ready = false;
      out[0] = C::KEYS;
      out[3] = std::is_same<C, Shipped<D>::Dkv>::value;
      out[5] = dkv_smem_bytes<C>();
      e = allow_smem(flash_bwd_dkv_hopper_kernel<C>, out[5], ready);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, flash_bwd_dkv_hopper_kernel<C>, C::NTHREADS, out[5]);
    } else {
      static bool ready = false;
      out[0] = BR;
      out[3] = std::is_same<C, Shipped<D>::Dq>::value;
      out[5] = dq_smem_bytes<C>();
      e = allow_smem(flash_bwd_dq_hopper_kernel<C>, out[5], ready);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, flash_bwd_dq_hopper_kernel<C>, C::NTHREADS, out[5]);
    }
    out[1] = C::STAGES;
    out[2] = C::MINB;
    out[4] = resident;
    return static_cast<int>(e);
  });
}

// The candidate's kernel alone, on flash_attention_bwd_bf16's arguments
// (Dh must be SWEEP_D); dvec must hold D already, and out is not read.
extern "C" int flash_bwd_sweep_bf16(int part, int idx, FLASH_BWD_PARAMS) {
  if (Dh != D) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = FLASH_BWD_ARGS;
  CUtensorMap m[4];
  const int err = make_bwd_maps(a, B, D, m);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = visit_part(part, idx, [&](auto c) {
    using C = decltype(c);
    if constexpr (C::DKV) return launch_dkv<C>(a, B, m, s);
    else return launch_dq<C>(a, B, m, s);
  });
  return r < 0 ? static_cast<int>(cudaErrorInvalidValue) : r;
}
