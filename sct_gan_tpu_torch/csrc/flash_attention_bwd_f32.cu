// Flash-attention backward for Hopper (sm_90a), f32: dQ, dK, dV in f32 from
// f32 q, k, v, dO, O and the forward's per-row LSE. The f32 instance of the
// backward pair (flash_attention_bwd.cu is the bf16 one).
//
// Replaces the TPU kernels of sct_gan_tpu/ops/flash_attention.py::
// _flash_backward on f32 operands, where the JAX kernels keep dS and P in
// the operands' dtype (lines 280-302, 352-375): _fa_bwd_fused_kernel (nk ==
// 1) and the _fa_dkv_kernel / _fa_dq_kernel pair (nk > 1). With M the
// dropout keep mask and r its rate:
//
//   P  = exp(S - lse),  S = Q K^T * scale + bias [+ causal]   (recomputed)
//   dV = (M o P / (1-r))^T dO
//   dS = P o (M o (dO V^T) / (1-r) - D),   D = rowsum(dO o O)
//   dK = dS^T Q * scale,   dQ = dS K * scale
//
// Three kernels, no atomics, so the gradients are bit-for-bit deterministic:
// D (flash_f32_dvec_kernel, a warp a row), a dKV kernel (blocks over keys,
// walking query tiles) and a dQ kernel (blocks over queries, walking key
// tiles). Both recompute S and dP: 7 products as run for the 5 of the math.
//
// Bound on an H100: the 5 products over the attended keys,
// 10*H*Sq*dh*sum_b(attended keys of row b) flops at f32 accuracy, ~165
// TFLOP/s by 3xTF32 (f32_attention.cuh): 0.25 ms at (8, 8, 1024, 96) under
// chip_smoke.py's key mask, against ~0.05 ms of bytes.
//
// Design (simple and right; no Hopper pipeline yet): every product runs on
// mma.sync.m16n8k8 in 3xTF32, with tiles row-major in shared memory (rows of
// D + 4 f32) loaded by cp.async through 2 stages, and the score tiles (S,
// dP and their transposes) kept in registers, where P and dS are formed and
// fed straight to the gradient products.
//   dKV: a block owns 64 keys, 16 a warp (K and V resident), and walks
//        32-query tiles of Q, dO and their lse and D (from the tile holding
//        its first key on, when causal). Each warp computes S^T = K Q^T and
//        dP^T = V dO^T, forms P^T and dS^T, and accumulates dV += P_drop^T
//        dO and dK += dS^T Q. A block whose 64 keys are all masked walks
//        nothing and writes zeros.
//   dQ:  a block owns 64 queries, 16 a warp (Q and dO resident), and walks
//        the 64-key tiles that hold an attended key (up to the diagonal,
//        when causal; the forward's vote, f32_attention.cuh::next_live);
//        each warp computes S and dP, forms dS and accumulates dQ += dS K.
// Budget at D = 128 / 96 / 64: dKV K + V 67.6 / 51.2 / 34.8 KB and 2 stages
// of Q + dO (32 rows) 67.6 / 51.2 / 34.8 KB; registers dK + dV (D f32), S^T
// + dP^T (32). dQ Q + dO 67.6 / 51.2 / 34.8 KB and 2 stages of K + V (64
// rows) 135 / 102 / 70 KB; registers dQ (D / 2), S + dP (64).
//
// The mask and causal semantics are the forward's: a masked key, a key past
// Sk, a query past Sq and a causal key j > i all get P = 0, so a fully-
// masked row gets dQ = 0 whatever its lse. The dropout keep bit is the
// forward's (hash_dropout.cuh), keyed by ((b*H + h)*Sq + i)*Sk + j.
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_attention.cuh"
#include "hash_dropout.cuh"
#include "hopper_tile.cuh"

namespace {

using namespace f32att;

struct St {
  int sb, sh, ss;
};

struct BwdF32Args {
  const float *q, *k, *v, *dout, *o;
  const uint8_t* mask;   // (B, Sk), nonzero = attend, or null
  const float* lse;      // contiguous (B*H, Sq)
  float* dvec;           // D = rowsum(dO o O), contiguous (B*H, Sq)
  float *dq, *dk, *dv;
  int H, Sq, Sk;
  St qs, ks, vs, dos, os, dqs, dks, dvs;
  int mask_sb, causal;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float inv_keep;
  DropShard ds;
};

template <typename T>
__device__ __forceinline__ T* head(T* p, const St& s, int b, int h) {
  return p + (size_t)b * s.sb + (size_t)h * s.sh;
}

// D = rowsum(dO o O), one warp a (b, h, i) row.
__global__ void __launch_bounds__(256)
flash_f32_dvec_kernel(const BwdF32Args a, int rows, int Dh) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = row % a.Sq, bh = row / a.Sq, b = bh / a.H, h = bh % a.H;
  const float* dor = head(a.dout, a.dos, b, h) + (size_t)i * a.dos.ss;
  const float* orow = head(a.o, a.os, b, h) + (size_t)i * a.os.ss;
  float s = 0.f;
  for (int c = lane; c < Dh; c += 32) s = fmaf(dor[c], orow[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.dvec[row] = s;
}

// Write a warp's 16 x D gradient tile (the C layout) at rows r0, r0 + 8 of
// a strided head, times `mul`; rows >= n_rows are not written.
template <int D>
__device__ __forceinline__ void store_rows(float* base, int ss, const float (&acc)[D / 8][4],
                                           int r0, int n_rows, float mul, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<float2*>(base + (size_t)r0 * ss + col) =
          make_float2(acc[n][0] * mul, acc[n][1] * mul);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<float2*>(base + (size_t)(r0 + 8) * ss + col) =
          make_float2(acc[n][2] * mul, acc[n][3] * mul);
  }
}

constexpr int NT = 128;                      // 4 warps, 16 rows each
constexpr int BKEYS = 64;                    // dKV: keys a block
constexpr int WQ = 32;                       // dKV: queries a walked tile
constexpr int BQ = 64;                       // dQ: queries a block
constexpr int WK = 64;                       // dQ: keys a walked tile

template <int D>
struct Dkv {
  static constexpr int LD = D + 4;
  static constexpr int SMEM = (2 * BKEYS * LD + 2 * 2 * WQ * LD + 2 * 2 * WQ) * 4;
  static constexpr int MIN_BLOCKS = 233472 / (SMEM + 1024) < 4 ? 233472 / (SMEM + 1024) : 4;
  static_assert(SMEM <= 232448, "shared memory over the limit");
};

template <int D>
__global__ void __launch_bounds__(NT, Dkv<D>::MIN_BLOCKS)
flash_f32_dkv_kernel(const BwdF32Args a) {
  constexpr int LD = Dkv<D>::LD;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [BKEYS][LD]
  float* vs = ks + BKEYS * LD;                   // [BKEYS][LD]
  float* walk = vs + BKEYS * LD;                 // [2 stages][Q, dO][WQ][LD]
  float* stats = walk + 4 * WQ * LD;             // [2 stages][lse, D][WQ]
  const int k0 = blockIdx.x * BKEYS, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;   // this thread's rows
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  const bool on0 = key0 < a.Sk && (mrow == nullptr || mrow[key0] != 0);
  const bool on1 = key1 < a.Sk && (mrow == nullptr || mrow[key1] != 0);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const bool any = __syncthreads_or(
      threadIdx.x < BKEYS && k0 + (int)threadIdx.x < a.Sk &&
      (mrow == nullptr || mrow[k0 + threadIdx.x] != 0));
  const int t_first = a.causal ? k0 / WQ : 0;
  const int t_end = any ? (a.Sq + WQ - 1) / WQ : t_first;
  const float* qb = head(a.q, a.qs, b, h);
  const float* dob = head(a.dout, a.dos, b, h);
  const float* lse = a.lse + (size_t)bh * a.Sq;
  const float* dvec = a.dvec + (size_t)bh * a.Sq;
  auto issue = [&](int j, int st) {          // Q, dO, lse and D of query tile j
    float* w = walk + st * 2 * WQ * LD;
    load_rows<WQ, D, LD, NT>(w, qb, a.qs.ss, j * WQ, a.Sq);
    load_rows<WQ, D, LD, NT>(w + WQ * LD, dob, a.dos.ss, j * WQ, a.Sq);
    if (threadIdx.x < WQ) {
      const int i = j * WQ + threadIdx.x;
      stats[st * 2 * WQ + threadIdx.x] = i < a.Sq ? lse[i] : 0.f;
      stats[st * 2 * WQ + WQ + threadIdx.x] = i < a.Sq ? dvec[i] : 0.f;
    }
  };
  if (t_first < t_end) {
    load_rows<BKEYS, D, LD, NT>(ks, head(a.k, a.ks, b, h), a.ks.ss, k0, a.Sk);
    load_rows<BKEYS, D, LD, NT>(vs, head(a.v, a.vs, b, h), a.vs.ss, k0, a.Sk);
    issue(t_first, 0);
  }
  hopper::cp_async_commit();
  const uint32_t head_index = drop_head(b, h, a.ds) * (uint32_t)a.Sq;
  for (int j = t_first; j < t_end; ++j) {
    const int st = (j - t_first) & 1;
    if (j + 1 < t_end) issue(j + 1, st ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const float* qt = walk + st * 2 * WQ * LD;
    const float* dot = qt + WQ * LD;
    const float* sl = stats + st * 2 * WQ;

    float s[WQ / 8][4], dp[WQ / 8][4];       // S^T and dP^T: 16 keys x WQ queries
#pragma unroll
    for (int n = 0; n < WQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_nt<WQ, D, LD>(s, ks + warp * 16 * LD, qt, lane);
    mma_nt<WQ, D, LD>(dp, vs + warp * 16 * LD, dot, lane);
#pragma unroll
    for (int n = 0; n < WQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), i = j * WQ + c;
        const int key = e < 2 ? key0 : key1;
        const bool live = (e < 2 ? on0 : on1) && i < a.Sq && !(a.causal && key > i);
        const float p = live ? expf(s[n][e] * a.scale - sl[c]) : 0.f;
        float pd = p, dpd = dp[n][e];
        if (a.dropout) {
          const bool keep = hash_keep((head_index + (uint32_t)i) * (uint32_t)a.Sk + (uint32_t)key,
                                      a.seed, a.threshold);
          pd = keep ? p * a.inv_keep : 0.f;
          dpd = keep ? dpd * a.inv_keep : 0.f;
        }
        s[n][e] = pd;                        // P_drop^T
        dp[n][e] = p * (dpd - sl[WQ + c]);   // dS^T
      }
    mma_pn<WQ, D, LD>(dv, s, dot, lane);
    mma_pn<WQ, D, LD>(dk, dp, qt, lane);
    __syncthreads();                         // stage st is free for tile j + 2
  }
  hopper::cp_async_wait<0>();
  const int r0 = k0 + warp * 16 + g;
  store_rows<D>(head(a.dk, a.dks, b, h), a.dks.ss, dk, r0, a.Sk, a.scale, t);
  store_rows<D>(head(a.dv, a.dvs, b, h), a.dvs.ss, dv, r0, a.Sk, 1.f, t);
}

template <int D>
struct Dq {
  static constexpr int LD = D + 4;
  static constexpr int SMEM = (2 * BQ * LD + 2 * 2 * WK * LD + 2 * WK) * 4;
  static constexpr int MIN_BLOCKS = 233472 / (SMEM + 1024) < 4 ? 233472 / (SMEM + 1024) : 4;
  static_assert(SMEM <= 232448, "shared memory over the limit");
};

template <int D>
__global__ void __launch_bounds__(NT, Dq<D>::MIN_BLOCKS)
flash_f32_dq_kernel(const BwdF32Args a) {
  constexpr int LD = Dq<D>::LD;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][LD]
  float* dos = qs + BQ * LD;                     // [BQ][LD]
  float* kv = dos + BQ * LD;                     // [2 stages][K, V][WK][LD]
  float* bias = kv + 4 * WK * LD;                // [2 stages][WK]: 0 or -inf
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + (size_t)b * a.mask_sb;
  const float* kb = head(a.k, a.ks, b, h);
  const float* vb = head(a.v, a.vs, b, h);
  const float lse0 = row0 < a.Sq ? a.lse[(size_t)bh * a.Sq + row0] : 0.f;
  const float lse1 = row1 < a.Sq ? a.lse[(size_t)bh * a.Sq + row1] : 0.f;
  const float dv0 = row0 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row0] : 0.f;
  const float dv1 = row1 < a.Sq ? a.dvec[(size_t)bh * a.Sq + row1] : 0.f;
  int n_tiles = (a.Sk + WK - 1) / WK;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + BQ, a.Sq) - 1) / WK + 1);
  auto issue = [&](int j, int st) {          // K, V and the mask bias of tile j
    float* kt = kv + st * 2 * WK * LD;
    load_rows<WK, D, LD, NT>(kt, kb, a.ks.ss, j * WK, a.Sk);
    load_rows<WK, D, LD, NT>(kt + WK * LD, vb, a.vs.ss, j * WK, a.Sk);
    if (threadIdx.x < WK) {
      const int key = j * WK + threadIdx.x;
      bias[st * WK + threadIdx.x] =
          key < a.Sk && (mrow == nullptr || mrow[key] != 0) ? 0.f : -INFINITY;
    }
  };
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const uint32_t drop0 =
      (drop_head(b, h, a.ds) * (uint32_t)a.Sq + (uint32_t)row0) * (uint32_t)a.Sk;
  const uint32_t drop1 = drop0 + 8u * (uint32_t)a.Sk;

  int cur = next_live<WK>(mrow, 0, n_tiles, a.Sk);
  if (cur < n_tiles) {
    load_rows<BQ, D, LD, NT>(qs, head(a.q, a.qs, b, h), a.qs.ss, q0, a.Sq);
    load_rows<BQ, D, LD, NT>(dos, head(a.dout, a.dos, b, h), a.dos.ss, q0, a.Sq);
    issue(cur, 0);
  }
  hopper::cp_async_commit();
  int nxt = next_live<WK>(mrow, cur + 1, n_tiles, a.Sk);
  for (int n = 0; cur < n_tiles; ++n) {
    const int st = n & 1;
    if (nxt < n_tiles) issue(nxt, st ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const float* kt = kv + st * 2 * WK * LD;
    const float* bs = bias + st * WK;
    const int k0 = cur * WK;

    float s[WK / 8][4], dp[WK / 8][4];
#pragma unroll
    for (int n8 = 0; n8 < WK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n8][e] = dp[n8][e] = 0.f;
    mma_nt<WK, D, LD>(s, qs + warp * 16 * LD, kt, lane);
    mma_nt<WK, D, LD>(dp, dos + warp * 16 * LD, kt + WK * LD, lane);
#pragma unroll
    for (int n8 = 0; n8 < WK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n8 * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool live = bs[col] == 0.f && row < a.Sq && !(a.causal && k0 + col > row);
        const float p = live ? expf(s[n8][e] * a.scale - (e < 2 ? lse0 : lse1)) : 0.f;
        float dpd = dp[n8][e];
        if (a.dropout) {
          const bool keep = hash_keep((e < 2 ? drop0 : drop1) + (uint32_t)(k0 + col), a.seed,
                                      a.threshold);
          dpd = keep ? dpd * a.inv_keep : 0.f;
        }
        s[n8][e] = p * (dpd - (e < 2 ? dv0 : dv1));   // dS
      }
    mma_pn<WK, D, LD>(dq, s, kt, lane);
    __syncthreads();                         // stage st is free for tile n + 2
    cur = nxt;
    nxt = next_live<WK>(mrow, nxt + 1, n_tiles, a.Sk);
  }
  hopper::cp_async_wait<0>();
  store_rows<D>(head(a.dq, a.dqs, b, h), a.dqs.ss, dq, row0, a.Sq, a.scale, t);
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
int launch(const BwdF32Args& a, int B, cudaStream_t s) {
  static bool dkv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(flash_f32_dkv_kernel<D>, Dkv<D>::SMEM, dkv_ok);
  if (e == cudaSuccess) e = allow_smem(flash_f32_dq_kernel<D>, Dq<D>::SMEM, dq_ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_f32_dkv_kernel<D><<<dim3((a.Sk + BKEYS - 1) / BKEYS, B * a.H), NT, Dkv<D>::SMEM, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_f32_dq_kernel<D><<<dim3((a.Sq + BQ - 1) / BQ, B * a.H), NT, Dq<D>::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 entry point's arguments (flash_attention_bwd.cu), for f32 q, k,
// v, dout, out, dq, dk, dv: (B, H, S, Dh) with element strides (sb, sh, ss)
// and the last dimension contiguous; q, k, v, dout on 16-byte lines with
// strides of whole 16-byte units (the cp.async copies), out and the
// gradients on 8-byte lines; Dh 64, 96 or 128. lse: the forward's, dvec: f32
// (B*H*Sq) scratch the entry fills with D. Returns the first error.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, const void* out,
    const void* mask, const void* lse, void* dvec, void* dq, void* dk, void* dv, int B,
    int H, int Sq, int Sk, int Dh, int q_sb, int q_sh, int q_ss, int k_sb, int k_sh,
    int k_ss, int v_sb, int v_sh, int v_ss, int do_sb, int do_sh, int do_ss, int o_sb,
    int o_sh, int o_ss, int dq_sb, int dq_sh, int dq_ss, int dk_sb, int dk_sh, int dk_ss,
    int dv_sb, int dv_sh, int dv_ss, int mask_sb, int causal, float scale, int dropout,
    uint32_t seed, uint32_t threshold, float inv_keep, int drop_b0, int drop_h0,
    int drop_hg, void* stream) {
  const BwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(dout),
                     static_cast<const float*>(out), static_cast<const uint8_t*>(mask),
                     static_cast<const float*>(lse), static_cast<float*>(dvec),
                     static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                     H, Sq, Sk,
                     {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
                     {do_sb, do_sh, do_ss}, {o_sb, o_sh, o_ss}, {dq_sb, dq_sh, dq_ss},
                     {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss},
                     mask_sb, causal, scale, dropout, seed, threshold, inv_keep,
                     DropShard{(uint32_t)drop_b0, (uint32_t)drop_h0, (uint32_t)drop_hg}};
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B * H > 65535 ||
      (Dh != 64 && Dh != 96 && Dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);   // no instance takes it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H * Sq;
  flash_f32_dvec_kernel<<<(rows + 7) / 8, 256, 0, s>>>(a, rows, Dh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (Dh) {
    case 64: return launch<64>(a, B, s);
    case 96: return launch<96>(a, B, s);
    default: return launch<128>(a, B, s);
  }
}
