// K5 flash_bwd_dq and K6 flash_bwd_dkv: the flash attention backward.
//
// Replace ps_pytorch_tpu/ops/flash_attention.py:_make_dq_kernel (K5,
// launched by _flash_bwd at :319) and _make_dkv_kernel (K6, at :337).
// Given the FINAL softmax statistics lse and delta = rowsum(do * o) (f32
// [B, H, Tq]), both recompute
//   p  = exp(q.k * scale - lse)          (0 where masked or lse <= NEG_INF/2)
//   ds = p * (do.v - delta) * scale
// and accumulate, in f32,
//   K5: dq = sum over keys of ds * k     (one block per batch*head, q tile)
//   K6: dv = sum over queries of p * do,
//       dk = sum over queries of ds * q  (one block per batch*head, k tile).
// The TPU grid carried the accumulators in VMEM across its sequential
// inner axis; on Hopper each block loops over the other operand's tiles
// itself. That is the split the TPU kernels use, and it needs no
// cross-block reduction and no atomics, so a result is the same from run
// to run. Outputs are f32 (ring hops sum their pieces without rounding,
// flash_grads_partial :509-532) or the input dtype (flash_attention's own
// backward, :315-317), rounded once at the store.
//
// Masking and tile skipping come from flash_mask.cuh, the rule K4 uses:
// K5 stops at the first key tile no row of its q tile keeps; K6 starts at
// the q tile holding the first query that keeps its tile's first key. The
// causal offsets are scalars or a device int32 [B, 2] table (one launch per
// ring hop covers every stacked shard). Ragged tiles are masked, not
// padded: rows past Tq and keys past Tk load as zeros and are never kept.
//
// Bound on the H100. The products are 6 D (K5) and 8 D (K6) flops per
// kept pair. At the LM training shape (B=8, T=1024, H=8, D=64, causal)
// in bf16 that is 13 / 17 us at the tensor-core peak, under ~15 / 20 us
// of bytes; in f32 78 / 104 us at 3xTF32's 164.9 TFLOP/s, and 0.469 /
// 0.625 ms on an f32 LM-ring hop (B=8 stacked shards of T=2048, six
// seeing every key): operations.
//
// One kernel body per pass (dq_tiles, dkv_tiles), on the tensor cores for
// both input types; the type picks the product helpers:
//
// * bf16 inputs (both LM cells, the Ulysses path, flash_attention's VJP):
//   flash_dq_mma_kernel / flash_dkv_mma_kernel with flash_mma.cuh (shared
//   with K4): mma.sync.m16n8k16, fragments by ldmatrix. bf16 products are
//   exact in f32. The TPU kernels take the three accumulating products
//   from f32 P and dS; rounding P and dS once to bf16 (as
//   FlashAttention-2 does) misses this port's 5e-5 tolerance by 25-35x,
//   so they enter as a bf16 hi + lo pair (hi = bf16(x), lo = bf16(x -
//   hi)), two products into the same f32 accumulator: ~3e-6 of the
//   largest gradient, at the cost of one more product each.
// * f32 inputs (cli.train_lm's default dtype: the f32 LM steps, rings and
//   Ulysses): flash_dq_tf32_kernel / flash_dkv_tf32_kernel with
//   flash_tf32.cuh: mma.sync.m16n8k8 TF32, every operand of every product
//   (S, dP, dQ, dK, dV) as a TF32 hi + lo pair, three products each
//   (3xTF32), each 8-deep step summed apart and added to the accumulator
//   by an f32 add, where one TF32 product misses the 5e-5 bound by 6-23x
//   and the tensor cores' truncated sums drift over long rows. P and dS
//   feed the next product from their accumulator registers in a permuted
//   contraction order (flash_tf32.cuh).
//
// The shared structure: tiles stay in the input type in shared memory,
// rows padded by 16 bytes (conflict-free fragment reads: flash_mma.cuh,
// flash_tf32.cuh), filled by cp.async 16-byte copies, the visiting tile
// double-buffered so the next one loads while this one computes. Each
// warp owns 16 rows of the block's own 64-row tile, with f32 accumulators
// in registers. K5 computes S = Q.K^T and dP = dO.V^T and feeds dS
// straight from its accumulator registers into dQ += dS.K; K6 computes
// S^T = K.Q^T and dP^T = V.dO^T with the key tile as M, so P^T and dS^T
// are already the A operand of dV += P^T.dO and dK += dS^T.Q. Scores,
// exp, the lse guard and (dp - delta) * scale stay in f32; the mask is
// evaluated only on tiles that cross the causal diagonal, k_len or Tk.
// Tiles: K5 visits 64-key tiles and K6 64-query tiles (32 at D = 128,
// where two f32 accumulators of 16 x 128 per warp fill the registers);
// in f32, 32 (16 at D = 128).
#include "flash_mask.cuh"
#include "flash_mma.cuh"
#include "flash_tf32.cuh"

namespace {

using ps::bf16;
using ps::cp_async4;
using ps::cp_async_commit;
using ps::cp_async_wait;
using ps::gemm_abt;
using ps::gemm_split_ab;
using ps::load_rows;
using ps::rows_aligned;
using ps::store2;

constexpr int kBQ = 64;   // query rows per tile: K5's block, K6's visiting tile
constexpr int kBK = 64;   // keys per tile: K6's block, K5's visiting tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dq;
  void* dk;
  void* dv;
  const int* off;      // [B, 2] (q_off, k_off) rows, or null: the scalars
  int H, Tq, Tk;
  int k_len;
  int q_off, k_off;
  int causal;
  float scale;
  // batch, time, head strides of q, k, v, do, dq, dk, dv
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const long long* st,
                                             int b, int h) {
  return static_cast<const T*>(base) + b * st[0] + h * st[2];
}

template <typename T>
__device__ __forceinline__ T* out_ptr(void* base, const long long* st, int b, int h) {
  return static_cast<T*>(base) + b * st[0] + h * st[2];
}

// Shared rows: D plus 16 bytes of padding (flash_mma.cuh, flash_tf32.cuh).
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + (sizeof(T) == sizeof(bf16) ? ps::kPad : ps::kPad32);
}

// The [ROWS] f32 statistics of rows [r0, r0 + ROWS) into shared memory:
// lse and delta, with NEG_INF and 0 past Tq (the lse guard then zeroes p).
template <int ROWS>
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s, const float* lse,
                                           const float* delta, int r0, int Tq) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const int t = r0 + i;
    if (t < Tq) {
      cp_async4(lse_s + i, lse + t);
      cp_async4(delta_s + i, delta + t);
    } else {
      lse_s[i] = ps::kNegInf;
      delta_s[i] = 0.0f;
    }
  }
}

// The visiting tiles: K5's keys, K6's queries. bf16: 64, and 32 for K6
// at D = 128 (registers). f32 tiles take twice the bytes, and the 3xTF32
// steps a fresh accumulator each (flash_tf32.cuh): 32, and 16 at D = 128.
// On the H100 K6's 64-query f32 tile spilled 168 bytes at D = 64 and ran
// the ring hop in 5.37 ms, the 32-query tile 3.23 ms (PERF.md).
template <typename T, int D>
__host__ __device__ constexpr int dq_tile() {
  return sizeof(T) == sizeof(float) ? (D > 64 ? 16 : 32) : kBK;
}

template <typename T, int D>
__host__ __device__ constexpr int dkv_tile() {
  return sizeof(T) == sizeof(float) ? (D > 64 ? 16 : 32) : (D > 64 ? 32 : kBQ);
}

template <typename T, int D>
constexpr size_t dq_smem() {
  return (2 * (size_t)kBQ + 4 * (size_t)dq_tile<T, D>()) * pitch<T, D>() * sizeof(T);
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  return (2 * (size_t)kBK + 4 * (size_t)dkv_tile<T, D>()) * pitch<T, D>() * sizeof(T) +
         4 * (size_t)dkv_tile<T, D>() * sizeof(float);
}

// Blocks a multiprocessor should hold at once, which caps a thread's
// registers at 65536 / (128 n). bf16: at LM-1 on the H100 K5 ran faster
// with 4 (128 registers, a few spilled) than with ptxas's free choice of
// 166 (3 blocks), K6 with 3 (168) than with 235 (2); at D = 128 the
// accumulators need every register, so there is no cap. f32 (dq_smem
// and dkv_smem: 37 / 70 / 101 KB at D = 32 / 64 / 128): 3 blocks at D =
// 32, 2 at D = 64 (K5 with 3 spilled 40 bytes and took the ring hop in
// 2.65 ms, with 2 none and 2.46 ms), no cap at D = 128.
template <typename T, int D>
constexpr int dq_min_blocks() {
  return D > 64 ? 1 : (sizeof(T) == sizeof(bf16) ? 4 : (D == 32 ? 3 : 2));
}

template <typename T, int D>
constexpr int dkv_min_blocks() {
  return D > 64 ? 1 : (sizeof(T) == sizeof(bf16) || D == 32 ? 3 : 2);
}

// K5's tiles: one block per (batch*head, 64-row q tile), longest causal
// rows first; warp w owns rows [16 w, 16 w + 16) of it and loops over the
// visible key tiles.
template <typename T, int D, typename OutT>
__device__ __forceinline__ void dq_tiles(const BwdArgs& a, unsigned char* smem_bytes) {
  constexpr int P = pitch<T, D>();
  constexpr int BK = dq_tile<T, D>();
  T* qs = reinterpret_cast<T*>(smem_bytes);  // [kBQ][P]
  T* dos = qs + kBQ * P;                     // [kBQ][P]
  T* ks = dos + kBQ * P;                     // [2][BK][P]
  T* vs = ks + 2 * BK * P;                   // [2][BK][P]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);
  const T* kp = head_ptr<T>(a.k, a.sk, b, h);
  const T* vp = head_ptr<T>(a.v, a.sv, b, h);
  const int n_kt = (ps::key_limit(mask, min(q0 + kBQ, a.Tq)) + BK - 1) / BK;

  load_rows<D, kBQ, kThreads>(qs, head_ptr<T>(a.q, a.sq, b, h), a.sq[1], q0, a.Tq);
  load_rows<D, kBQ, kThreads>(dos, head_ptr<T>(a.dout, a.sdo, b, h), a.sdo[1], q0,
                              a.Tq);
  if (n_kt > 0) {
    load_rows<D, BK, kThreads>(ks, kp, a.sk[1], 0, a.Tk);
    load_rows<D, BK, kThreads>(vs, vp, a.sv[1], 0, a.Tk);
  }
  cp_async_commit();

  // this thread's rows: row0 (fragment slots 0, 1) and row0 + 8 (2, 3)
  const int row0 = q0 + warp * 16 + lane / 4;
  float lse[2], delta[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    lse[i] = t < a.Tq ? a.lse[(long long)bh * a.Tq + t] : ps::kNegInf;
    delta[i] = t < a.Tq ? a.delta[(long long)bh * a.Tq + t] : 0.0f;
    live[i] = lse[i] > ps::kNegInf * 0.5f;
  }

  float dq[D / 8][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const T* kst = ks + (kt & 1) * BK * P;
    const T* vst = vs + (kt & 1) * BK * P;
    if (kt + 1 < n_kt) {  // the next tile loads while this one computes
      const int nx = ((kt + 1) & 1) * BK * P;
      load_rows<D, BK, kThreads>(ks + nx, kp, a.sk[1], k0 + BK, a.Tk);
      load_rows<D, BK, kThreads>(vs + nx, vp, a.sv[1], k0 + BK, a.Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[BK / 8][4] = {};
    float ds[BK / 8][4] = {};
    gemm_abt<BK, D, P>(s, qs + warp * 16 * P, kst, lane);
    gemm_abt<BK, D, P>(ds, dos + warp * 16 * P, vst, lane);  // dP for now
    const bool interior = ps::tile_kept(mask, q0 + warp * 16, k0, BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
        const bool kept = live[i] && (interior || ps::keep(mask, row0 + 8 * i, key));
        const float p = kept ? expf(s[j][e] * a.scale - lse[i]) : 0.0f;
        ds[j][e] = p * (ds[j][e] - delta[i]) * a.scale;
      }
    }
    gemm_split_ab<BK, D, P>(dq, ds, kst, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // no visible key tile: the q tile's copies

  OutT* dqp = out_ptr<OutT>(a.dq, a.sdq, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    if (t >= a.Tq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dqp + (long long)t * a.sdq[1] + j * 8 + (lane % 4) * 2,
             dq[j][2 * i], dq[j][2 * i + 1]);
  }
}

// K6's tiles: one block per (batch*head, 64-key tile); warp w owns keys
// [16 w, 16 w + 16) of it and loops over BQ-query tiles from the first
// that keeps the tile's first key.
template <typename T, int D, typename OutT>
__device__ __forceinline__ void dkv_tiles(const BwdArgs& a, unsigned char* smem_bytes) {
  constexpr int P = pitch<T, D>();
  constexpr int BQ = dkv_tile<T, D>();
  T* ks = reinterpret_cast<T*>(smem_bytes);  // [kBK][P]
  T* vs = ks + kBK * P;                      // [kBK][P]
  T* qs = vs + kBK * P;                      // [2][BQ][P]
  T* dos = qs + 2 * BQ * P;                  // [2][BQ][P]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * P);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                             // [2][BQ]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);
  const T* qp = head_ptr<T>(a.q, a.sq, b, h);
  const T* dop = head_ptr<T>(a.dout, a.sdo, b, h);
  const float* lse = a.lse + (long long)bh * a.Tq;
  const float* delta = a.delta + (long long)bh * a.Tq;
  const int qt0 = ps::first_query(mask, k0, a.Tq) / BQ;
  const int n_qt = (a.Tq + BQ - 1) / BQ;

  load_rows<D, kBK, kThreads>(ks, head_ptr<T>(a.k, a.sk, b, h), a.sk[1], k0, a.Tk);
  load_rows<D, kBK, kThreads>(vs, head_ptr<T>(a.v, a.sv, b, h), a.sv[1], k0, a.Tk);
  if (qt0 < n_qt) {
    load_rows<D, BQ, kThreads>(qs, qp, a.sq[1], qt0 * BQ, a.Tq);
    load_rows<D, BQ, kThreads>(dos, dop, a.sdo[1], qt0 * BQ, a.Tq);
    load_stats<BQ>(lse_s, delta_s, lse, delta, qt0 * BQ, a.Tq);
  }
  cp_async_commit();

  // this thread's keys: key0 (fragment slots 0, 1) and key0 + 8 (2, 3)
  const int key0 = k0 + warp * 16 + lane / 4;
  float dk[D / 8][4] = {};
  float dv[D / 8][4] = {};
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    const int st = (qt - qt0) & 1;
    const T* qst = qs + st * BQ * P;
    const T* dost = dos + st * BQ * P;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    if (qt + 1 < n_qt) {  // the next tile loads while this one computes
      const int nx = (st ^ 1) * BQ;
      load_rows<D, BQ, kThreads>(qs + nx * P, qp, a.sq[1], q0 + BQ, a.Tq);
      load_rows<D, BQ, kThreads>(dos + nx * P, dop, a.sdo[1], q0 + BQ, a.Tq);
      load_stats<BQ>(lse_s + nx, delta_s + nx, lse, delta, q0 + BQ, a.Tq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float p[BQ / 8][4] = {};
    float ds[BQ / 8][4] = {};
    gemm_abt<BQ, D, P>(p, ks + warp * 16 * P, qst, lane);    // S^T for now
    gemm_abt<BQ, D, P>(ds, vs + warp * 16 * P, dost, lane);  // dP^T for now
    const bool interior = ps::tile_kept(mask, q0, k0 + warp * 16, 16);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + (lane % 4) * 2 + (e & 1);  // query within the tile
        const float l = lse_t[c];
        const bool kept = l > ps::kNegInf * 0.5f &&
                          (interior || ps::keep(mask, q0 + c, key0 + 8 * (e / 2)));
        const float pe = kept ? expf(p[j][e] * a.scale - l) : 0.0f;
        p[j][e] = pe;
        ds[j][e] = pe * (ds[j][e] - delta_t[c]) * a.scale;
      }
    }
    gemm_split_ab<BQ, D, P>(dv, p, dost, lane);
    gemm_split_ab<BQ, D, P>(dk, ds, qst, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  OutT* dkp = out_ptr<OutT>(a.dk, a.sdk, b, h);
  OutT* dvp = out_ptr<OutT>(a.dv, a.sdv, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      store2(dkp + (long long)key * a.sdk[1] + col, dk[j][2 * i], dk[j][2 * i + 1]);
      store2(dvp + (long long)key * a.sdv[1] + col, dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The kernels: bf16 inputs (f32 or bf16 gradients), f32 inputs (f32
// gradients).

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, (dq_min_blocks<bf16, D>()))
    flash_dq_mma_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  dq_tiles<bf16, D, OutT>(a, smem_bytes);
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, (dkv_min_blocks<bf16, D>()))
    flash_dkv_mma_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  dkv_tiles<bf16, D, OutT>(a, smem_bytes);
}

template <int D>
__global__ void __launch_bounds__(kThreads, (dq_min_blocks<float, D>()))
    flash_dq_tf32_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  dq_tiles<float, D, float>(a, smem_bytes);
}

template <int D>
__global__ void __launch_bounds__(kThreads, (dkv_min_blocks<float, D>()))
    flash_dkv_tf32_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  dkv_tiles<float, D, float>(a, smem_bytes);
}

// ---------------------------------------------------------------------------
// Launch.

template <typename K>
int launch_kernel(K kernel, size_t bytes, dim3 grid, const BwdArgs& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

dim3 grid_of(const BwdArgs& a, int B, bool dq) {
  return dim3((unsigned)(((dq ? a.Tq : a.Tk) + 63) / 64), (unsigned)(B * a.H));
}

template <int D, typename OutT>
int launch_mma(const BwdArgs& a, int B, bool dq, cudaStream_t s) {
  if (dq)
    return launch_kernel(flash_dq_mma_kernel<D, OutT>, dq_smem<bf16, D>(),
                         grid_of(a, B, true), a, s);
  return launch_kernel(flash_dkv_mma_kernel<D, OutT>, dkv_smem<bf16, D>(),
                       grid_of(a, B, false), a, s);
}

template <int D>
int launch_tf32(const BwdArgs& a, int B, bool dq, cudaStream_t s) {
  if (dq)
    return launch_kernel(flash_dq_tf32_kernel<D>, dq_smem<float, D>(),
                         grid_of(a, B, true), a, s);
  return launch_kernel(flash_dkv_tf32_kernel<D>, dkv_smem<float, D>(),
                       grid_of(a, B, false), a, s);
}

template <typename OutT>
int launch_mma_d(const BwdArgs& a, int B, int D, bool dq, cudaStream_t s) {
  switch (D) {
    case 32: return launch_mma<32, OutT>(a, B, dq, s);
    case 64: return launch_mma<64, OutT>(a, B, dq, s);
    case 128: return launch_mma<128, OutT>(a, B, dq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_tf32_d(const BwdArgs& a, int B, int D, bool dq, cudaStream_t s) {
  switch (D) {
    case 32: return launch_tf32<32>(a, B, dq, s);
    case 64: return launch_tf32<64>(a, B, dq, s);
    case 128: return launch_tf32<128>(a, B, dq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const BwdArgs& a, int dtype, int out_f32, int B, int D, bool dq,
             cudaStream_t s) {
  const bool f32 = dtype == ps::kFloat32;
  if (!f32 && dtype != ps::kBFloat16) return (int)cudaErrorInvalidValue;
  if (f32 && !out_f32) return (int)cudaErrorInvalidValue;  // f32 inputs give f32 gradients
  const int vec = f32 ? 4 : 8;  // elements in 16 bytes
  const bool in_ok = rows_aligned(a.q, a.sq, vec) && rows_aligned(a.k, a.sk, vec) &&
                     rows_aligned(a.v, a.sv, vec) && rows_aligned(a.dout, a.sdo, vec);
  const bool out_ok = dq ? rows_aligned(a.dq, a.sdq, vec)
                         : rows_aligned(a.dk, a.sdk, vec) && rows_aligned(a.dv, a.sdv, vec);
  if (!in_ok || !out_ok) return (int)cudaErrorMisalignedAddress;
  if (f32) return launch_tf32_d(a, B, D, dq, s);
  return out_f32 ? launch_mma_d<float>(a, B, D, dq, s) : launch_mma_d<bf16>(a, B, D, dq, s);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, int H, int Tq, int Tk,
                  const long long* strides, float scale, int causal, int k_len,
                  const void* off, int q_off, int k_off) {
  BwdArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.off = static_cast<const int*>(off);
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.k_len = k_len;
  a.q_off = q_off;
  a.k_off = k_off;
  a.causal = causal;
  a.scale = scale;
  long long* dst[4] = {a.sq, a.sk, a.sv, a.sdo};
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  return a;
}

bool bad_shape(int B, int H, int Tq, int Tk) {
  return (long long)B * H > 65535 || Tq < 0 || Tk < 0;
}

}  // namespace

// strides: int64 element strides, (batch, time, head) for q, k, v, do and
// then the outputs (dq; or dk, dv) in that order: 15 for the dq entry, 18
// for the dk/dv entry; the head-dim stride must be 1 (the wrapper checks)
// and every row 16-byte aligned (cudaErrorMisalignedAddress otherwise).
// lse, delta: f32 [B, H, Tq] contiguous. out_f32 != 0 writes the
// gradients in f32, else in the input dtype (bf16 inputs only: f32 inputs
// give f32 gradients). off: null, or a device int32 [B, 2] table of
// (q_off, k_off) that then replaces the scalars.
extern "C" int ps_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               void* dq, int dtype, int out_f32, int B, int H,
                               int Tq, int Tk, int D, const long long* strides,
                               float scale, int causal, int k_len, const void* off,
                               int q_off, int k_off, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return (int)cudaSuccess;
  if (bad_shape(B, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  BwdArgs a = make_args(q, k, v, dout, lse, delta, H, Tq, Tk, strides, scale,
                        causal, k_len, off, q_off, k_off);
  a.dq = dq;
  for (int i = 0; i < 3; ++i) a.sdq[i] = strides[12 + i];
  return dispatch(a, dtype, out_f32, B, D, true, static_cast<cudaStream_t>(stream));
}

extern "C" int ps_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dk, void* dv, int dtype, int out_f32, int B,
                                int H, int Tq, int Tk, int D,
                                const long long* strides, float scale, int causal,
                                int k_len, const void* off, int q_off, int k_off,
                                void* stream) {
  if (B <= 0 || H <= 0 || Tk <= 0) return (int)cudaSuccess;
  if (bad_shape(B, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  BwdArgs a = make_args(q, k, v, dout, lse, delta, H, Tq, Tk, strides, scale,
                        causal, k_len, off, q_off, k_off);
  a.dk = dk;
  a.dv = dv;
  for (int i = 0; i < 3; ++i) {
    a.sdk[i] = strides[12 + i];
    a.sdv[i] = strides[15 + i];
  }
  return dispatch(a, dtype, out_f32, B, D, false, static_cast<cudaStream_t>(stream));
}
