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
// Bound on the H100 at the LM training shape (B=8, T=1024, H=8, D=64,
// bf16 in, f32 out, causal): bytes, K5 ~15 us, K6 ~20 us at 3.35 TB/s;
// the products are 6 D (K5) and 8 D (K6) flops per kept pair, 0.078 /
// 0.104 ms at the bf16 tensor-core peak. Two routes, chosen by dtype:
//
// * bf16 inputs (both LM cells, the Ulysses path, flash_attention's VJP):
//   the tensor-core kernels flash_dq_mma_kernel / flash_dkv_mma_kernel,
//   built from flash_mma.cuh (shared with K4's forward). Tiles stay bf16 in shared memory (rows padded by 16 bytes, so the 8
//   rows an ldmatrix phase reads fall in 8 different bank groups), filled
//   by cp.async 16-byte copies, the visiting tile double-buffered so the
//   next one loads while this one computes. Each warp owns 16 rows of the
//   block's own 64-row tile; every product is mma.sync.m16n8k16 (bf16 in,
//   f32 accumulators in registers, fragments by ldmatrix). K5 computes
//   S = Q.K^T and dP = dO.V^T and feeds dS straight from its accumulator
//   registers into dQ += dS.K; K6 computes S^T = K.Q^T and dP^T = V.dO^T
//   with the key tile as M, so P^T and dS^T are already the A operand of
//   dV += P^T.dO and dK += dS^T.Q. The TPU kernels take those three
//   accumulating products from f32 P and dS; rounding P and dS once to
//   bf16 (as FlashAttention-2 does) misses this port's 5e-5 tolerance by
//   25-35x, so they enter as a bf16 hi + lo pair (hi = bf16(x), lo =
//   bf16(x - hi)), two products into the same f32 accumulator: ~3e-6 of
//   the largest gradient, at the cost of one more product each. Scores,
//   exp, the lse guard and (dp - delta) * scale stay in f32; the mask is
//   evaluated only on tiles that cross the causal diagonal, k_len or Tk.
//   K6 visits 64-query tiles at D <= 64 and 32-query tiles at D = 128,
//   where two f32 accumulators of 16 x 128 per warp fill the registers.
// * f32 inputs (the f32 ring steps and card tests; on no timed path): the
//   scalar kernels flash_dq_scalar_kernel / flash_dkv_scalar_kernel, f32
//   FMAs on the CUDA cores, one warp per row of the block's own tile and
//   one lane per row of the visiting tile.
#include "flash_mask.cuh"
#include "flash_mma.cuh"

namespace {

using ps::bf16;
using ps::cp_async4;
using ps::cp_async_commit;
using ps::cp_async_wait;
using ps::gemm_abt;
using ps::gemm_split_ab;
using ps::kPad;
using ps::load_rows;
using ps::rows_aligned;
using ps::store2;

constexpr int kBQ = 64;   // query rows per tile (K6 at D = 128: 32)
constexpr int kBK = 64;   // keys per tile
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

// ---------------------------------------------------------------------------
// f32 inputs: the scalar kernels (CUDA cores).

// Stage rows [r0, r0 + n) of a [T, D] f32 head slice into smem rows of
// pitch P (zeros past T).
template <int D, int P>
__device__ __forceinline__ void stage(float* dst, const float* src, long long st,
                                      int r0, int n, int T_len) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i % D, t = r0 + r;
    dst[r * P + d] = t < T_len ? src[(long long)t * st + d] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_scalar_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][D]      (broadcast reads)
  float* dos = qs + kBQ * D;          // [kBQ][D]
  float* ks = dos + kBQ * D;          // [kBK][D + 1]  (one key row per lane)
  float* vs = ks + kBK * (D + 1);     // [kBK][D + 1]
  float* dqs = vs + kBK * (D + 1);    // [kBQ][D]      f32 accumulator
  float* lse_s = dqs + kBQ * D;       // [kBQ]
  float* delta_s = lse_s + kBQ;       // [kBQ]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);
  const float* kp = head_ptr<float>(a.k, a.sk, b, h);
  const float* vp = head_ptr<float>(a.v, a.sv, b, h);

  stage<D, D>(qs, head_ptr<float>(a.q, a.sq, b, h), a.sq[1], q0, kBQ, a.Tq);
  stage<D, D>(dos, head_ptr<float>(a.dout, a.sdo, b, h), a.sdo[1], q0, kBQ, a.Tq);
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) dqs[i] = 0.0f;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int t = q0 + r;
    lse_s[r] = t < a.Tq ? a.lse[(long long)bh * a.Tq + t] : ps::kNegInf;
    delta_s[r] = t < a.Tq ? a.delta[(long long)bh * a.Tq + t] : 0.0f;
  }

  const int n_keys = ps::key_limit(mask, min(q0 + kBQ, a.Tq));
  const int n_kt = (n_keys + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and the init done)
    stage<D, D + 1>(ks, kp, a.sk[1], k0, kBK, a.Tk);
    stage<D, D + 1>(vs, vp, a.sv[1], k0, kBK, a.Tk);
    __syncthreads();

    for (int r = warp; r < kBQ; r += kWarps) {
      const int t = q0 + r;
      if (t >= a.Tq) break;  // rows ascend; the whole warp agrees
      const float* qr = qs + r * D;
      const float* dor = dos + r * D;
      const float lse = lse_s[r], delta = delta_s[r];
      const bool live = lse > ps::kNegInf * 0.5f;
      float ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const float* kr = ks + j * (D + 1);
        const float* vr = vs + j * (D + 1);
        float s = 0.0f, dp = 0.0f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(dor[d], vr[d], dp);
        }
        const float p =
            live && ps::keep(mask, t, k0 + j) ? expf(s * a.scale - lse) : 0.0f;
        ds[u] = p * (dp - delta) * a.scale;
      }
      // lane owns dq columns lane, lane + 32, ...
      float acc[D / 32];
      float* ar = dqs + r * D;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[i] = ar[lane + 32 * i];
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const float da = __shfl_sync(ps::kFullMask, ds[0], j);
        const float db = __shfl_sync(ps::kFullMask, ds[1], j);
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          acc[i] = fmaf(da, ks[j * (D + 1) + lane + 32 * i], acc[i]);
          acc[i] = fmaf(db, ks[(j + 32) * (D + 1) + lane + 32 * i], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) ar[lane + 32 * i] = acc[i];
    }
  }
  __syncthreads();

  float* dqp = out_ptr<float>(a.dq, a.sdq, b, h);
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    if (t < a.Tq) dqp[(long long)t * a.sdq[1] + d] = dqs[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_scalar_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* ks = smem;                   // [kBK][D]      (broadcast reads)
  float* vs = ks + kBK * D;           // [kBK][D]
  float* qs = vs + kBK * D;           // [kBQ][D + 1]  (one query row per lane)
  float* dos = qs + kBQ * (D + 1);    // [kBQ][D + 1]
  float* dks = dos + kBQ * (D + 1);   // [kBK][D]      f32 accumulators
  float* dvs = dks + kBK * D;         // [kBK][D]
  float* lse_s = dvs + kBK * D;       // [kBQ]
  float* delta_s = lse_s + kBQ;       // [kBQ]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);
  const float* qp = head_ptr<float>(a.q, a.sq, b, h);
  const float* dop = head_ptr<float>(a.dout, a.sdo, b, h);

  stage<D, D>(ks, head_ptr<float>(a.k, a.sk, b, h), a.sk[1], k0, kBK, a.Tk);
  stage<D, D>(vs, head_ptr<float>(a.v, a.sv, b, h), a.sv[1], k0, kBK, a.Tk);
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    dks[i] = 0.0f;
    dvs[i] = 0.0f;
  }

  const int qt0 = ps::first_query(mask, k0, a.Tq) / kBQ;
  const int n_qt = (a.Tq + kBQ - 1) / kBQ;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile is consumed (and the init done)
    stage<D, D + 1>(qs, qp, a.sq[1], q0, kBQ, a.Tq);
    stage<D, D + 1>(dos, dop, a.sdo[1], q0, kBQ, a.Tq);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const int t = q0 + r;
      lse_s[r] = t < a.Tq ? a.lse[(long long)bh * a.Tq + t] : ps::kNegInf;
      delta_s[r] = t < a.Tq ? a.delta[(long long)bh * a.Tq + t] : 0.0f;
    }
    __syncthreads();

    for (int jr = warp; jr < kBK; jr += kWarps) {
      const int key = k0 + jr;
      if (key >= a.Tk) break;  // keys ascend; the whole warp agrees
      const float* kr = ks + jr * D;
      const float* vr = vs + jr * D;
      float p[2], ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = lane + 32 * u, t = q0 + i;
        const float* qr = qs + i * (D + 1);
        const float* dor = dos + i * (D + 1);
        float s = 0.0f, dp = 0.0f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(dor[d], vr[d], dp);
        }
        const float lse = lse_s[i];
        const bool kept = t < a.Tq && lse > ps::kNegInf * 0.5f && ps::keep(mask, t, key);
        p[u] = kept ? expf(s * a.scale - lse) : 0.0f;
        ds[u] = p[u] * (dp - delta_s[i]) * a.scale;
      }
      // lane owns dk/dv columns lane, lane + 32, ...
      float dk[D / 32], dv[D / 32];
      float* dkr = dks + jr * D;
      float* dvr = dvs + jr * D;
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        dk[m] = dkr[lane + 32 * m];
        dv[m] = dvr[lane + 32 * m];
      }
#pragma unroll 4
      for (int i = 0; i < 32; ++i) {
        const float pa = __shfl_sync(ps::kFullMask, p[0], i);
        const float pb = __shfl_sync(ps::kFullMask, p[1], i);
        const float da = __shfl_sync(ps::kFullMask, ds[0], i);
        const float db = __shfl_sync(ps::kFullMask, ds[1], i);
#pragma unroll
        for (int m = 0; m < D / 32; ++m) {
          const int c = lane + 32 * m;
          dv[m] = fmaf(pa, dos[i * (D + 1) + c], dv[m]);
          dv[m] = fmaf(pb, dos[(i + 32) * (D + 1) + c], dv[m]);
          dk[m] = fmaf(da, qs[i * (D + 1) + c], dk[m]);
          dk[m] = fmaf(db, qs[(i + 32) * (D + 1) + c], dk[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        dkr[lane + 32 * m] = dk[m];
        dvr[lane + 32 * m] = dv[m];
      }
    }
  }
  __syncthreads();

  float* dkp = out_ptr<float>(a.dk, a.sdk, b, h);
  float* dvp = out_ptr<float>(a.dv, a.sdv, b, h);
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D, key = k0 + r;
    if (key < a.Tk) {
      dkp[(long long)key * a.sdk[1] + d] = dks[i];
      dvp[(long long)key * a.sdv[1] + d] = dvs[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the tensor-core kernels.

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

// Blocks a multiprocessor should hold at once, which caps a thread's
// registers at 65536 / (128 n). At LM-1 on the H100 K5 ran faster with 4
// (128 registers, a few spilled) than with ptxas's free choice of 166 (3
// blocks), K6 with 3 (168) than with 235 (2); at D = 128 the accumulators
// need every register, so there is no cap.
template <int D>
constexpr int dq_min_blocks() {
  return D > 64 ? 1 : 4;
}

template <int D>
constexpr int dkv_min_blocks() {
  return D > 64 ? 1 : 3;
}

// K5 on the tensor cores: one block per (batch*head, 64-row q tile); warp
// w owns rows [16 w, 16 w + 16) of it and loops over the visible key tiles.
template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, dq_min_blocks<D>())
    flash_dq_mma_kernel(BwdArgs a) {
  constexpr int P = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bytes);  // [kBQ][P]
  bf16* dos = qs + kBQ * P;                        // [kBQ][P]
  bf16* ks = dos + kBQ * P;                        // [2][kBK][P]
  bf16* vs = ks + 2 * kBK * P;                     // [2][kBK][P]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);
  const bf16* kp = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* vp = head_ptr<bf16>(a.v, a.sv, b, h);
  const int n_kt = (ps::key_limit(mask, min(q0 + kBQ, a.Tq)) + kBK - 1) / kBK;

  load_rows<D, kBQ, kThreads>(qs, head_ptr<bf16>(a.q, a.sq, b, h), a.sq[1], q0, a.Tq);
  load_rows<D, kBQ, kThreads>(dos, head_ptr<bf16>(a.dout, a.sdo, b, h), a.sdo[1], q0,
                              a.Tq);
  if (n_kt > 0) {
    load_rows<D, kBK, kThreads>(ks, kp, a.sk[1], 0, a.Tk);
    load_rows<D, kBK, kThreads>(vs, vp, a.sv[1], 0, a.Tk);
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
    const int k0 = kt * kBK;
    const bf16* kst = ks + (kt & 1) * kBK * P;
    const bf16* vst = vs + (kt & 1) * kBK * P;
    if (kt + 1 < n_kt) {  // the next tile loads while this one computes
      const int nx = ((kt + 1) & 1) * kBK * P;
      load_rows<D, kBK, kThreads>(ks + nx, kp, a.sk[1], k0 + kBK, a.Tk);
      load_rows<D, kBK, kThreads>(vs + nx, vp, a.sv[1], k0 + kBK, a.Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kBK / 8][4] = {};
    float ds[kBK / 8][4] = {};
    gemm_abt<kBK, D, P>(s, qs + warp * 16 * P, kst, lane);
    gemm_abt<kBK, D, P>(ds, dos + warp * 16 * P, vst, lane);  // dP for now
    const bool interior = ps::tile_kept(mask, q0 + warp * 16, k0, kBK);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
        const bool kept = live[i] && (interior || ps::keep(mask, row0 + 8 * i, key));
        const float p = kept ? expf(s[j][e] * a.scale - lse[i]) : 0.0f;
        ds[j][e] = p * (ds[j][e] - delta[i]) * a.scale;
      }
    }
    gemm_split_ab<kBK, D, P>(dq, ds, kst, lane);
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

// K6 on the tensor cores: one block per (batch*head, 64-key tile); warp w
// owns keys [16 w, 16 w + 16) of it and loops over BQ-query tiles from
// the first that keeps the tile's first key.
template <int D, int BQ, typename OutT>
__global__ void __launch_bounds__(kThreads, dkv_min_blocks<D>())
    flash_dkv_mma_kernel(BwdArgs a) {
  constexpr int P = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* ks = reinterpret_cast<bf16*>(smem_bytes);  // [kBK][P]
  bf16* vs = ks + kBK * P;                         // [kBK][P]
  bf16* qs = vs + kBK * P;                         // [2][BQ][P]
  bf16* dos = qs + 2 * BQ * P;                     // [2][BQ][P]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * P);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                             // [2][BQ]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);
  const bf16* qp = head_ptr<bf16>(a.q, a.sq, b, h);
  const bf16* dop = head_ptr<bf16>(a.dout, a.sdo, b, h);
  const float* lse = a.lse + (long long)bh * a.Tq;
  const float* delta = a.delta + (long long)bh * a.Tq;
  const int qt0 = ps::first_query(mask, k0, a.Tq) / BQ;
  const int n_qt = (a.Tq + BQ - 1) / BQ;

  load_rows<D, kBK, kThreads>(ks, head_ptr<bf16>(a.k, a.sk, b, h), a.sk[1], k0, a.Tk);
  load_rows<D, kBK, kThreads>(vs, head_ptr<bf16>(a.v, a.sv, b, h), a.sv[1], k0, a.Tk);
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
    const bf16* qst = qs + st * BQ * P;
    const bf16* dost = dos + st * BQ * P;
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
// Launch.

template <int D>
constexpr size_t dq_scalar_smem() {
  return (3 * (size_t)kBQ * D + 2 * (size_t)kBK * (D + 1) + 2 * kBQ) * sizeof(float);
}

template <int D>
constexpr size_t dkv_scalar_smem() {
  return (4 * (size_t)kBK * D + 2 * (size_t)kBQ * (D + 1) + 2 * kBQ) * sizeof(float);
}

// K6's query tile on the tensor-core route: 32 at D = 128 (registers)
template <int D>
constexpr int dkv_tile() {
  return D > 64 ? 32 : 64;
}

template <int D>
constexpr size_t dq_mma_smem() {
  return (2 * (size_t)kBQ + 4 * (size_t)kBK) * (D + kPad) * sizeof(bf16);
}

template <int D>
constexpr size_t dkv_mma_smem() {
  return (2 * (size_t)kBK + 4 * (size_t)dkv_tile<D>()) * (D + kPad) * sizeof(bf16) +
         4 * (size_t)dkv_tile<D>() * sizeof(float);
}

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

template <int D>
int launch_scalar(const BwdArgs& a, int B, bool dq, cudaStream_t s) {
  if (dq)
    return launch_kernel(flash_dq_scalar_kernel<D>, dq_scalar_smem<D>(),
                         grid_of(a, B, true), a, s);
  return launch_kernel(flash_dkv_scalar_kernel<D>, dkv_scalar_smem<D>(),
                       grid_of(a, B, false), a, s);
}

template <int D, typename OutT>
int launch_mma(const BwdArgs& a, int B, bool dq, cudaStream_t s) {
  if (dq)
    return launch_kernel(flash_dq_mma_kernel<D, OutT>, dq_mma_smem<D>(),
                         grid_of(a, B, true), a, s);
  return launch_kernel(flash_dkv_mma_kernel<D, dkv_tile<D>(), OutT>, dkv_mma_smem<D>(),
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

int launch_scalar_d(const BwdArgs& a, int B, int D, bool dq, cudaStream_t s) {
  switch (D) {
    case 32: return launch_scalar<32>(a, B, dq, s);
    case 64: return launch_scalar<64>(a, B, dq, s);
    case 128: return launch_scalar<128>(a, B, dq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const BwdArgs& a, int dtype, int out_f32, int B, int D, bool dq,
             cudaStream_t s) {
  if (dtype == ps::kFloat32)  // f32 inputs give f32 gradients
    return out_f32 ? launch_scalar_d(a, B, D, dq, s) : (int)cudaErrorInvalidValue;
  if (dtype != ps::kBFloat16) return (int)cudaErrorInvalidValue;
  const bool in_ok = rows_aligned(a.q, a.sq) && rows_aligned(a.k, a.sk) &&
                     rows_aligned(a.v, a.sv) && rows_aligned(a.dout, a.sdo);
  const bool out_ok = dq ? rows_aligned(a.dq, a.sdq)
                         : rows_aligned(a.dk, a.sdk) && rows_aligned(a.dv, a.sdv);
  if (!in_ok || !out_ok) return (int)cudaErrorMisalignedAddress;
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
// for the dk/dv entry; the head-dim stride must be 1 (the wrapper checks);
// bf16 inputs also need 16-byte-aligned rows (cudaErrorMisalignedAddress
// otherwise). lse, delta: f32 [B, H, Tq] contiguous. out_f32 != 0 writes
// the gradients in f32, else in the input dtype. off: null, or a device
// int32 [B, 2] table of (q_off, k_off) that then replaces the scalars.
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
