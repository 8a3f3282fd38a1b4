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
// backward, :315-317).
//
// Masking and tile skipping come from flash_mask.cuh, the rule K4 uses:
// K5 stops at the first key tile no row of its q tile keeps; K6 starts at
// the q tile holding the first query that keeps its tile's first key. The
// causal offsets are scalars or a device int32 [B, 2] table (one launch per
// ring hop covers every stacked shard). Ragged tiles are masked, not
// padded: rows past Tq and keys past Tk load as zeros and are never kept.
//
// Bound on the H100 at the LM training shape (B=8, T=1024, H=8, D=64,
// bf16 in, f32 out, causal): bytes, K5 ~15 us, K6 ~20 us at 3.35 TB/s.
// This first version is simple and right: scalar f32 FMAs on the CUDA
// cores (3 D FMAs per kept pair for K5, 4 D for K6), one warp per row of
// its own tile and one lane per row of the visiting tile, as K4 does.
// Shared memory at D = 128: K5 161 KB, K6 193 KB (under the 227 KB opt-in
// limit, set with cudaFuncSetAttribute). wgmma/TMA are later work.
#include "flash_mask.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per tile
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

// Stage rows [r0, r0 + n) of a [T, D] head slice into smem rows of pitch P
// (zeros past T).
template <typename T, int D, int P>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st,
                                      int r0, int n, int T_len) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i % D, t = r0 + r;
    dst[r * P + d] = t < T_len ? ps::to_float(src[(long long)t * st + d]) : 0.0f;
  }
}

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
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
  const T* kp = head_ptr<T>(a.k, a.sk, b, h);
  const T* vp = head_ptr<T>(a.v, a.sv, b, h);

  stage<T, D, D>(qs, head_ptr<T>(a.q, a.sq, b, h), a.sq[1], q0, kBQ, a.Tq);
  stage<T, D, D>(dos, head_ptr<T>(a.dout, a.sdo, b, h), a.sdo[1], q0, kBQ, a.Tq);
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
    stage<T, D, D + 1>(ks, kp, a.sk[1], k0, kBK, a.Tk);
    stage<T, D, D + 1>(vs, vp, a.sv[1], k0, kBK, a.Tk);
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

  OutT* dqp = static_cast<OutT*>(a.dq) + b * a.sdq[0] + h * a.sdq[2];
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    if (t < a.Tq) dqp[(long long)t * a.sdq[1] + d] = ps::from_float<OutT>(dqs[i]);
  }
}

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(BwdArgs a) {
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
  const T* qp = head_ptr<T>(a.q, a.sq, b, h);
  const T* dop = head_ptr<T>(a.dout, a.sdo, b, h);

  stage<T, D, D>(ks, head_ptr<T>(a.k, a.sk, b, h), a.sk[1], k0, kBK, a.Tk);
  stage<T, D, D>(vs, head_ptr<T>(a.v, a.sv, b, h), a.sv[1], k0, kBK, a.Tk);
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    dks[i] = 0.0f;
    dvs[i] = 0.0f;
  }

  const int qt0 = ps::first_query(mask, k0, a.Tq) / kBQ;
  const int n_qt = (a.Tq + kBQ - 1) / kBQ;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile is consumed (and the init done)
    stage<T, D, D + 1>(qs, qp, a.sq[1], q0, kBQ, a.Tq);
    stage<T, D, D + 1>(dos, dop, a.sdo[1], q0, kBQ, a.Tq);
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

  OutT* dkp = static_cast<OutT*>(a.dk) + b * a.sdk[0] + h * a.sdk[2];
  OutT* dvp = static_cast<OutT*>(a.dv) + b * a.sdv[0] + h * a.sdv[2];
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D, key = k0 + r;
    if (key < a.Tk) {
      dkp[(long long)key * a.sdk[1] + d] = ps::from_float<OutT>(dks[i]);
      dvp[(long long)key * a.sdv[1] + d] = ps::from_float<OutT>(dvs[i]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 3 * (size_t)kBQ * D + 2 * (size_t)kBK * (D + 1) + 2 * kBQ;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)kBK * D + 2 * (size_t)kBQ * (D + 1) + 2 * kBQ;
}

template <typename K>
int launch_kernel(K kernel, size_t bytes, dim3 grid, const BwdArgs& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT, int D>
int launch(const BwdArgs& a, int B, bool dq, cudaStream_t s) {
  if (dq) {
    const dim3 grid((unsigned)((a.Tq + kBQ - 1) / kBQ), (unsigned)(B * a.H));
    return launch_kernel(flash_dq_kernel<T, OutT, D>,
                         dq_smem_floats<D>() * sizeof(float), grid, a, s);
  }
  const dim3 grid((unsigned)((a.Tk + kBK - 1) / kBK), (unsigned)(B * a.H));
  return launch_kernel(flash_dkv_kernel<T, OutT, D>,
                       dkv_smem_floats<D>() * sizeof(float), grid, a, s);
}

template <typename T, typename OutT>
int launch_d(const BwdArgs& a, int B, int D, bool dq, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, OutT, 32>(a, B, dq, s);
    case 64: return launch<T, OutT, 64>(a, B, dq, s);
    case 128: return launch<T, OutT, 128>(a, B, dq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const BwdArgs& a, int dtype, int out_f32, int B, int D, bool dq,
             cudaStream_t s) {
  if (dtype == ps::kFloat32) return launch_d<float, float>(a, B, D, dq, s);
  if (dtype == ps::kBFloat16) {
    return out_f32 ? launch_d<__nv_bfloat16, float>(a, B, D, dq, s)
                   : launch_d<__nv_bfloat16, __nv_bfloat16>(a, B, D, dq, s);
  }
  return (int)cudaErrorInvalidValue;
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
// for the dk/dv entry; the head-dim stride must be 1 (the wrapper checks). lse, delta: f32 [B, H, Tq] contiguous. out_f32 != 0 writes the
// gradients in f32, else in the input dtype. off: null, or a device int32
// [B, 2] table of (q_off, k_off) that then replaces the scalars.
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
