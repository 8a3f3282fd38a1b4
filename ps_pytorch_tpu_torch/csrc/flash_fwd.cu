// K4 flash_fwd: blockwise online-softmax attention forward, normalized or
// as the unnormalized partial triple of one ring hop.
//
// Replaces ps_pytorch_tpu/ops/flash_attention.py:_make_fwd_kernel
// (launched by _flash_fwd, flash_attention.py:199): normalize=True gives
// (o, lse) for flash_attention and the serving prefill; normalize=False
// gives (pv, m, l) in f32 for each hop of ring_flash_attention
// (flash_partial, :483; the finalize at :136-140). The TPU grid walked
// (batch*head, q block, k block) in order and carried (acc, m, l) in VMEM
// scratch across the k steps. Blocks on Hopper run in no order, so here
// ONE block owns (batch*head, 64-row q tile) and loops over the k tiles
// itself, staging each K/V tile in shared memory.
//
// Semantics kept from the TPU kernel: f32 scores = (q . k) * scale, p kept
// in f32 for the PV product (no cast to v's dtype — that cast belongs to
// the naive full_attention only), the finite NEG_INF = -1e30 and the
// m > NEG_INF / 2 guard for rows whose keys are all masked, l == 0 -> 1 in
// the normalized finalize, so such rows give o = 0 and lse = NEG_INF (and
// the triple pv = 0, m = NEG_INF, l = 0). Which pairs are kept and which
// key tiles are skipped is decided by flash_mask.cuh, shared with K5/K6.
//
// What changed from the TPU version: [B, T, H, D] is read through its
// strides, so the fold/transpose copies of flash_attention.py:466-467 go
// away; ragged tiles are masked here instead of padding T up to the block
// grid (_plan_blocks); k tiles wholly above the causal diagonal are
// skipped (their contribution is exactly nothing: alpha = 1, p = 0); the
// causal offsets may come from a device table, one row per batch index,
// so one launch serves every stacked shard of a ring hop.
//
// Bound on the H100: bytes at the serving prefill shape (B=1, T=128, H=8,
// D=64, bf16: ~0.53 MB of q/k/v/o, ~0.16 us at 3.35 TB/s) and at the LM
// training shape (B=8, T=1024, H=8, D=64: q/k/v bf16 in, pv/m/l f32 out,
// ~42 MB, ~13 us). This first version is simple and right rather than
// fast: scalar f32 FMAs on the CUDA cores (the causal LM-1 hop does ~8.6
// GFLOP of them), so the CUDA-core rate and the serial k loop set its
// time. wgmma/TMA and a warp-specialised pipeline are later work.
#include "flash_mask.cuh"

namespace {

constexpr int kBQ = 64;   // q rows per block
constexpr int kBK = 64;   // keys per shared-memory tile (two per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;            // o (input dtype) or pv (f32)
  float* lse;         // lse or m, [B, H, Tq]
  float* l;           // l, [B, H, Tq] (partial triple only)
  const int* off;     // [B, 2] (q_off, k_off) rows, or null: the scalars
  int H, Tq, Tk;
  int k_len;          // < 0: no key-length mask
  int q_off, k_off;
  int causal;
  float scale;
  long long sq[3], sk[3], sv[3], so[3];  // batch, time, head strides
};

template <int D>
constexpr size_t smem_floats() {
  // q tile, k tile (row padded to D + 1: conflict-free column reads),
  // v tile, f32 accumulator, running max and sum per row
  return (size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * D + 2 * kBQ;
}

template <typename T, int D, bool kNormalize>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][D]
  float* ks = qs + kBQ * D;          // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);    // [kBK][D]
  float* acc = vs + kBK * D;         // [kBQ][D]
  float* ms = acc + kBQ * D;         // [kBQ]
  float* ls = ms + kBQ;              // [kBQ]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);

  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    qs[i] = t < a.Tq ? ps::to_float(qp[(long long)t * a.sq[1] + d]) : 0.0f;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    ms[r] = ps::kNegInf;
    ls[r] = 0.0f;
  }

  const int n_keys = ps::key_limit(mask, min(q0 + kBQ, a.Tq));
  const int n_kt = (n_keys + kBK - 1) / kBK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and the init done)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D, key = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (key < a.Tk) {
        kv = ps::to_float(kp[(long long)key * a.sk[1] + d]);
        vv = ps::to_float(vp[(long long)key * a.sv[1] + d]);
      }
      ks[j * (D + 1) + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += kWarps) {
      const int t = q0 + r;
      if (t >= a.Tq) break;  // rows ascend; the whole warp agrees
      const float* qr = qs + r * D;
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const float* kr = ks + j * (D + 1);
        float dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s[u] = ps::keep(mask, t, k0 + j) ? dot * a.scale : ps::kNegInf;
      }
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, ps::warp_max(fmaxf(s[0], s[1])));
      const bool live = m_new > ps::kNegInf * 0.5f;
      const float p0 = live ? expf(s[0] - m_new) : 0.0f;
      const float p1 = live ? expf(s[1] - m_new) : 0.0f;
      const float alpha = expf(m_prev - m_new);
      const float p_sum = ps::warp_sum(p0 + p1);

      // lane owns output columns lane, lane + 32, ...
      float o[D / 32];
      float* ar = acc + r * D;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) o[i] = ar[lane + 32 * i] * alpha;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const float pa = __shfl_sync(ps::kFullMask, p0, j);
        const float pb = __shfl_sync(ps::kFullMask, p1, j);
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          o[i] = fmaf(pa, vs[j * D + lane + 32 * i], o[i]);
          o[i] = fmaf(pb, vs[(j + 32) * D + lane + 32 * i], o[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) ar[lane + 32 * i] = o[i];
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + p_sum;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int r = warp; r < kBQ; r += kWarps) {
    const int t = q0 + r;
    if (t >= a.Tq) break;
    const long long row = (long long)bh * a.Tq + t;
    const long long at = b * a.so[0] + h * a.so[2] + (long long)t * a.so[1];
    if (kNormalize) {
      const float l = ls[r];
      const float l_safe = l == 0.0f ? 1.0f : l;
      T* orow = static_cast<T*>(a.o) + at;
      for (int d = lane; d < D; d += 32)
        orow[d] = ps::from_float<T>(acc[r * D + d] / l_safe);
      if (lane == 0) a.lse[row] = ms[r] + logf(l_safe);
    } else {
      // the partial triple: UNNORMALIZED numerator plus (m, l), merged
      // across hops by the caller
      float* pvrow = static_cast<float*>(a.o) + at;
      for (int d = lane; d < D; d += 32) pvrow[d] = acc[r * D + d];
      if (lane == 0) {
        a.lse[row] = ms[r];
        a.l[row] = ls[r];
      }
    }
  }
}

template <typename T, int D, bool kNormalize>
int launch(const FlashArgs& a, int B, cudaStream_t s) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kNormalize>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.Tq + kBQ - 1) / kBQ), (unsigned)(B * a.H));
  flash_fwd_kernel<T, D, kNormalize><<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool kNormalize>
int launch_d(const FlashArgs& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32, kNormalize>(a, B, s);
    case 64: return launch<T, 64, kNormalize>(a, B, s);
    case 128: return launch<T, 128, kNormalize>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_n(const FlashArgs& a, int B, int D, int normalize, cudaStream_t s) {
  return normalize ? launch_d<T, true>(a, B, D, s) : launch_d<T, false>(a, B, D, s);
}

}  // namespace

// strides: 12 int64 element strides, (batch, time, head) for q, k, v, o in
// that order; the head-dim stride must be 1 (the wrapper checks).
// normalize != 0: o is [B, Tq, H, D] in the input dtype, lse [B, H, Tq]
// f32, l unused. normalize == 0: o is pv f32, lse receives m, l receives l.
// off: null, or a device int32 [B, 2] table of (q_off, k_off) that then
// replaces the scalars.
extern "C" int ps_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* l, int dtype,
                            int normalize, int B, int H, int Tq, int Tk,
                            int D, const long long* strides, float scale,
                            int causal, int k_len, const void* off, int q_off,
                            int k_off, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return (int)cudaSuccess;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.l = static_cast<float*>(l);
  a.off = static_cast<const int*>(off);
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.k_len = k_len;
  a.q_off = q_off;
  a.k_off = k_off;
  a.causal = causal;
  a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ps::kFloat32: return launch_n<float>(a, B, D, normalize, s);
    case ps::kBFloat16: return launch_n<__nv_bfloat16>(a, B, D, normalize, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
