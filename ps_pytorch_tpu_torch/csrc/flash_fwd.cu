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
// itself; nothing crosses blocks, so there are no atomics and a result is
// the same from run to run.
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
// ~42 MB, ~13 us; the 4 D flops of each kept pair, 8.6 GFLOP, take ~9 us
// at the bf16 tensor-core peak); operations on an LM-ring hop (B=8
// stacked shards of T=2048, six of them seeing every key: ~52 us). Two
// routes, chosen by dtype:
//
// * bf16 inputs (both LM cells, the serving prefill, the Ulysses path):
//   flash_fwd_mma_kernel, on the tensor cores with the building blocks of
//   flash_mma.cuh. The q tile and double-buffered 64-key K/V tiles stay
//   bf16 in shared memory, filled by cp.async 16-byte copies (rows past T
//   zero-filled), the next K/V tile loading while this one computes. Warp
//   w owns q rows [16 w, 16 w + 16): S = Q.K^T by mma.sync.m16n8k16 from
//   ldmatrix fragments (bf16 products are exact in f32 and summed in f32,
//   as preferred_element_type=f32 does), then the mask and the online
//   softmax on S's C fragments in f32 (row max over the quad, alpha, p,
//   the row sums), then acc += P.V with P straight from those registers
//   (S's C layout is PV's A layout). JAX takes that product from f32 P;
//   rounding P once to bf16 misses the partial triple's 2e-5 bound, so P
//   enters as a bf16 hi + lo pair, two products into one f32 accumulator.
//   V is exact bf16, read by ldmatrix.trans. The outputs are stored
//   straight from the fragments.
// * f32 inputs (the f32 ring steps, phase 4's and the card tests' f32
//   cases): flash_fwd_scalar_kernel, f32 FMAs on the CUDA cores, one warp
//   per q row, K/V tiles staged in shared memory as f32.
#include "flash_mask.cuh"
#include "flash_mma.cuh"

namespace {

using ps::bf16;
using ps::cp_async_commit;
using ps::cp_async_wait;
using ps::gemm_abt;
using ps::gemm_split_ab;
using ps::kPad;
using ps::load_rows;
using ps::rows_aligned;
using ps::store2;

constexpr int kBQ = 64;   // q rows per block
constexpr int kBK = 64;   // keys per shared-memory tile
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

// ---------------------------------------------------------------------------
// f32 inputs: the scalar kernel (CUDA cores).

template <int D>
constexpr size_t scalar_smem() {
  // q tile, k tile (row padded to D + 1: conflict-free column reads),
  // v tile, f32 accumulator, running max and sum per row
  return ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D +
          (size_t)kBQ * D + 2 * kBQ) * sizeof(float);
}

template <int D, bool kNormalize>
__global__ void __launch_bounds__(kThreads) flash_fwd_scalar_kernel(FlashArgs a) {
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

  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[2];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    qs[i] = t < a.Tq ? qp[(long long)t * a.sq[1] + d] : 0.0f;
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
        kv = kp[(long long)key * a.sk[1] + d];
        vv = vp[(long long)key * a.sv[1] + d];
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
    float* orow = static_cast<float*>(a.o) + b * a.so[0] + h * a.so[2] +
                  (long long)t * a.so[1];
    if (kNormalize) {
      const float l = ls[r];
      const float l_safe = l == 0.0f ? 1.0f : l;
      for (int d = lane; d < D; d += 32) orow[d] = acc[r * D + d] / l_safe;
      if (lane == 0) a.lse[row] = ms[r] + logf(l_safe);
    } else {
      // the partial triple: UNNORMALIZED numerator plus (m, l), merged
      // across hops by the caller
      for (int d = lane; d < D; d += 32) orow[d] = acc[r * D + d];
      if (lane == 0) {
        a.lse[row] = ms[r];
        a.l[row] = ls[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the tensor-core kernel.

template <int D>
constexpr size_t mma_smem() {
  // the q tile and two stages of K and V tiles, bf16 rows of pitch D + kPad
  return ((size_t)kBQ + 4 * (size_t)kBK) * (D + kPad) * sizeof(bf16);
}

// The largest of a row's values over the four lanes of a quad (the lanes
// holding one fragment row), and their sum.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(ps::kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(ps::kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(ps::kFullMask, x, 1);
  return x + __shfl_xor_sync(ps::kFullMask, x, 2);
}

// Blocks a multiprocessor should hold at once, which caps a thread's
// registers at 65536 / (128 n). At D = 64 on the H100 the kernel ran 7-12%
// faster with 4 (128 registers, 16 bytes spilled) than with ptxas's free
// choice of 157 (3 blocks). D = 32 fits 4 blocks uncapped (128 registers),
// and at D = 128 shared memory (87 KB a block) holds it to 2 blocks anyway.
template <int D>
constexpr int fwd_min_blocks() {
  return D == 64 ? 4 : 1;
}

// One block per (batch*head, 64-row q tile); warp w owns rows [16 w,
// 16 w + 16) of it and loops over the visible key tiles. This thread holds
// rows row0 (fragment slots 0, 1) and row0 + 8 (slots 2, 3) of each 16 x 8
// fragment, columns 2 (lane % 4) and 2 (lane % 4) + 1.
template <int D, bool kNormalize>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<D>())
    flash_fwd_mma_kernel(FlashArgs a) {
  constexpr int P = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bytes);  // [kBQ][P]
  bf16* ks = qs + kBQ * P;                         // [2][kBK][P]
  bf16* vs = ks + 2 * kBK * P;                     // [2][kBK][P]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const int n_kt = (ps::key_limit(mask, min(q0 + kBQ, a.Tq)) + kBK - 1) / kBK;

  load_rows<D, kBQ, kThreads>(qs, qp, a.sq[1], q0, a.Tq);
  if (n_kt > 0) {
    load_rows<D, kBK, kThreads>(ks, kp, a.sk[1], 0, a.Tk);
    load_rows<D, kBK, kThreads>(vs, vp, a.sv[1], 0, a.Tk);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + lane / 4;
  float m[2] = {ps::kNegInf, ps::kNegInf};  // running row max
  float l[2] = {0.0f, 0.0f};  // this lane's share of the running row sums
  float acc[D / 8][4] = {};
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
    gemm_abt<kBK, D, P>(s, qs + warp * 16 * P, kst, lane);
    const bool interior = ps::tile_kept(mask, q0 + warp * 16, k0, kBK);
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
        const bool kept = interior || ps::keep(mask, row0 + 8 * i, key);
        s[j][e] = kept ? s[j][e] * a.scale : ps::kNegInf;
        m_new[i] = fmaxf(m_new[i], s[j][e]);
      }
    }
    float alpha[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = quad_max(m_new[i]);
      live[i] = m_new[i] > ps::kNegInf * 0.5f;
      alpha[i] = expf(m[i] - m_new[i]);
      m[i] = m_new[i];
    }
    float p_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        s[j][e] = live[i] ? expf(s[j][e] - m_new[i]) : 0.0f;  // p, in place
        p_sum[i] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + p_sum[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e / 2];
    }
    gemm_split_ab<kBK, D, P>(acc, s, vst, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // no visible key tile: the q tile's copies

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    const float l_row = quad_sum(l[i]);  // every lane of the quad takes part
    if (t >= a.Tq) continue;
    const long long row = (long long)bh * a.Tq + t;
    const long long at = b * a.so[0] + h * a.so[2] + (long long)t * a.so[1] +
                         (lane % 4) * 2;
    if (kNormalize) {
      const float l_safe = l_row == 0.0f ? 1.0f : l_row;
      bf16* orow = static_cast<bf16*>(a.o) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(orow + j * 8, acc[j][2 * i] / l_safe, acc[j][2 * i + 1] / l_safe);
      if (lane % 4 == 0) a.lse[row] = m[i] + logf(l_safe);
    } else {
      float* pvrow = static_cast<float*>(a.o) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) store2(pvrow + j * 8, acc[j][2 * i], acc[j][2 * i + 1]);
      if (lane % 4 == 0) {
        a.lse[row] = m[i];
        a.l[row] = l_row;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.

template <typename K>
int launch_kernel(K kernel, size_t bytes, const FlashArgs& a, int B, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.Tq + kBQ - 1) / kBQ), (unsigned)(B * a.H));
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool kNormalize>
int launch(const FlashArgs& a, int B, bool mma, cudaStream_t s) {
  if (mma)
    return launch_kernel(flash_fwd_mma_kernel<D, kNormalize>, mma_smem<D>(), a, B, s);
  return launch_kernel(flash_fwd_scalar_kernel<D, kNormalize>, scalar_smem<D>(), a, B, s);
}

template <bool kNormalize>
int launch_d(const FlashArgs& a, int B, int D, bool mma, cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, kNormalize>(a, B, mma, s);
    case 64: return launch<64, kNormalize>(a, B, mma, s);
    case 128: return launch<128, kNormalize>(a, B, mma, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 element strides, (batch, time, head) for q, k, v, o in
// that order; the head-dim stride must be 1 (the wrapper checks); bf16
// inputs also need 16-byte-aligned rows of q, k, v and o
// (cudaErrorMisalignedAddress otherwise). dtype picks the route: f32 the
// scalar kernel, bf16 the tensor-core kernel; nothing falls back from one
// to the other. normalize != 0: o is [B, Tq, H, D] in the input dtype, lse
// [B, H, Tq] f32, l unused. normalize == 0: o is pv f32, lse receives m, l
// receives l. off: null, or a device int32 [B, 2] table of (q_off, k_off)
// that then replaces the scalars.
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
  bool mma;
  switch (dtype) {
    case ps::kFloat32:
      mma = false;
      break;
    case ps::kBFloat16:
      if (!rows_aligned(q, a.sq) || !rows_aligned(k, a.sk) || !rows_aligned(v, a.sv) ||
          !rows_aligned(o, a.so))
        return (int)cudaErrorMisalignedAddress;
      mma = true;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return normalize ? launch_d<true>(a, B, D, mma, s) : launch_d<false>(a, B, D, mma, s);
}
