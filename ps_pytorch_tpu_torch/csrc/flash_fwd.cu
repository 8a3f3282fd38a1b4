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
// stacked shards of T=2048, six of them seeing every key: ~52 us). In
// f32, operations at 3xTF32's 164.9 TFLOP/s: 52 us at LM-1, 313 us on
// the ring hop.
//
// One kernel body (fwd_tiles), on the tensor cores for both input types;
// the type picks the product helpers. The q tile and double-buffered K/V
// tiles stay in the input type in shared memory, rows padded by 16 bytes,
// filled by cp.async 16-byte copies (rows past T zero-filled), the next
// K/V tile loading while this one computes. Warp w owns q rows [16 w,
// 16 w + 16): S = Q.K^T on the tensor cores, then the mask and the online
// softmax on S's C fragments in f32 (row max over the quad, alpha, p, the
// row sums), then acc += P.V with P straight from those registers. The
// outputs are stored straight from the fragments.
//
// * bf16 inputs (both LM cells, the serving prefill, the Ulysses path):
//   flash_fwd_mma_kernel with flash_mma.cuh: mma.sync.m16n8k16 from
//   ldmatrix fragments (bf16 products are exact in f32 and summed in f32,
//   as preferred_element_type=f32 does); S's C layout is PV's A layout.
//   JAX takes PV from f32 P; rounding P once to bf16 misses the partial
//   triple's 2e-5 bound, so P enters as a bf16 hi + lo pair, two products
//   into one f32 accumulator. V is exact bf16, read by ldmatrix.trans.
//   64-key tiles.
// * f32 inputs (cli.train_lm's default dtype: the f32 LM steps, rings and
//   Ulysses; the f32 serving engine's prefill): flash_fwd_tf32_kernel
//   with flash_tf32.cuh: mma.sync.m16n8k8 TF32, both operands of both
//   products as TF32 hi + lo pairs (3xTF32), each 8-deep step summed
//   apart and added to the accumulator by an f32 add (the tensor cores
//   truncate their sums); P enters PV from its C registers in a permuted
//   contraction order, V's rows read as 2t, 2t + 1. The q tile and each
//   32-key K / V tile are split once into hi / lo planes in shared
//   memory, so the warps read their B fragments instead of each splitting
//   them. The mask is applied after the product, so a masked score is
//   exactly NEG_INF.
#include "flash_mask.cuh"
#include "flash_mma.cuh"
#include "flash_tf32.cuh"

namespace {

using ps::bf16;
using ps::cp_async_commit;
using ps::cp_async_wait;
using ps::gemm_abt;
using ps::gemm_split_ab;
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

// The key tile a block visits: bf16 64 keys, f32 32. f32 tiles are split
// once into TF32 hi / lo planes in shared memory (the q tile once a
// block, each K / V tile once as it lands) rather than by each of the
// four warps that read them: on the H100 that ran the LM-1 shape 20% and
// the ring hop 11% faster than 64-key tiles split on every read (PERF.md).
template <typename T, int D>
__host__ __device__ constexpr int fwd_tile() {
  return sizeof(T) == sizeof(float) ? 32 : kBK;
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  // the q tile and two stages of K and V tiles in the input type, rows of
  // pitch D + 16 bytes; f32 also the lo planes of q and of one K and V
  // stage (45 / 85 / 165 KB at D = 32 / 64 / 128)
  constexpr size_t bk = fwd_tile<T, D>();
  constexpr size_t rows = kBQ + 4 * bk + (sizeof(T) == sizeof(float) ? kBQ + 2 * bk : 0);
  return rows * ps::pitch<T, D>() * sizeof(T);
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
// registers at 65536 / (128 n). bf16: at D = 64 on the H100 the kernel ran
// 7-12% faster with 4 (128 registers, 16 bytes spilled) than with ptxas's
// free choice of 157 (3 blocks). D = 32 fits 4 blocks uncapped (128
// registers), and at D = 128 shared memory (87 KB a block) holds it to 2
// blocks anyway. f32: shared memory holds it to 2 blocks at D = 64, where
// ptxas takes 211 registers and spills nothing; 32-key tiles split on
// every read at 3 blocks (168 registers) spilled 28 bytes and ran the ring
// hop 11% slower.
template <typename T, int D>
constexpr int fwd_min_blocks() {
  return sizeof(T) == sizeof(bf16) ? (D == 64 ? 4 : 1) : 1;
}

// One block per (batch*head, 64-row q tile), longest causal rows first;
// warp w owns rows [16 w, 16 w + 16) of it and loops over the visible key
// tiles. This thread holds rows row0 (fragment slots 0, 1) and row0 + 8
// (slots 2, 3) of each 16 x 8 fragment, columns 2 (lane % 4) and
// 2 (lane % 4) + 1. The input type picks the product helpers.
template <typename T, int D, bool kNormalize>
__device__ __forceinline__ void fwd_tiles(const FlashArgs& a, unsigned char* smem_bytes) {
  constexpr int P = ps::pitch<T, D>();
  constexpr int BK = fwd_tile<T, D>();
  constexpr bool kPlanes = sizeof(T) == sizeof(float);  // TF32 hi / lo planes
  T* qs = reinterpret_cast<T*>(smem_bytes);  // [kBQ][P]
  T* ks = qs + kBQ * P;                      // [2][BK][P]
  T* vs = ks + 2 * BK * P;                   // [2][BK][P]
  [[maybe_unused]] T* lo = vs + 2 * BK * P;  // planes: q, K, V lo [kBQ + 2 BK][P]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ps::FlashMask mask =
      ps::flash_mask(a.causal, a.k_len, a.Tk, a.off, a.q_off, a.k_off, b);
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const int n_kt = (ps::key_limit(mask, min(q0 + kBQ, a.Tq)) + BK - 1) / BK;

  load_rows<D, kBQ, kThreads>(qs, qp, a.sq[1], q0, a.Tq);
  if (n_kt > 0) {
    load_rows<D, BK, kThreads>(ks, kp, a.sk[1], 0, a.Tk);
    load_rows<D, BK, kThreads>(vs, vp, a.sv[1], 0, a.Tk);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + lane / 4;
  float m[2] = {ps::kNegInf, ps::kNegInf};  // running row max
  float l[2] = {0.0f, 0.0f};  // this lane's share of the running row sums
  float acc[D / 8][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    T* kst = ks + (kt & 1) * BK * P;
    T* vst = vs + (kt & 1) * BK * P;
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
    if constexpr (kPlanes) {
      T* klo = lo + kBQ * P;
      T* vlo = klo + BK * P;
      if (kt == 0) ps::split_rows<D, kBQ, kThreads>(qs, lo);
      ps::split_rows<D, BK, kThreads>(kst, klo);
      ps::split_rows<D, BK, kThreads>(vst, vlo);
      __syncthreads();
      gemm_abt<BK, D, P>(s, ps::SplitTile{qs + warp * 16 * P, lo + warp * 16 * P},
                         ps::SplitTile{kst, klo}, lane);
    } else {
      gemm_abt<BK, D, P>(s, qs + warp * 16 * P, kst, lane);
    }
    const bool interior = ps::tile_kept(mask, q0 + warp * 16, k0, BK);
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
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
    for (int j = 0; j < BK / 8; ++j) {
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
    if constexpr (kPlanes) {
      gemm_split_ab<BK, D, P>(acc, s, ps::SplitTile{vst, lo + (kBQ + BK) * P}, lane);
    } else {
      gemm_split_ab<BK, D, P>(acc, s, vst, lane);
    }
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
      T* orow = static_cast<T*>(a.o) + at;
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
// The kernels: bf16 inputs (mma.sync bf16), f32 inputs (3xTF32).

template <int D, bool kNormalize>
__global__ void __launch_bounds__(kThreads, (fwd_min_blocks<bf16, D>()))
    flash_fwd_mma_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  fwd_tiles<bf16, D, kNormalize>(a, smem_bytes);
}

template <int D, bool kNormalize>
__global__ void __launch_bounds__(kThreads, (fwd_min_blocks<float, D>()))
    flash_fwd_tf32_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  fwd_tiles<float, D, kNormalize>(a, smem_bytes);
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
int launch(const FlashArgs& a, int B, bool f32, cudaStream_t s) {
  if (f32)
    return launch_kernel(flash_fwd_tf32_kernel<D, kNormalize>, fwd_smem<float, D>(), a, B, s);
  return launch_kernel(flash_fwd_mma_kernel<D, kNormalize>, fwd_smem<bf16, D>(), a, B, s);
}

template <bool kNormalize>
int launch_d(const FlashArgs& a, int B, int D, bool f32, cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, kNormalize>(a, B, f32, s);
    case 64: return launch<64, kNormalize>(a, B, f32, s);
    case 128: return launch<128, kNormalize>(a, B, f32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 element strides, (batch, time, head) for q, k, v, o in
// that order; the head-dim stride must be 1 (the wrapper checks) and
// every row of q, k, v and o 16-byte aligned (cudaErrorMisalignedAddress
// otherwise). dtype picks the route: f32 the 3xTF32 kernel, bf16 the
// bf16 tensor-core kernel; nothing falls back from one to the other. normalize != 0: o is [B, Tq, H, D] in the input dtype, lse
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
  const bool f32 = dtype == ps::kFloat32;
  if (!f32 && dtype != ps::kBFloat16) return (int)cudaErrorInvalidValue;
  const int vec = f32 ? 4 : 8;  // elements in 16 bytes
  if (!rows_aligned(q, a.sq, vec) || !rows_aligned(k, a.sk, vec) ||
      !rows_aligned(v, a.sv, vec) || !rows_aligned(o, a.so, vec))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return normalize ? launch_d<true>(a, B, D, f32, s) : launch_d<false>(a, B, D, f32, s);
}
