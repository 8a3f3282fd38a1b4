// K2 quantize_tensor: per-tensor symmetric int8 quantization with ONE
// scale shared by every worker, in two launches.
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_quant_kernel (launched by
// _pallas_quantize_2d, quantize.py:78). On the TPU the absmax, its pmax
// across workers and the scalar inverse were XLA ops, and the Pallas
// kernel only scaled, rounded, clipped and cast a lane-padded [M, 128]
// view, reading `inv` from SMEM. Here:
//
//   ps_absmax           max |x| over the whole stacked [N, *leaf] tensor
//                       into one device f32. In the stacked worker
//                       backend one absmax over the stack IS the pmax; a
//                       multi-process backend puts a MAX all-reduce
//                       between the two launches.
//   ps_quantize_tensor  reads that absmax from device memory (as the TPU
//                       read inv from SMEM), computes
//                       inv = absmax > 0 ? 127 / max(absmax, 1e-30) : 0
//                       and writes int8(clip(rint(x * inv), -127, 127))
//                       plus scale = absmax * (1/127).
//
// Nothing goes through the host between the two launches.
//
// Bit-exactness: a max is order-free, so the grid-stride / warp-shuffle /
// block / atomicMax reduction gives the same absmax as any other order.
// The atomicMax works on the float's bits, which order like the floats
// themselves because every value is non-negative (fabsf). '/' is the IEEE
// quotient (no --use_fast_math) and rintf rounds half to even (jnp.round).
// The scale multiplies by the f32 constant 1/127, not divides: the JAX
// step runs under jit, where XLA rewrites `absmax / 127.0` into
// `absmax * (1/127)` (quantize.py:175), and the port copies what the
// reference computes.
//
// Bound on the H100: bytes. The pair reads x twice (once per launch) and
// writes one int8 per element, a few flops per byte. Loads are 16 bytes
// a thread (float4) where the pointers allow it, stores 4 bytes (char4).
// The largest ResNet18 leaf stacked for 8 workers (75.5 MB) is larger than
// the 50 MB L2, so the second read comes from device memory; fusing both
// passes needs a grid-wide barrier (a later PR).
//
// Non-finite input: fmaxf drops NaN, so the absmax stays finite or +inf;
// neither launch can fault or hang on it. The payload of such a step is
// not bit-exact with the plain version, and need not be: the non-finite
// guard turns that step into the identity.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident 256-thread blocks per SM
constexpr float kRecip127 = 1.0f / 127.0f;

__device__ __forceinline__ int8_t quant_one(float x, float inv) {
  float r = rintf(x * inv);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)__float2int_rn(r);
}

__device__ __forceinline__ float block_max(float m) {
  __shared__ float partial[kThreads / 32];
  m = ps::warp_max(m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? partial[lane] : 0.0f;
    m = ps::warp_max(m);
  }
  return m;  // valid in thread 0
}

// VEC: f32 input, x 16-byte aligned and q 4-byte aligned; the first
// n / 4 * 4 elements go as float4, the tail one by one.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const T* __restrict__ x, long long n, float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  float m = 0.0f;
  long long done = 0;
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n >> 2;
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) m = fmaxf(m, fabsf(ps::to_float(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(out), __float_as_int(m));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    quantize_tensor_kernel(const T* __restrict__ x, long long n,
                           const float* __restrict__ absmax,
                           int8_t* __restrict__ q, float* __restrict__ scale) {
  const float amax = *absmax;
  const float inv = amax > 0.0f ? 127.0f / fmaxf(amax, 1e-30f) : 0.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = amax * kRecip127;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    const long long n4 = n >> 2;
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      q4[i] = make_char4(quant_one(v.x, inv), quant_one(v.y, inv),
                         quant_one(v.z, inv), quant_one(v.w, inv));
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) q[i] = quant_one(ps::to_float(x[i]), inv);
}

unsigned grid_for(long long n) {
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)blocks;
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

extern "C" int ps_absmax(const void* x, int dtype, long long n, void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const unsigned grid = grid_for(n);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case ps::kFloat32: {
      const float* xf = static_cast<const float*>(x);
      if (aligned(x, 16))
        absmax_kernel<float, true><<<grid, kThreads, 0, s>>>(xf, n, o);
      else
        absmax_kernel<float, false><<<grid, kThreads, 0, s>>>(xf, n, o);
      break;
    }
    case ps::kBFloat16:
      absmax_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ps_quantize_tensor(const void* x, int dtype, long long n, const void* absmax,
                                  void* q, void* scale, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n);
  const float* a = static_cast<const float*>(absmax);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  switch (dtype) {
    case ps::kFloat32: {
      const float* xf = static_cast<const float*>(x);
      if (aligned(x, 16) && aligned(q, 4))
        quantize_tensor_kernel<float, true><<<grid, kThreads, 0, s>>>(xf, n, a, qo, so);
      else
        quantize_tensor_kernel<float, false><<<grid, kThreads, 0, s>>>(xf, n, a, qo, so);
      break;
    }
    case ps::kBFloat16:
      quantize_tensor_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n, a, qo, so);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
