// Shared helpers for the port's hand-written Hopper kernels.
//
// Every C entry point of this directory takes plain pointers and a
// stream (ctypes route: no PyTorch headers, so nvcc builds in seconds)
// and returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ps {

// dtype codes shared with ops/_build.py (DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr unsigned kFullMask = 0xffffffffu;

// the TPU kernels' finite "minus infinity": (-inf) - (-inf) is NaN, this
// is not, so fully-masked rows stay finite
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// max of two non-negative floats that keeps a NaN: a non-negative float
// orders as its bits do, and a positive NaN's bits lie above +inf's
// (jnp.max keeps a NaN; fmaxf would drop it)
__device__ __forceinline__ float max_nonneg(float a, float b) {
  return __int_as_float(max(__float_as_int(a), __float_as_int(b)));
}

// running absmax: m >= 0 (or NaN), and fabsf clears a NaN's sign too
__device__ __forceinline__ float max_abs(float m, float x) { return max_nonneg(m, fabsf(x)); }

// max over the warp of non-negative floats, NaN kept
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max_nonneg(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// int8(clip(rint(x * inv), -127, 127)) (K1 and K2). The clip is PTX's
// max.NaN / min.NaN (sm_80 and up), which keep a NaN product (x NaN, or
// inf * 0 from an infinite absmax) where fmaxf would turn it into -127;
// the conversion then rounds half to even, as jnp.round does, and sends
// the NaN to 0, as XLA's and PyTorch's casts do. (An integer clip after
// the conversion ran 3% slower in K2's quantize on the H100: VIMNMX where
// this is FMNMX, and the parent's separate rintf is gone; PERF.md, PR 11.)
__device__ __forceinline__ int8_t quant_int8(float x, float inv) {
  float c;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(c) : "f"(x * inv), "f"(-127.0f));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(c) : "f"(c), "f"(127.0f));
  return (int8_t)__float2int_rn(c);
}

// where(absmax > 0, 127 / max(absmax, 1e-30), 0) as an IEEE quotient; a
// NaN absmax fails the test and gives 0, as JAX's where does
__device__ __forceinline__ float inv_scale(float amax) {
  return amax > 0.0f ? 127.0f / fmaxf(amax, 1e-30f) : 0.0f;
}

// the f32 constant XLA multiplies by where the JAX code divides by 127.0
constexpr float kRecip127 = 1.0f / 127.0f;

// pieces in one launch's descriptor table (K1's and K2's multi-tensor
// entries): the table goes by value as a kernel parameter, and 64 pieces
// of at most 7 int64 words each, plus the header, stay under the 4 KB
// parameter space every CUDA 12 toolkit accepts (ops/quantize.py
// MAX_PIECES)
constexpr int kMaxPieces = 64;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

}  // namespace ps
