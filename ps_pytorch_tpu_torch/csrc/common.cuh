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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// int8(clip(rint(x * inv), -127, 127)): rintf rounds half to even, as
// jnp.round does (K1 and K2)
__device__ __forceinline__ int8_t quant_int8(float x, float inv) {
  float r = rintf(x * inv);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)__float2int_rn(r);
}

// where(absmax > 0, 127 / max(absmax, 1e-30), 0) as an IEEE quotient
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
