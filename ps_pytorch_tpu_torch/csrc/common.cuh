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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

}  // namespace ps
