// K3 accumulate_rescale: the homomorphic wire's exact integer
// accumulation over the worker rows of an int8 payload, fused with the
// lattice rescale back to int8.
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_accum_rescale_kernel (launched
// by _pallas_accum_rescale, quantize.py:424). For each column c of
// recv [n, s]:
//
//   acc  = sum_r recv[r, c]                  (int32, exact)
//   q[c] = int8(clip(rint(float(acc) / div), -127, 127))
//
// with `div` read from device memory, as the TPU read it from SMEM: a
// Python-number divisor becomes a device scalar through a fill, and the
// adaptive aggregation count can change per step without a host sync or
// a rebuild.
//
// Bit-exactness: the sum is exact in int32 (|acc| <= 258 * 127 at the
// int16 capacity, far inside int32); float(acc) is exact below 2^24; '/'
// is the IEEE quotient (no --use_fast_math) and rintf rounds half to
// even, as jnp.round does.
//
// Bound on the H100: bytes. The launch reads n*s int8 once and writes s
// int8: one add per byte read. Each thread owns kCols = 16 consecutive
// columns, keeps their 16 int32 sums in registers and walks the n rows;
// neighbouring threads own neighbouring 16-byte chunks, so a warp reads
// 512 contiguous bytes of a row per step. Where the base pointers are
// 16-byte aligned and the row pitch s is a multiple of 16, every row load
// and the store are one 16-byte access (the ResNet18 fused payload,
// 8 x 11173968, is); otherwise the same loop loads byte by byte. The
// ragged tail (s % 16 columns) goes byte by byte in the last thread. Any
// n >= 1, any s: the Pallas wrapper's s % 128 == 0 condition is gone.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;

__device__ __forceinline__ int8_t rescale_one(int acc, float div) {
  float r = rintf(__int2float_rn(acc) / div);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)__float2int_rn(r);
}

// the four signed bytes of w, low byte first, added into acc[0..3]
__device__ __forceinline__ void add_bytes(int* acc, unsigned w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] += ((int)(w << (24 - 8 * k))) >> 24;
}

__device__ __forceinline__ unsigned pack4(const int* acc, float div) {
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) w |= ((unsigned)(uint8_t)rescale_one(acc[k], div)) << (8 * k);
  return w;
}

// VEC: recv and out 16-byte aligned and s % 16 == 0
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    accum_rescale_kernel(const int8_t* __restrict__ recv, long long n, long long s,
                         const float* __restrict__ divisor, int8_t* __restrict__ out) {
  const long long c0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (c0 >= s) return;
  const float div = *divisor;
  int acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0;
  if (c0 + kCols <= s) {
    const int8_t* p = recv + c0;
#pragma unroll 4
    for (long long r = 0; r < n; ++r, p += s) {
      if constexpr (VEC) {
        const int4 v = *reinterpret_cast<const int4*>(p);
        add_bytes(acc + 0, (unsigned)v.x);
        add_bytes(acc + 4, (unsigned)v.y);
        add_bytes(acc + 8, (unsigned)v.z);
        add_bytes(acc + 12, (unsigned)v.w);
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] += p[j];
      }
    }
    if constexpr (VEC) {
      *reinterpret_cast<int4*>(out + c0) =
          make_int4((int)pack4(acc + 0, div), (int)pack4(acc + 4, div),
                    (int)pack4(acc + 8, div), (int)pack4(acc + 12, div));
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) out[c0 + j] = rescale_one(acc[j], div);
    }
    return;
  }
  // ragged tail: the last s - c0 < 16 columns, one at a time (a scalar
  // sum, so acc[] keeps constant indices and stays in registers)
  const int m = (int)(s - c0);
  for (int j = 0; j < m; ++j) {
    int a = 0;
    for (long long r = 0; r < n; ++r) a += recv[r * s + c0 + j];
    out[c0 + j] = rescale_one(a, div);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int ps_accumulate_rescale(const void* recv, long long n, long long s,
                                     const void* divisor, void* out, void* stream) {
  if (n < 1 || s < 0) return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_block = (long long)kThreads * kCols;
  const unsigned grid = (unsigned)((s + per_block - 1) / per_block);
  const int8_t* r = static_cast<const int8_t*>(recv);
  const float* d = static_cast<const float*>(divisor);
  int8_t* o = static_cast<int8_t*>(out);
  if (aligned16(recv) && aligned16(out) && s % 16 == 0)
    accum_rescale_kernel<true><<<grid, kThreads, 0, st>>>(r, n, s, d, o);
  else
    accum_rescale_kernel<false><<<grid, kThreads, 0, st>>>(r, n, s, d, o);
  return (int)cudaGetLastError();
}
