// K1 quantize_rows: per-row symmetric int8 quantization, one pass.
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_quant_rows_kernel (launched by
// _pallas_quantize_rows, quantize.py:101). On the TPU the row absmax and
// the scale/inverse were XLA ops and only the scale-round-clip-cast ran in
// the Pallas kernel, under 128-lane / 8-row conditions. Here one warp owns
// one row end to end, any row width, any row count. Two entries:
//
//   ps_quantize_rows         fused: absmax of the row (warp max), then
//                            quantize (the serving KV cache, and the
//                            block-scale wire without shared scales);
//   ps_quantize_rows_scaled  given absmax: rows [N*nb, bs] of N workers,
//                            absmax [nb] already max-reduced over workers
//                            (the pmax of quantize.py:153-154), shared by
//                            worker w's row w*nb + r (the block-scale
//                            gradient wire).
//
// Both then compute, per row, inv = absmax > 0 ? 127 / max(absmax, 1e-30)
// : 0, int8(clip(rint(x * inv), -127, 127)) and scale = absmax * (1/127).
//
// Bit-exactness: the arithmetic is quantize.py:152-169 op for op as XLA
// runs it under jit. The build has no --use_fast_math, so '/' is IEEE
// division and rintf rounds half to even (jnp.round). XLA rewrites the
// division by the constant 127 (`absmax / 127.0`) into a multiply by the
// f32 constant 1/127 inside a jitted program, so the scale is that
// product; `127 / absmax` stays a quotient. bf16 input widens exactly to
// f32 in registers (the JAX code casts K/V to f32 first, serve/kv.py:70).
//
// Bound on the H100: bytes. It reads each input element once and writes
// one int8 per element plus one f32 scale per row, a few flops per byte
// (far below the card's ~20 f32 flops/byte balance). The fused entry reads
// the row twice from the same warp (absmax, then quantize); the second
// read hits L1/L2 for head-dim rows, so device memory sees one read. Rows
// of head_dim (64-128 elements) leave lanes idle past 32 elements per
// pass; wider vector loads are later work.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kRecip127 = 1.0f / 127.0f;

template <typename T>
__device__ __forceinline__ void quantize_row(const T* __restrict__ xr,
                                             int8_t* __restrict__ qr, int bs,
                                             int lane, float inv) {
  for (int c = lane; c < bs; c += 32) {
    float r = rintf(ps::to_float(xr[c]) * inv);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    qr[c] = (int8_t)__float2int_rn(r);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, long long nb, int bs) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nb) return;  // whole warp leaves together
  const T* xr = x + row * (long long)bs;
  float amax = 0.0f;
  for (int c = lane; c < bs; c += 32) amax = fmaxf(amax, fabsf(ps::to_float(xr[c])));
  amax = ps::warp_max(amax);
  const float inv = amax > 0.0f ? 127.0f / fmaxf(amax, 1e-30f) : 0.0f;
  quantize_row(xr, q + row * (long long)bs, bs, lane, inv);
  if (lane == 0) scale[row] = amax * kRecip127;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    quantize_rows_scaled_kernel(const T* __restrict__ x,
                                const float* __restrict__ absmax, long long nb,
                                int8_t* __restrict__ q, float* __restrict__ scale,
                                long long rows, int bs) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const long long r = row % nb;
  const float amax = absmax[r];
  const float inv = amax > 0.0f ? 127.0f / fmaxf(amax, 1e-30f) : 0.0f;
  quantize_row(x + row * (long long)bs, q + row * (long long)bs, bs, lane, inv);
  if (lane == 0 && row < nb) scale[row] = amax * kRecip127;  // worker 0's rows
}

}  // namespace

extern "C" int ps_quantize_rows(const void* x, int dtype, void* q, void* scale,
                                long long nb, int bs, void* stream) {
  if (nb <= 0 || bs <= 0) return (int)cudaSuccess;
  const long long blocks = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ps::kFloat32:
      quantize_rows_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scale), nb, bs);
      break;
    case ps::kBFloat16:
      quantize_rows_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scale), nb, bs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ps_quantize_rows_scaled(const void* x, int dtype, const void* absmax,
                                       long long nb, void* q, void* scale,
                                       long long rows, int bs, void* stream) {
  if (rows <= 0 || bs <= 0) return (int)cudaSuccess;
  if (nb <= 0 || rows % nb != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(absmax);
  switch (dtype) {
    case ps::kFloat32:
      quantize_rows_scaled_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), a, nb, static_cast<int8_t*>(q),
          static_cast<float*>(scale), rows, bs);
      break;
    case ps::kBFloat16:
      quantize_rows_scaled_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), a, nb, static_cast<int8_t*>(q),
          static_cast<float*>(scale), rows, bs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
