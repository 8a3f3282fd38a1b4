// K1 quantize_rows: per-row symmetric int8 quantization, one pass.
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_quant_rows_kernel (launched by
// _pallas_quantize_rows, quantize.py:101). On the TPU the row absmax and
// the scale/inverse were XLA ops and only the scale-round-clip-cast ran in
// the Pallas kernel, under 128-lane / 8-row conditions. Here one warp owns
// one row end to end: absmax (warp max), scale = absmax / 127,
// inv = absmax > 0 ? 127 / max(absmax, 1e-30) : 0, then
// int8(clip(rint(x * inv), -127, 127)) — any row width, any row count.
//
// Bit-exactness: the arithmetic is quantize.py:152-169 op for op. The
// build has no --use_fast_math, so '/' is IEEE division and rintf rounds
// half to even (jnp.round); bf16 input widens exactly to f32 in registers
// (the JAX code casts K/V to f32 first, serve/kv.py:70).
//
// Bound on the H100: bytes. It reads each input element once and writes
// one int8 per element plus one f32 scale per row, a few flops per byte
// (far below the card's ~20 f32 flops/byte balance). The design reads the
// row twice from the same warp (absmax, then quantize); the second read
// hits L1/L2 for head-dim rows, so device memory sees one read. Rows of
// head_dim (64-128 elements) leave lanes idle past 32 elements per pass;
// wider vector loads are later work.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

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
  int8_t* qr = q + row * (long long)bs;
  for (int c = lane; c < bs; c += 32) {
    float r = rintf(ps::to_float(xr[c]) * inv);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    qr[c] = (int8_t)__float2int_rn(r);
  }
  if (lane == 0) scale[row] = amax / 127.0f;
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

extern "C" const char* ps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
