// K1 quantize_rows: per-row symmetric int8 quantization, one pass.
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_quant_rows_kernel (launched by
// _pallas_quantize_rows, quantize.py:101). On the TPU the row absmax and
// the scale/inverse were XLA ops (and, on the gradient wire, a pmax over
// workers, quantize.py:152-154), and only the scale-round-clip-cast ran
// in the Pallas kernel, under 128-lane / 8-row conditions. Two entries:
//
//   ps_quantize_rows              fused: one warp owns one row [bs] end
//                                 to end, absmax of the row (warp max),
//                                 then quantize (the serving KV cache,
//                                 and the two-round wire's round 2 at
//                                 block size);
//   ps_quantize_rows_scaled_many  the block-scale gradient wire's shared
//                                 scales, every piece of a step in one
//                                 call: per piece x [N, n] (N workers,
//                                 n elements each) cut into nb = ceil(n
//                                 / bs) blocks, one warp owns block r of
//                                 EVERY worker: absmax[r] = max over the
//                                 N workers and the block's elements
//                                 (JAX's max(abs) + pmax), then worker
//                                 w's q[w, r, :] with that shared scale.
//                                 Padding to whole blocks is virtual:
//                                 elements past n read as 0 and their
//                                 int8 is written as 0 (no padded copy).
//
// Both then compute, per row, inv = absmax > 0 ? 127 / max(absmax, 1e-30)
// : 0, int8(clip(rint(x * inv), -127, 127)) and scale = absmax * (1/127).
//
// The multi-tensor entry's work unit is one block-row (all N workers);
// a descriptor table (RowsTable: input and output pointers, length,
// block count, load kind, output slot and first row of each piece) goes
// by value as a __grid_constant__ kernel parameter, kMaxPieces pieces
// under the 4 KB parameter space; the host cuts a longer list into
// several tables (ops/quantize.py plan_rows_tables). The grid is the
// card's resident blocks (or fewer); warps walk the rows of the whole
// table with a grid stride, so pieces get warps in proportion to their
// length, and a warp finds its row's piece by a binary search of the
// first rows. Every row's absmax and scale slot is written, so nothing
// is zeroed first.
//
// Bit-exactness: the arithmetic is quantize.py:152-169 op for op as XLA
// runs it under jit. The build has no --use_fast_math, so '/' is IEEE
// division and rintf rounds half to even (jnp.round). XLA rewrites the
// division by the constant 127 (`absmax / 127.0`) into a multiply by the
// f32 constant 1/127 inside a jitted program, so the scale is that
// product; `127 / absmax` stays a quotient. bf16 input widens exactly to
// f32 in registers (the JAX code casts K/V to f32 first, serve/kv.py:70).
// A max is order-free, so the bits do not depend on the grid.
//
// Bound on the H100: bytes. Each input element is read once from device
// memory and one int8 written per element, plus one f32 scale (and one
// absmax) per row: a few flops per byte (far below the card's ~20 f32
// flops/byte balance). At block 128 and up to 8 workers (the wire's
// case) each lane keeps its float4 of every worker's block in registers
// (scaled_block_row_128): the row is read once, its loads all in flight.
// Elsewhere a warp reads its row twice (absmax, then quantize), but the
// second read follows the first at once and touches N * bs elements: it
// hits L1 or L2, so device memory sees one read either way, the part of
// the design the TPU's whole-array pmax could not have. The multi-tensor entry loads float4
// and stores char4 for every f32 piece whose input is 16-byte aligned
// and whose n and bs are multiples of 4, decided per piece; other pieces
// and bf16 go element by element. The fused entry's rows of head_dim
// (64-128 elements) leave lanes idle past 32 elements per pass; wider
// vector loads there are later work.
//
// Non-finite input (multi-tensor entry): fmaxf drops NaN, so an absmax
// stays finite or +inf and no launch can fault or hang; such a step's
// payload need not match the plain version (the non-finite guard turns
// it into the identity).
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__device__ __forceinline__ void quantize_row(const T* __restrict__ xr,
                                             int8_t* __restrict__ qr, int bs,
                                             int lane, float inv) {
  for (int c = lane; c < bs; c += 32) qr[c] = ps::quant_int8(ps::to_float(xr[c]), inv);
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
  quantize_row(xr, q + row * (long long)bs, bs, lane, ps::inv_scale(amax));
  if (lane == 0) scale[row] = amax * ps::kRecip127;
}

// load kinds of the multi-tensor entry (ops/quantize.py _k1_kind)
constexpr long long kF32Vec = 0;  // f32, x 16-byte aligned, n and bs multiples of 4
constexpr long long kF32 = 1;
constexpr long long kBF16 = 2;

// Every field is an int64 word: the host fills the table word by word
// (ops/quantize.py _K1_TABLE) and checks its size against
// ps_rows_table_words().
struct RowsTable {
  long long count;       // pieces in this table
  long long total_rows;  // == first_row[count]
  long long workers;     // N, the same for every piece of a call
  long long bs;          // block size
  long long x[ps::kMaxPieces];     // input pointers, [N, n] each
  long long q[ps::kMaxPieces];     // int8 output pointers, [N, nb, bs] each
  long long n[ps::kMaxPieces];     // elements per worker (> 0)
  long long nb[ps::kMaxPieces];    // ceil(n / bs)
  long long kind[ps::kMaxPieces];  // load kind
  long long slot[ps::kMaxPieces];  // first absmax / scale row of the piece in the call
  long long first_row[ps::kMaxPieces + 1];
};
static_assert(sizeof(RowsTable) + 2 * sizeof(void*) <= 4096,
              "the table must fit the 4 KB kernel parameter space");

__device__ __forceinline__ int piece_of(const RowsTable& t, long long u) {
  int lo = 0, hi = (int)t.count - 1;  // the last piece whose first row is <= u
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_row[mid] <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// block-row r of one piece, all workers, one warp
template <typename T, bool VEC>
__device__ __forceinline__ void scaled_block_row(const T* __restrict__ x, int8_t* __restrict__ q,
                                                 long long n, long long nb, long long r,
                                                 int workers, int bs, int lane,
                                                 float* __restrict__ absmax,
                                                 float* __restrict__ scale) {
  const long long c0 = r * bs;
  const int live = (int)min((long long)bs, n - c0);  // the rest of the block is padding
  float m = 0.0f;
  if constexpr (VEC) {  // n % 4 == bs % 4 == 0: live % 4 == 0
#pragma unroll 4
    for (int w = 0; w < workers; ++w) {
      const float4* xw = reinterpret_cast<const float4*>(x + w * n + c0);
      for (int j = lane; j < (live >> 2); j += 32) {
        const float4 v = __ldg(xw + j);
        m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
      }
    }
  } else {
    for (int w = 0; w < workers; ++w) {
      const T* xw = x + w * n + c0;
      for (int j = lane; j < live; j += 32) m = fmaxf(m, fabsf(ps::to_float(xw[j])));
    }
  }
  m = ps::warp_max(m);
  const float inv = ps::inv_scale(m);
  for (int w = 0; w < workers; ++w) {
    int8_t* qw = q + (w * nb + r) * bs;
    if constexpr (VEC) {
      const float4* xw = reinterpret_cast<const float4*>(x + w * n + c0);
      char4* q4 = reinterpret_cast<char4*>(qw);
      for (int j = lane; j < (bs >> 2); j += 32) {
        const float4 v = j < (live >> 2) ? __ldg(xw + j) : make_float4(0.f, 0.f, 0.f, 0.f);
        q4[j] = make_char4(ps::quant_int8(v.x, inv), ps::quant_int8(v.y, inv),
                           ps::quant_int8(v.z, inv), ps::quant_int8(v.w, inv));
      }
    } else {
      const T* xw = x + w * n + c0;
      for (int j = lane; j < bs; j += 32)
        qw[j] = ps::quant_int8(j < live ? ps::to_float(xw[j]) : 0.0f, inv);
    }
  }
  if (lane == 0) {
    absmax[r] = m;
    scale[r] = m * ps::kRecip127;
  }
}

// the block-128 wire at up to 8 workers, an f32 piece on the float4
// path: each lane holds its float4 of every worker's block in registers,
// so the row is read once, all its loads in flight together
__device__ __forceinline__ void scaled_block_row_128(const float* __restrict__ x,
                                                     int8_t* __restrict__ q, long long n,
                                                     long long nb, long long r, int workers,
                                                     int lane, float* __restrict__ absmax,
                                                     float* __restrict__ scale) {
  const long long c0 = r * 128;
  const bool live = c0 + 4 * lane < n;  // n % 4 == 0: a lane's float4 is live or padding
  float4 v[8];
  float m = 0.0f;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    v[w] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w < workers && live) v[w] = __ldg(reinterpret_cast<const float4*>(x + w * n + c0) + lane);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v[w].x), fabsf(v[w].y)), fmaxf(fabsf(v[w].z), fabsf(v[w].w))));
  }
  m = ps::warp_max(m);
  const float inv = ps::inv_scale(m);
#pragma unroll
  for (int w = 0; w < 8; ++w)
    if (w < workers)
      reinterpret_cast<char4*>(q + (w * nb + r) * 128)[lane] =
          make_char4(ps::quant_int8(v[w].x, inv), ps::quant_int8(v[w].y, inv),
                     ps::quant_int8(v[w].z, inv), ps::quant_int8(v[w].w, inv));
  if (lane == 0) {
    absmax[r] = m;
    scale[r] = m * ps::kRecip127;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    quantize_rows_scaled_many_kernel(const __grid_constant__ RowsTable t,
                                     float* __restrict__ absmax, float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  const int workers = (int)t.workers, bs = (int)t.bs;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long u = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       u < t.total_rows; u += warps) {  // warp-uniform
    const int i = piece_of(t, u);
    const long long r = u - t.first_row[i];
    int8_t* q = reinterpret_cast<int8_t*>(t.q[i]);
    float* a = absmax + t.slot[i];
    float* s = scale + t.slot[i];
    if (t.kind[i] == kF32Vec && bs == 128 && workers <= 8)
      scaled_block_row_128(reinterpret_cast<const float*>(t.x[i]), q, t.n[i], t.nb[i], r,
                           workers, lane, a, s);
    else if (t.kind[i] == kF32Vec)
      scaled_block_row<float, true>(reinterpret_cast<const float*>(t.x[i]), q, t.n[i], t.nb[i],
                                    r, workers, bs, lane, a, s);
    else if (t.kind[i] == kF32)
      scaled_block_row<float, false>(reinterpret_cast<const float*>(t.x[i]), q, t.n[i], t.nb[i],
                                     r, workers, bs, lane, a, s);
    else
      scaled_block_row<__nv_bfloat16, false>(reinterpret_cast<const __nv_bfloat16*>(t.x[i]), q,
                                             t.n[i], t.nb[i], r, workers, bs, lane, a, s);
  }
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

extern "C" long long ps_rows_table_words() { return sizeof(RowsTable) / sizeof(long long); }

// One table of K1's multi-tensor shared-scale entry: `words` is a
// RowsTable; absmax[slot + r] and scale[slot + r] receive piece i's
// block-row r.
extern "C" int ps_quantize_rows_scaled_many(const long long* words, void* absmax, void* scale,
                                            void* stream) {
  RowsTable t;
  memcpy(&t, words, sizeof t);
  if (t.count < 1 || t.count > ps::kMaxPieces || t.total_rows < 1 ||
      t.total_rows != t.first_row[t.count] || t.workers < 1 || t.bs < 1 ||
      t.bs > 0x7fffffffLL || t.workers > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (long long i = 0; i < t.count; ++i)
    if (t.n[i] < 1 || t.nb[i] != (t.n[i] + t.bs - 1) / t.bs || t.kind[i] < kF32Vec ||
        t.kind[i] > kBF16)
      return (int)cudaErrorInvalidValue;
  static int resident[16];  // zero: not computed yet
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 16 || resident[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, quantize_rows_scaled_many_kernel, kWarpsPerBlock * 32, 0);
    if (err != cudaSuccess) return (int)err;
    if (dev < 16) resident[dev] = sms * per_sm;
  }
  const long long cap = dev < 16 ? resident[dev] : (long long)sms * per_sm;
  const long long want = (t.total_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (cap < 1) return (int)cudaErrorInvalidConfiguration;
  quantize_rows_scaled_many_kernel<<<(unsigned)(want < cap ? want : cap), kWarpsPerBlock * 32, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(absmax), static_cast<float*>(scale));
  return (int)cudaGetLastError();
}

extern "C" const char* ps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
