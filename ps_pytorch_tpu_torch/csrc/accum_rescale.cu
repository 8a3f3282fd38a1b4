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
// int8: one add per byte read. A thread owns a chunk of kCols = 16
// consecutive columns starting at a multiple of 16, keeps their 16 int32
// sums in registers and walks the rows; neighbouring lanes own
// neighbouring chunks, so a warp reads ~512 contiguous bytes of a row per
// step.
//
// Every row is read in aligned 16-byte words, whatever the pitch s and
// wherever recv starts (the wires send pitches with s % 16 of 8, 10 and
// 12, and views at any offset). Where recv is 16-byte aligned and s % 16
// == 0 every row is aligned, and accum_rescale_aligned_kernel loads each
// chunk of each row as one int4. Otherwise accum_rescale_kernel runs: row
// r's misalignment m_r = (recv + r s) mod 16 is the same for every lane
// of the row, since each chunk starts at a multiple of 16, so nothing
// diverges on it. A lane loads the aligned word holding its chunk's
// first byte and takes the next aligned word from the lane to its right
// (__shfl_down_sync: that lane loaded it as its own first word); lane 31
// only loads, so a warp owns 31 chunks and reads 33 words a row, one of
// them its neighbour warp's. A funnel shift by m_r bytes cuts the lane's
// 16 columns out of the 32 bytes. The kRows rows' loads are in flight
// before any is used. Only a word that crosses an end of recv (the first
// word of row 0, the words past the last byte of the last row) is read
// byte by byte, and only its bytes inside recv: no byte outside the
// buffer is read, and no row of any pitch s >= 16 goes byte by byte.
// `out` is the wrapper's fresh allocation, 16-byte aligned: a full chunk
// stores its 16 results as one int4, and the lane holding the ragged
// last s % 16 columns stores those bytes one at a time. Any n >= 1, any
// s: the Pallas wrapper's s % 128 == 0 condition is gone.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;
constexpr int kRows = 4;  // rows a lane of accum_rescale_kernel has in flight

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

// The aligned 16-byte word at address a (a % 16 == 0) of recv's bytes
// [lo, hi): one 16-byte load where the word lies inside them, else the
// bytes inside them one by one and 0 for the rest.
__device__ __forceinline__ uint4 load_word(uintptr_t a, uintptr_t lo, uintptr_t hi) {
  if (a >= lo && a + 16 <= hi) return __ldg(reinterpret_cast<const uint4*>(a));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (a + j >= lo && a + j < hi)
      w[j >> 2] |= (unsigned)*reinterpret_cast<const uint8_t*>(a + j) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bytes [m, m + 16) of the 32 bytes lo:hi (m < 16; m warp-uniform) added
// into acc[0..15]
__device__ __forceinline__ void add_window(int* acc, uint4 lo, uint4 hi, int m) {
  const unsigned u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = m >> 2, sh = 8 * (m & 3);
  unsigned v[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)  // v[k] = u[q + k], with constant indices
    v[k] = (q & 2) ? ((q & 1) ? u[k + 3] : u[k + 2]) : ((q & 1) ? u[k + 1] : u[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) add_bytes(acc + 4 * k, __funnelshift_r(v[k], v[k + 1], sh));
}

// Every row 16-byte aligned (recv 16-byte aligned, s % 16 == 0): each
// lane owns the chunk it loads, one int4 a row, the loads of four rows
// in flight.
__global__ void __launch_bounds__(kThreads)
    accum_rescale_aligned_kernel(const int8_t* __restrict__ recv, long long n, long long s,
                                 const float* __restrict__ divisor, int8_t* __restrict__ out) {
  const long long c0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (c0 >= s) return;
  int acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0;
  const int8_t* p = recv + c0;
#pragma unroll 4
  for (long long r = 0; r < n; ++r, p += s) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    add_bytes(acc + 0, v.x);
    add_bytes(acc + 4, v.y);
    add_bytes(acc + 8, v.z);
    add_bytes(acc + 12, v.w);
  }
  const float div = *divisor;
  *reinterpret_cast<int4*>(out + c0) =
      make_int4((int)pack4(acc + 0, div), (int)pack4(acc + 4, div), (int)pack4(acc + 8, div),
                (int)pack4(acc + 12, div));
}

// Any other base or pitch: a warp owns kChunksPerWarp = 31 chunks, lanes
// 0-30 one each; lane 31 loads the word right of lane 30's and owns no
// column. Row by row, a lane loads the aligned word holding its chunk's
// first byte, takes the next word from the lane to its right and cuts
// its 16 columns out of the 32 bytes; kRows rows' loads are in flight
// before any is used.
constexpr int kChunksPerWarp = 31;

__global__ void __launch_bounds__(kThreads)
    accum_rescale_kernel(const int8_t* __restrict__ recv, long long n, long long s,
                         const float* __restrict__ divisor, int8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long c0 = (warp * kChunksPerWarp + lane) * kCols;
  // this lane's chunk owns columns (lane 31's never does); its word is
  // read by it or by the lane to its left while that lane owns columns
  const bool mine = lane < kChunksPerWarp && c0 < s;
  const bool load = c0 < s + kCols;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(recv);
  const uintptr_t hi = lo + (uintptr_t)(n * s);
  int acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0;
  // every lane, owner or not, walks the rows: the shuffles take the warp
  for (long long r0 = 0; r0 < n; r0 += kRows) {
    uint4 w[kRows];
    int m[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {  // every load of the kRows rows first
      w[k] = make_uint4(0u, 0u, 0u, 0u);
      m[k] = 0;
      if (r0 + k < n) {
        const uintptr_t a = lo + (uintptr_t)((r0 + k) * s + c0);
        m[k] = (int)(a & 15u);  // the row's, the same in every lane
        if (load) w[k] = load_word(a - m[k], lo, hi);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r0 + k >= n) break;
      uint4 next;  // the word right of this lane's, from the lane to the right
      next.x = __shfl_down_sync(ps::kFullMask, w[k].x, 1);
      next.y = __shfl_down_sync(ps::kFullMask, w[k].y, 1);
      next.z = __shfl_down_sync(ps::kFullMask, w[k].z, 1);
      next.w = __shfl_down_sync(ps::kFullMask, w[k].w, 1);
      add_window(acc, w[k], next, m[k]);
    }
  }
  if (!mine) return;
  const float div = *divisor;
  if (c0 + kCols <= s) {
    *reinterpret_cast<int4*>(out + c0) =
        make_int4((int)pack4(acc + 0, div), (int)pack4(acc + 4, div),
                  (int)pack4(acc + 8, div), (int)pack4(acc + 12, div));
    return;
  }
  // the ragged last s - c0 < 16 columns
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (c0 + j < s) out[c0 + j] = rescale_one(acc[j], div);
}

}  // namespace

// out must be 16-byte aligned (the wrapper's fresh allocation is); recv
// any address, [n, s] contiguous.
extern "C" int ps_accumulate_rescale(const void* recv, long long n, long long s,
                                     const void* divisor, void* out, void* stream) {
  if (n < 1 || s < 0 || (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* r = static_cast<const int8_t*>(recv);
  const float* d = static_cast<const float*>(divisor);
  int8_t* o = static_cast<int8_t*>(out);
  const long long chunks = (s + kCols - 1) / kCols;
  if ((reinterpret_cast<uintptr_t>(recv) & 15u) == 0 && s % kCols == 0) {
    const long long grid = (chunks + kThreads - 1) / kThreads;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    accum_rescale_aligned_kernel<<<(unsigned)grid, kThreads, 0, st>>>(r, n, s, d, o);
  } else {
    const long long warps = (chunks + kChunksPerWarp - 1) / kChunksPerWarp;
    const long long grid = (warps * 32 + kThreads - 1) / kThreads;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    accum_rescale_kernel<<<(unsigned)grid, kThreads, 0, st>>>(r, n, s, d, o);
  }
  return (int)cudaGetLastError();
}
