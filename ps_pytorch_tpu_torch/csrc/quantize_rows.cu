// K1: per-row (per-block) symmetric int8 quantization.
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_quant_rows_kernel (launched by
// _pallas_quantize_rows, quantize.py:101). On the TPU the row absmax and
// the scale/inverse were XLA ops (and, on the gradient wire, a pmax over
// workers, quantize.py:152-154), and only the scale-round-clip-cast ran
// in the Pallas kernel, under 128-lane / 8-row conditions. Three entries:
//
//   ps_quantize_kv_write          the serving KV cache's pool write, one
//                                 launch a layer: K and V [R, H, hd] (any
//                                 row and head strides) in one grid,
//                                 every (position, head) row quantized
//                                 with its own scale and stored straight
//                                 into the pool's int8 rows and f32
//                                 scales (JAX: serve/kv.py _quant_rows,
//                                 then write_slot's dynamic_update_slice
//                                 or write_token's scatter). Prefill:
//                                 row t goes to (slot, t). Decode: row s
//                                 goes to (s, pos[s]), pos read on the
//                                 device; a negative position wraps
//                                 once by max_len and one still outside
//                                 [0, max_len) is dropped, as JAX's
//                                 scatter drops it;
//   ps_quantize_rows_many         per-row scales over every [nb, bs]
//                                 piece of a list (the two-round wire's
//                                 round 2, ops/quantize.py
//                                 quantize_rows_many; quantize_rows is
//                                 its one-piece call), on the KV entry's
//                                 lane groups, one plain grid over a
//                                 descriptor table;
//   ps_quantize_rows_scaled_many  every piece of a step in one call: per
//                                 piece x [N, n] (N workers, n elements
//                                 each) cut into nb = ceil(n / bs)
//                                 blocks, one warp owns block r of EVERY
//                                 worker: absmax[r] = max over the N
//                                 workers and the block's elements (JAX's
//                                 max(abs) + pmax), then worker w's
//                                 q[w, r, :] with that shared scale.
//                                 Padding to whole blocks is virtual:
//                                 elements past n read as 0 and their
//                                 int8 is written as 0 (no padded copy);
//   ps_rows_scaled_absmax_many +  the same entry split in two around a
//   ps_quantize_rows_scaled_given_many  cross-process max of the block
//                                 absmax, for a worker axis over
//                                 processes (each process's N is its
//                                 local workers), on the same warp-a-
//                                 block-row walk and, at block 128, the
//                                 same lane mapping.
//
// All compute, per row, inv = absmax > 0 ? 127 / max(absmax, 1e-30) : 0,
// int8(clip(rint(x * inv), -127, 127)) and scale = absmax * (1/127).
//
// The KV entry's rows are head vectors of 32-128 elements, and a decode
// tick's call quantizes 2 x 64 rows of 64 bf16 (16 KB in): no launch of
// any design comes near its byte time, so the design cuts launches and
// lanes. One call replaces the quantize and the two index writes of each
// of K and V (6 launches a layer become 1). A row is a group of
// hd * sizeof(T) / 16 lanes (8 for 64 bf16: a warp holds 4 rows), each
// lane one 16-byte load held in registers, the absmax a shuffle inside
// the group, 4 or 8 int8 stored in one word a lane, the scale by the
// group's first lane. A row width whose 16-byte count is not a power of
// two up to 32, or a view that is not 16-byte aligned, runs the same
// kernel's element loop, one warp a row.
//
// The per-row multi-tensor entry gives every row its own lane group in
// one grid of (rows x group) threads; a thread finds its row's piece by a
// binary search of the table's first rows. At a ResNet18 step's round 2
// (87552 rows of 128 f32) it takes 27 us where the shared-scale kernel
// at one worker, a warp a row in a grid-stride loop, took 46 (PERF.md).
//
// The shared-scale entry's work unit is one block-row (all N workers);
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
// flops/byte balance). The lane-group entries hold each lane's 16 bytes
// in registers from the absmax to the quantize: one read. At block 128
// and up to 8 workers (the shared-scale wire's case) each lane keeps its
// four elements of every worker's block in registers (load_row_128): the
// row is read once, its loads all in flight. Elsewhere a warp reads its
// row twice (absmax, then quantize), but the second read follows the
// first at once and touches N * bs elements: it hits L1 or L2, so device
// memory sees one read either way, the part of the design the TPU's
// whole-array pmax could not have. The fused shared-scale entry loads
// float4 and stores char4 for every f32 piece whose input is 16-byte
// aligned and whose n and bs are multiples of 4, decided per piece;
// other pieces and bf16 go element by element. The split route's two
// halves read x once each (the cross-process max lies between them), so
// its floor is two reads of x; at block 128 and up to 8 workers both take
// load_row_128 for f32 pieces on the float4 kind and for bf16 pieces
// whose input is 8-byte aligned with n a multiple of 4 (8-byte loads),
// and the given half stores one char4 a worker and lane.
//
// Non-finite input, as JAX's max(abs) and the plain versions take it:
// every max keeps a NaN (ps::max_abs, a max over the bits of |x|, where a
// positive NaN lies above +inf), so a row holding a NaN gets a NaN absmax
// and scale, inverse 0 and an all-zero payload; a row whose absmax is
// +inf gets inverse 0 too, and its inf * 0 products are NaN, which
// quant_int8's conversion sends to 0. Bit-exact with the plain versions
// either way (the serving int8 pool has no guard in front of it).
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// ------------------------------------------------ the KV cache pool write

// Every field is an int64 word: the host fills it word by word
// (ops/quantize.py _KV_WORDS) and checks its size against
// ps_kv_write_words(). Index 0 is K, 1 is V.
struct KvWrite {
  long long x[2];       // [R, H, hd] inputs, the last dimension contiguous
  long long x_row[2];   // element stride between positions
  long long x_head[2];  // element stride between heads
  long long q[2];       // int8 pool rows of this layer [slots, max_len, H, hd]
  long long s[2];       // f32 scales of this layer [slots, max_len, H]
  long long pos;        // decode: positions [R] on the device; 0: prefill
  long long pos64;      // positions are int64 (else int32)
  long long rows;       // R
  long long heads;      // H
  long long hd;
  long long max_len;
  long long slot;       // prefill: the slot written
  long long group;      // lanes a row: hd * sizeof(T) / 16, or 32 (element loop)
};

// 16 bytes of T widened to f32 (exact for bf16)
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// a bf16 widens to the f32 of its bits shifted up 16; element 2i is the
// low half of word i
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack4(const float* f, float inv) {
  return (unsigned)(uint8_t)ps::quant_int8(f[0], inv) |
         ((unsigned)(uint8_t)ps::quant_int8(f[1], inv) << 8) |
         ((unsigned)(uint8_t)ps::quant_int8(f[2], inv) << 16) |
         ((unsigned)(uint8_t)ps::quant_int8(f[3], inv) << 24);
}

// max over the aligned group of `group` lanes (a power of two); every
// lane of the warp takes part
__device__ __forceinline__ float group_max(float x, int group) {
  for (int o = group >> 1; o > 0; o >>= 1)
    x = ps::max_nonneg(x, __shfl_xor_sync(ps::kFullMask, x, o));
  return x;
}

// One row of `len` elements quantized by its group of lanes (`sub`: the
// lane's place in it). kVec: each lane holds one 16-byte load (len ==
// group * 16 / sizeof(T)); else group == 32 and the lanes loop over the
// row. xr == nullptr: no row here, the lanes only join the shuffles.
template <typename T, bool kVec>
__device__ __forceinline__ void quant_row(const T* __restrict__ xr, int8_t* __restrict__ qr,
                                          float* __restrict__ sr, int len, int group, int sub) {
  constexpr int kN = 16 / sizeof(T);
  float f[kN];
  float m = 0.0f;
  if (xr != nullptr) {
    if constexpr (kVec) {
      load16(xr + sub * kN, f);
#pragma unroll
      for (int i = 0; i < kN; ++i) m = ps::max_abs(m, f[i]);
    } else {
      for (int c = sub; c < len; c += 32) m = ps::max_abs(m, ps::to_float(xr[c]));
    }
  }
  m = group_max(m, group);
  if (xr == nullptr) return;
  const float inv = ps::inv_scale(m);
  if constexpr (kVec && kN == 8) {  // one store of the lane's int8: 8 bytes, or 4
    *reinterpret_cast<uint2*>(qr + sub * kN) = make_uint2(pack4(f, inv), pack4(f + 4, inv));
  } else if constexpr (kVec) {
    *reinterpret_cast<unsigned*>(qr + sub * kN) = pack4(f, inv);
  } else {
    for (int c = sub; c < len; c += 32) qr[c] = ps::quant_int8(ps::to_float(xr[c]), inv);
  }
  if (sub == 0) *sr = m * ps::kRecip127;
}

// blockIdx.y: 0 K, 1 V; the threads of a block cover whole groups
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    quantize_kv_write_kernel(const __grid_constant__ KvWrite a) {
  const int which = blockIdx.y;
  const int group = (int)a.group;
  const long long u = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / group;
  const T* xr = nullptr;
  int8_t* qr = nullptr;
  float* sr = nullptr;
  if (u < a.rows * a.heads) {
    const long long r = u / a.heads, h = u - r * a.heads;
    long long p = r, slot = a.slot;
    if (a.pos != 0) {
      p = a.pos64 ? reinterpret_cast<const long long*>(a.pos)[r]
                  : (long long)reinterpret_cast<const int*>(a.pos)[r];
      if (p < 0) p += a.max_len;
      slot = r;
    }
    if (p >= 0 && p < a.max_len) {  // else dropped, as JAX's scatter drops it
      const long long dst = (slot * a.max_len + p) * a.heads + h;
      xr = reinterpret_cast<const T*>(a.x[which]) + r * a.x_row[which] + h * a.x_head[which];
      qr = reinterpret_cast<int8_t*>(a.q[which]) + dst * a.hd;
      sr = reinterpret_cast<float*>(a.s[which]) + dst;
    }
  }
  quant_row<T, kVec>(xr, qr, sr, (int)a.hd, group, threadIdx.x & (group - 1));
}

template <typename T>
cudaError_t launch_kv_write(const KvWrite& a, bool vec, cudaStream_t s) {
  const long long threads = a.rows * a.heads * a.group;
  const long long blocks = (threads + kWarpsPerBlock * 32 - 1) / (kWarpsPerBlock * 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, 2);
  if (vec)
    quantize_kv_write_kernel<T, true><<<grid, kWarpsPerBlock * 32, 0, s>>>(a);
  else
    quantize_kv_write_kernel<T, false><<<grid, kWarpsPerBlock * 32, 0, s>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------ the multi-tensor shared-scale entry

// load kinds of the multi-tensor entry (ops/quantize.py _k1_kind)
constexpr long long kF32Vec = 0;   // f32, x 16-byte aligned, n and bs multiples of 4
constexpr long long kF32 = 1;
constexpr long long kBF16 = 2;
constexpr long long kBF16Vec = 3;  // bf16, x 8-byte aligned, n and bs multiples of 4

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
        m = ps::max_abs(ps::max_abs(ps::max_abs(ps::max_abs(m, v.x), v.y), v.z), v.w);
      }
    }
  } else {
    for (int w = 0; w < workers; ++w) {
      const T* xw = x + w * n + c0;
      for (int j = lane; j < live; j += 32) m = ps::max_abs(m, ps::to_float(xw[j]));
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

// The block-128 wire at up to 8 workers (kF32Vec and kBF16Vec pieces):
// lane l holds elements [4 l, 4 l + 4) of every worker's block in
// registers, one float4 (f32) or one 8-byte word (bf16) a worker, all
// loaded before any is used, so the row is read once with all its loads
// in flight; the quantize stores one char4 a worker, so a warp writes
// each worker's 128 int8 as 128 contiguous bytes.
constexpr int kRowWorkers = 8;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// four bf16 widened exactly to f32; element 2i is the low half of word i
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// block-row r's elements of this lane, every worker; padding reads as 0
template <typename T>
__device__ __forceinline__ void load_row_128(const T* __restrict__ x, long long n, long long r,
                                             int workers, int lane, float4 (&v)[kRowWorkers]) {
  const long long c0 = r * 128;
  const bool live = c0 + 4 * lane < n;  // n % 4 == 0: a lane's four are live or padding
#pragma unroll
  for (int w = 0; w < kRowWorkers; ++w) {
    v[w] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w < workers && live) v[w] = load4(x + w * n + c0 + 4 * lane);
  }
}

__device__ __forceinline__ float row_max_128(const float4 (&v)[kRowWorkers]) {
  float m = 0.0f;
#pragma unroll
  for (int w = 0; w < kRowWorkers; ++w)
    m = ps::max_abs(ps::max_abs(ps::max_abs(ps::max_abs(m, v[w].x), v[w].y), v[w].z), v[w].w);
  return ps::warp_max(m);
}

__device__ __forceinline__ void store_row_128(const float4 (&v)[kRowWorkers],
                                              int8_t* __restrict__ q, long long nb, long long r,
                                              int workers, int lane, float inv) {
#pragma unroll
  for (int w = 0; w < kRowWorkers; ++w)
    if (w < workers)
      reinterpret_cast<char4*>(q + (w * nb + r) * 128)[lane] =
          make_char4(ps::quant_int8(v[w].x, inv), ps::quant_int8(v[w].y, inv),
                     ps::quant_int8(v[w].z, inv), ps::quant_int8(v[w].w, inv));
}

// the fused entry's block-128 row: one read of x, all loads in flight
__device__ __forceinline__ void scaled_block_row_128(const float* __restrict__ x,
                                                     int8_t* __restrict__ q, long long n,
                                                     long long nb, long long r, int workers,
                                                     int lane, float* __restrict__ absmax,
                                                     float* __restrict__ scale) {
  float4 v[kRowWorkers];
  load_row_128(x, n, r, workers, lane, v);
  const float m = row_max_128(v);
  store_row_128(v, q, nb, r, workers, lane, ps::inv_scale(m));
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
    if (t.kind[i] == kF32Vec && bs == 128 && workers <= kRowWorkers)
      scaled_block_row_128(reinterpret_cast<const float*>(t.x[i]), q, t.n[i], t.nb[i], r,
                           workers, lane, a, s);
    else if (t.kind[i] == kF32Vec)
      scaled_block_row<float, true>(reinterpret_cast<const float*>(t.x[i]), q, t.n[i], t.nb[i],
                                    r, workers, bs, lane, a, s);
    else if (t.kind[i] == kF32)
      scaled_block_row<float, false>(reinterpret_cast<const float*>(t.x[i]), q, t.n[i], t.nb[i],
                                     r, workers, bs, lane, a, s);
    else  // kBF16, kBF16Vec
      scaled_block_row<__nv_bfloat16, false>(reinterpret_cast<const __nv_bfloat16*>(t.x[i]), q,
                                             t.n[i], t.nb[i], r, workers, bs, lane, a, s);
  }
}

// The shared-scale entry's split route, for a worker axis that spans
// processes: block r's absmax is the max over EVERY process's workers, so
// the cross-process max (an all_reduce of the int32 bits, ops/quantize.py)
// sits between a pass that takes this process's block absmax and one that
// quantizes with the reduced one. One warp a block-row, as above. At
// block 128 and up to 8 local workers, on the vector kinds (f32 float4,
// bf16 8-byte words), both halves take the fused entry's row mapping
// (load_row_128): the absmax half one warp max of the row held in
// registers, the given half one char4 store a worker and lane. Other
// block sizes, kinds and worker counts walk the row element by element,
// the lanes over consecutive elements (coalesced); padding reads as 0.
__device__ __forceinline__ bool row_128(const RowsTable& t, int i) {
  return t.bs == 128 && t.workers <= kRowWorkers &&
         (t.kind[i] == kF32Vec || t.kind[i] == kBF16Vec);
}

__device__ __forceinline__ bool is_bf16(long long kind) {
  return kind == kBF16 || kind == kBF16Vec;
}

template <typename T>
__device__ __forceinline__ float local_block_absmax(const T* __restrict__ x, long long n,
                                                    long long r, int workers, int bs,
                                                    int lane) {
  const long long c0 = r * bs;
  const int live = (int)min((long long)bs, n - c0);
  float m = 0.0f;
  for (int w = 0; w < workers; ++w) {
    const T* xw = x + w * n + c0;
    for (int j = lane; j < live; j += 32) m = ps::max_abs(m, ps::to_float(xw[j]));
  }
  return ps::warp_max(m);
}

template <typename T>
__device__ __forceinline__ void given_block_quantize(const T* __restrict__ x,
                                                     int8_t* __restrict__ q, long long n,
                                                     long long nb, long long r, int workers,
                                                     int bs, int lane, float inv) {
  const long long c0 = r * bs;
  const int live = (int)min((long long)bs, n - c0);
  for (int w = 0; w < workers; ++w) {
    const T* xw = x + w * n + c0;
    int8_t* qw = q + (w * nb + r) * bs;
    for (int j = lane; j < bs; j += 32)
      qw[j] = ps::quant_int8(j < live ? ps::to_float(xw[j]) : 0.0f, inv);
  }
}

template <typename T>
__device__ __forceinline__ float split_absmax(const RowsTable& t, int i, long long r, int lane) {
  const T* x = reinterpret_cast<const T*>(t.x[i]);
  if (row_128(t, i)) {
    float4 v[kRowWorkers];
    load_row_128(x, t.n[i], r, (int)t.workers, lane, v);
    return row_max_128(v);
  }
  return local_block_absmax(x, t.n[i], r, (int)t.workers, (int)t.bs, lane);
}

template <typename T>
__device__ __forceinline__ void split_quantize(const RowsTable& t, int i, long long r, int lane,
                                               float inv) {
  const T* x = reinterpret_cast<const T*>(t.x[i]);
  int8_t* q = reinterpret_cast<int8_t*>(t.q[i]);
  if (row_128(t, i)) {
    float4 v[kRowWorkers];
    load_row_128(x, t.n[i], r, (int)t.workers, lane, v);
    store_row_128(v, q, t.nb[i], r, (int)t.workers, lane, inv);
  } else {
    given_block_quantize(x, q, t.n[i], t.nb[i], r, (int)t.workers, (int)t.bs, lane, inv);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    rows_absmax_many_kernel(const __grid_constant__ RowsTable t, float* __restrict__ absmax) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long u = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       u < t.total_rows; u += warps) {  // warp-uniform
    const int i = piece_of(t, u);
    const long long r = u - t.first_row[i];
    const float m = is_bf16(t.kind[i]) ? split_absmax<__nv_bfloat16>(t, i, r, lane)
                                       : split_absmax<float>(t, i, r, lane);
    if (lane == 0) absmax[t.slot[i] + r] = m;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    rows_quantize_given_many_kernel(const __grid_constant__ RowsTable t,
                                    const float* __restrict__ absmax,
                                    float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long u = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       u < t.total_rows; u += warps) {  // warp-uniform
    const int i = piece_of(t, u);
    const long long r = u - t.first_row[i];
    const float m = absmax[t.slot[i] + r];
    const float inv = ps::inv_scale(m);
    if (is_bf16(t.kind[i]))
      split_quantize<__nv_bfloat16>(t, i, r, lane, inv);
    else
      split_quantize<float>(t, i, r, lane, inv);
    if (lane == 0) scale[t.slot[i] + r] = m * ps::kRecip127;
  }
}

// Per-row multi-tensor quantize on the KV entry's lane groups (one-worker
// pieces [nb, bs] of one type; the group the same for the whole call):
// one thread group a row, a plain grid.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    quantize_rows_many_kernel(const __grid_constant__ RowsTable t, float* __restrict__ scale,
                              int group) {
  const long long u = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / group;
  const T* xr = nullptr;
  int8_t* qr = nullptr;
  float* sr = nullptr;
  if (u < t.total_rows) {
    const int i = piece_of(t, u);
    const long long r = u - t.first_row[i];
    xr = reinterpret_cast<const T*>(t.x[i]) + r * t.bs;
    qr = reinterpret_cast<int8_t*>(t.q[i]) + r * t.bs;
    sr = scale + t.slot[i] + r;
  }
  quant_row<T, kVec>(xr, qr, sr, (int)t.bs, group, threadIdx.x & (group - 1));
}

}  // namespace

extern "C" long long ps_kv_write_words() { return sizeof(KvWrite) / sizeof(long long); }

// K1's KV entry: `words` is a KvWrite; dtype of K and V (ps::kFloat32 /
// ps::kBFloat16); vec: the 16-byte lane-group path (group == hd *
// sizeof(T) / 16), else the element loop (group == 32).
extern "C" int ps_quantize_kv_write(const long long* words, int dtype, int vec, void* stream) {
  KvWrite a;
  memcpy(&a, words, sizeof a);
  const long long elt = dtype == ps::kBFloat16 ? 2 : 4;
  if ((dtype != ps::kFloat32 && dtype != ps::kBFloat16) || a.rows < 1 || a.heads < 1 ||
      a.hd < 1 || a.hd > 0x7fffffffLL || a.max_len < 1 || a.slot < 0 ||
      (vec ? (a.group < 1 || a.group > 32 || (a.group & (a.group - 1)) != 0 ||
              a.group * (16 / elt) != a.hd)
           : a.group != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == ps::kFloat32 ? launch_kv_write<float>(a, vec != 0, s)
                                     : launch_kv_write<__nv_bfloat16>(a, vec != 0, s));
}

extern "C" long long ps_rows_table_words() { return sizeof(RowsTable) / sizeof(long long); }

static int check_table(const RowsTable& t) {
  if (t.count < 1 || t.count > ps::kMaxPieces || t.total_rows < 1 ||
      t.total_rows != t.first_row[t.count] || t.workers < 1 || t.bs < 1 ||
      t.bs > 0x7fffffffLL || t.workers > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (long long i = 0; i < t.count; ++i)
    if (t.n[i] < 1 || t.nb[i] != (t.n[i] + t.bs - 1) / t.bs || t.kind[i] < kF32Vec ||
        t.kind[i] > kBF16Vec)
      return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// The grid of a kernel whose warps walk a table's rows with a grid
// stride: the card's resident blocks of it (kernel occupancy, cached per
// device in `resident`), or fewer when the rows need fewer.
template <typename Kernel>
static cudaError_t warp_row_grid(Kernel kernel, int (&resident)[16], long long rows,
                                 unsigned* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  long long cap = dev < 16 ? resident[dev] : 0;  // zero: not computed yet
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpsPerBlock * 32, 0);
    if (err != cudaSuccess) return err;
    cap = (long long)sms * per_sm;
    if (dev < 16) resident[dev] = (int)cap;
  }
  if (cap < 1) return cudaErrorInvalidConfiguration;
  const long long want = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  *grid = (unsigned)(want < cap ? want : cap);
  return cudaSuccess;
}

// One table of K1's multi-tensor shared-scale entry: `words` is a
// RowsTable; absmax[slot + r] and scale[slot + r] receive piece i's
// block-row r.
extern "C" int ps_quantize_rows_scaled_many(const long long* words, void* absmax, void* scale,
                                            void* stream) {
  RowsTable t;
  memcpy(&t, words, sizeof t);
  if (const int err = check_table(t)) return err;
  static int resident[16];
  unsigned grid = 0;
  if (const cudaError_t err =
          warp_row_grid(quantize_rows_scaled_many_kernel, resident, t.total_rows, &grid))
    return (int)err;
  quantize_rows_scaled_many_kernel<<<grid, kWarpsPerBlock * 32, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(absmax), static_cast<float*>(scale));
  return (int)cudaGetLastError();
}

// One table of K1's shared-scale split route, first half: absmax[slot + r]
// receives piece i's block-row r's max over this process's workers.
extern "C" int ps_rows_scaled_absmax_many(const long long* words, void* absmax,
                                          void* stream) {
  RowsTable t;
  memcpy(&t, words, sizeof t);
  if (const int err = check_table(t)) return err;
  static int resident[16];
  unsigned grid = 0;
  if (const cudaError_t err =
          warp_row_grid(rows_absmax_many_kernel, resident, t.total_rows, &grid))
    return (int)err;
  rows_absmax_many_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(absmax));
  return (int)cudaGetLastError();
}

// Second half: every worker's block-row r of piece i quantized with the
// reduced absmax[slot + r]; scale[slot + r] = absmax * (1/127).
extern "C" int ps_quantize_rows_scaled_given_many(const long long* words, const void* absmax,
                                                  void* scale, void* stream) {
  RowsTable t;
  memcpy(&t, words, sizeof t);
  if (const int err = check_table(t)) return err;
  static int resident[16];
  unsigned grid = 0;
  if (const cudaError_t err =
          warp_row_grid(rows_quantize_given_many_kernel, resident, t.total_rows, &grid))
    return (int)err;
  rows_quantize_given_many_kernel<<<grid, kWarpsPerBlock * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(absmax), static_cast<float*>(scale));
  return (int)cudaGetLastError();
}

// One table of K1's per-row multi-tensor entry: `words` is a RowsTable of
// one-worker pieces of `dtype` (their kinds unused); scale[slot + r]
// receives piece i's row r. Every piece on the vector path (vec, group
// == bs * sizeof(T) / 16) or none (group == 32).
extern "C" int ps_quantize_rows_many(const long long* words, int dtype, int vec, int group,
                                     void* scale, void* stream) {
  RowsTable t;
  memcpy(&t, words, sizeof t);
  if (const int err = check_table(t)) return err;
  const long long elt = dtype == ps::kBFloat16 ? 2 : 4;
  if ((dtype != ps::kFloat32 && dtype != ps::kBFloat16) || t.workers != 1 ||
      (vec ? (group < 1 || group > 32 || (group & (group - 1)) != 0 ||
              group * (16 / elt) != t.bs)
           : group != 32))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (t.total_rows * group + kWarpsPerBlock * 32 - 1) / (kWarpsPerBlock * 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scale);
  const unsigned g = (unsigned)blocks;
  if (dtype == ps::kFloat32) {
    if (vec) quantize_rows_many_kernel<float, true><<<g, kWarpsPerBlock * 32, 0, s>>>(t, sc, group);
    else quantize_rows_many_kernel<float, false><<<g, kWarpsPerBlock * 32, 0, s>>>(t, sc, group);
  } else {
    if (vec)
      quantize_rows_many_kernel<__nv_bfloat16, true><<<g, kWarpsPerBlock * 32, 0, s>>>(t, sc, group);
    else
      quantize_rows_many_kernel<__nv_bfloat16, false><<<g, kWarpsPerBlock * 32, 0, s>>>(t, sc, group);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
