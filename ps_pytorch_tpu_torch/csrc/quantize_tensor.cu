// K2 quantize_tensors: per-tensor symmetric int8 quantization of every
// piece a gradient wire ships in a step, in one call; each piece keeps
// its own absmax and scale.
//
// Replaces ps_pytorch_tpu/ops/quantize.py:_quant_kernel (launched by
// _pallas_quantize_2d, quantize.py:78), once per piece on the TPU, where
// the absmax, its pmax across workers and the scalar inverse were XLA
// ops and the Pallas kernel only scaled, rounded, clipped and cast a
// lane-padded [M, 128] view, reading `inv` from SMEM. Here, per piece p
// of the call (any shape and length, f32 or bf16):
//
//   absmax[p] = max |x_p| over the whole worker-stacked [N, *leaf] piece
//               (in the stacked worker backend that IS the pmax);
//   inv       = absmax > 0 ? 127 / max(absmax, 1e-30) : 0;
//   q_p       = int8(clip(rint(x_p * inv), -127, 127));
//   scale[p]  = absmax * (1/127).
//
// The work: every piece is cut into chunks of kChunk elements; a
// descriptor table (TensorTable: input pointer, output pointer, length,
// load kind and first chunk of each piece) goes by value as a
// __grid_constant__ kernel parameter, as PyTorch's multi_tensor_apply
// passes its own. The table holds kMaxPieces pieces and stays under the
// 4 KB parameter space; a longer list is cut into several tables by the
// host (ops/quantize.py plan_tensor_tables). No table is copied to the
// card and nothing waits on the host. The grid is the card's resident
// blocks (or fewer), and each block walks the chunks with a grid stride,
// so a piece gets blocks in proportion to its length: a [8, 10] bias one
// chunk, the [8, 3, 3, 512, 512] leaf 2304. A block finds its chunk's
// piece by a binary search of the table's first chunks.
//
// Two launches per table, nothing through the host between them:
// absmax_many_kernel (a running max per block while its chunks stay in
// one piece, then a block max and one atomicMax into the piece's slot),
// then quantize_many_kernel, which reads the finished absmax and walks
// the chunks in reverse, so it starts with the data the first launch read
// last. x is read twice from device memory: at 0.26-0.27 ms for
// ResNet18's 62 stacked leaves the pair runs at 89-92% of the two-pass
// floor (0.240 ms at 3.35 TB/s). A one-read route (pieces up to an L2
// budget in one cooperative launch, a grid barrier between a group's
// absmax and its quantize) ran 0.6-3.6% slower on the H100 at every
// budget from 16 to 40 MiB: what the L2 re-read saves, the barriers and each
// phase's last wave of chunks spent (PERF.md, PR 7).
//
// The absmax slots start at 0 (one zeroing of the call's slots by the
// host). Bit-exactness: a max is order-free, and the atomicMax works on
// the float's bits, which order like the floats because every value is
// non-negative (fabsf), NaN above +inf; any grid or chunk size gives the
// same bits.
// '/' is the IEEE quotient (no --use_fast_math) and rintf rounds half to
// even (jnp.round). The scale multiplies by the f32 constant 1/127: under
// jit XLA rewrites `absmax / 127.0` into `absmax * (1/127)`
// (quantize.py:175), and the port copies what the reference computes.
//
// Bound on the H100: bytes (x read once, one int8 written per element; a
// few flops per byte). Loads are 16 bytes a thread (float4) and stores 4
// (char4) for every f32 piece whose input is 16-byte aligned, decided per
// piece; other pieces and bf16 go element by element.
//
// Non-finite input, as JAX's max(abs) and the plain version take it: every
// max keeps a NaN (ps::max_abs, a max over the bits of |x|, where a
// positive NaN lies above +inf), so a piece holding a NaN gets a NaN
// absmax and scale, inverse 0 and an all-zero payload; a piece whose
// absmax is +inf gets inverse 0 too, and its inf * 0 products are NaN,
// which quant_int8's conversion sends to 0. Bit-exact with the plain version
// either way.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// elements a block takes at a time (ops/quantize.py K2_CHUNK): 32 KB of
// f32, 8 float4 loads a thread (chunks of 2048 ran 12% slower on the
// card: more searches and fewer loads in flight per chunk)
constexpr long long kChunk = 8192;

// load kinds (ops/quantize.py _k2_kind)
constexpr long long kF32Vec = 0;  // f32, x 16-byte aligned (q always is)
constexpr long long kF32 = 1;
constexpr long long kBF16 = 2;

// Every field is an int64 word: the host fills the table word by word
// (ops/quantize.py _K2_TABLE) and checks its size against
// ps_tensor_table_words().
struct TensorTable {
  long long count;         // pieces in this table
  long long total_chunks;  // == first_chunk[count]
  long long x[ps::kMaxPieces];     // input pointers
  long long q[ps::kMaxPieces];     // int8 output pointers
  long long n[ps::kMaxPieces];     // elements of each piece (> 0)
  long long kind[ps::kMaxPieces];  // load kind
  long long slot[ps::kMaxPieces];  // index of the piece's absmax / scale in the call
  long long first_chunk[ps::kMaxPieces + 1];
};
static_assert(sizeof(TensorTable) + 2 * sizeof(void*) <= 4096,
              "the table must fit the 4 KB kernel parameter space");

__device__ __forceinline__ int piece_of(const TensorTable& t, long long c) {
  int lo = 0, hi = (int)t.count - 1;  // the last piece whose first chunk is <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// max over the block, valid in thread 0. The leading barrier keeps a
// call from overwriting `partial` while warp 0 still reads the last one.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float partial[kThreads / 32];
  m = ps::warp_max(m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? partial[lane] : 0.0f;
    m = ps::warp_max(m);
  }
  return m;
}

// elements [e0, e1) of one piece; e0 is a multiple of 4, so the float4
// part is [e0, e1 & ~3) and the rest goes one by one
template <typename T, bool VEC>
__device__ __forceinline__ float span_absmax(const T* __restrict__ x, long long e0,
                                             long long e1) {
  float m = 0.0f;
  long long e = e0;
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long v1 = e1 & ~3LL;
#pragma unroll 4
    for (long long i = (e0 >> 2) + threadIdx.x; i < (v1 >> 2); i += kThreads) {
      const float4 v = __ldg(x4 + i);
      m = ps::max_abs(ps::max_abs(ps::max_abs(ps::max_abs(m, v.x), v.y), v.z), v.w);
    }
    e = v1;
  }
  for (long long i = e + threadIdx.x; i < e1; i += kThreads) m = ps::max_abs(m, ps::to_float(x[i]));
  return m;
}

template <typename T, bool VEC>
__device__ __forceinline__ void span_quantize(const T* __restrict__ x, int8_t* __restrict__ q,
                                              long long e0, long long e1, float inv) {
  long long e = e0;
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    const long long v1 = e1 & ~3LL;
#pragma unroll 4
    for (long long i = (e0 >> 2) + threadIdx.x; i < (v1 >> 2); i += kThreads) {
      const float4 v = __ldg(x4 + i);
      q4[i] = make_char4(ps::quant_int8(v.x, inv), ps::quant_int8(v.y, inv),
                         ps::quant_int8(v.z, inv), ps::quant_int8(v.w, inv));
    }
    e = v1;
  }
  for (long long i = e + threadIdx.x; i < e1; i += kThreads)
    q[i] = ps::quant_int8(ps::to_float(x[i]), inv);
}

// this thread's max over chunk c of piece i
__device__ __forceinline__ float chunk_absmax(const TensorTable& t, int i, long long c) {
  const long long e0 = (c - t.first_chunk[i]) * kChunk;
  const long long e1 = min(e0 + kChunk, t.n[i]);
  if (t.kind[i] == kF32Vec)
    return span_absmax<float, true>(reinterpret_cast<const float*>(t.x[i]), e0, e1);
  if (t.kind[i] == kF32)
    return span_absmax<float, false>(reinterpret_cast<const float*>(t.x[i]), e0, e1);
  return span_absmax<__nv_bfloat16, false>(reinterpret_cast<const __nv_bfloat16*>(t.x[i]), e0,
                                           e1);
}

// the absmax of every chunk, walked with a grid stride: a block keeps a
// running max while its chunks stay in one piece and publishes it (block
// max, one atomicMax) when the piece changes or the walk ends
__global__ void __launch_bounds__(kThreads)
    absmax_many_kernel(const __grid_constant__ TensorTable t, float* absmax) {
  float m = 0.0f;
  int cur = -1;
  for (long long c = blockIdx.x;; c += gridDim.x) {  // block-uniform
    const int i = c < t.total_chunks ? piece_of(t, c) : -1;
    if (i != cur && cur >= 0) {
      m = block_max(m);
      if (threadIdx.x == 0)
        atomicMax(reinterpret_cast<int*>(absmax + t.slot[cur]), __float_as_int(m));
      m = 0.0f;
    }
    if (i < 0) break;
    cur = i;
    m = ps::max_nonneg(m, chunk_absmax(t, i, c));
  }
}

__device__ __forceinline__ void quantize_chunk(const TensorTable& t, long long c,
                                               const float* absmax, float* scale) {
  const int i = piece_of(t, c);
  const long long e0 = (c - t.first_chunk[i]) * kChunk;
  const long long e1 = min(e0 + kChunk, t.n[i]);
  const float amax = absmax[t.slot[i]];
  const float inv = ps::inv_scale(amax);
  if (e0 == 0 && threadIdx.x == 0) scale[t.slot[i]] = amax * ps::kRecip127;
  int8_t* q = reinterpret_cast<int8_t*>(t.q[i]);
  if (t.kind[i] == kF32Vec)
    span_quantize<float, true>(reinterpret_cast<const float*>(t.x[i]), q, e0, e1, inv);
  else if (t.kind[i] == kF32)
    span_quantize<float, false>(reinterpret_cast<const float*>(t.x[i]), q, e0, e1, inv);
  else
    span_quantize<__nv_bfloat16, false>(reinterpret_cast<const __nv_bfloat16*>(t.x[i]), q, e0,
                                        e1, inv);
}

// last chunks first: they are what absmax_many_kernel read last
__global__ void __launch_bounds__(kThreads)
    quantize_many_kernel(const __grid_constant__ TensorTable t, const float* absmax,
                         float* scale) {
  for (long long c = t.total_chunks - 1 - blockIdx.x; c >= 0; c -= gridDim.x)
    quantize_chunk(t, c, absmax, scale);
}

// resident blocks of `kernel` on the current card (cached per device and kernel)
int resident_blocks(const void* kernel, int which) {
  static int cache[16][2];  // zero: not computed yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 16 && cache[dev][which] > 0) return cache[dev][which];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  const int blocks = sms * per_sm;
  if (dev < 16) cache[dev][which] = blocks;
  return blocks;
}

unsigned grid_for(long long work, int resident) {
  return (unsigned)(work < resident ? work : resident);
}

}  // namespace

extern "C" long long ps_tensor_table_words() { return sizeof(TensorTable) / sizeof(long long); }

static int read_table(const long long* words, TensorTable* t) {
  memcpy(t, words, sizeof *t);
  if (t->count < 1 || t->count > ps::kMaxPieces || t->total_chunks != t->first_chunk[t->count] ||
      t->total_chunks < 1)
    return (int)cudaErrorInvalidValue;
  for (long long i = 0; i < t->count; ++i)
    if (t->n[i] < 1 || t->kind[i] < kF32Vec || t->kind[i] > kBF16)
      return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

static int launch_absmax(const TensorTable& t, float* absmax, cudaStream_t s) {
  const int ra = resident_blocks((const void*)absmax_many_kernel, 0);
  if (ra < 1) return (int)cudaErrorInvalidConfiguration;
  absmax_many_kernel<<<grid_for(t.total_chunks, ra), kThreads, 0, s>>>(t, absmax);
  return (int)cudaGetLastError();
}

static int launch_quantize(const TensorTable& t, const float* absmax, float* scale,
                           cudaStream_t s) {
  const int rq = resident_blocks((const void*)quantize_many_kernel, 1);
  if (rq < 1) return (int)cudaErrorInvalidConfiguration;
  quantize_many_kernel<<<grid_for(t.total_chunks, rq), kThreads, 0, s>>>(t, absmax, scale);
  return (int)cudaGetLastError();
}

// One table of K2's multi-tensor entry: `words` is a TensorTable, slots
// absmax[slot] (zeroed by the caller) and scale[slot].
extern "C" int ps_quantize_tensors(const long long* words, void* absmax, void* scale,
                                   void* stream) {
  TensorTable t;
  if (const int err = read_table(words, &t)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(absmax);
  if (const int err = launch_absmax(t, a, s)) return err;
  return launch_quantize(t, a, static_cast<float*>(scale), s);
}

// K2's split route, for a worker axis that spans processes: the
// cross-process max of the absmax (a torch.distributed all_reduce over
// its int32 bits, ops/quantize.py) has to sit between the two kernels of
// ps_quantize_tensors, so each gets its own entry over the same table.
// ps_absmax_tensors: this process's absmax of every piece into
// absmax[slot] (zeroed by the caller); ps_quantize_tensors_given: the
// quantize with the reduced absmax[slot], scale[slot] = absmax * (1/127).
// The kernels are the fused entry's, so each process's half of the work
// is bit for bit what the one-process call computes.
extern "C" int ps_absmax_tensors(const long long* words, void* absmax, void* stream) {
  TensorTable t;
  if (const int err = read_table(words, &t)) return err;
  return launch_absmax(t, static_cast<float*>(absmax), static_cast<cudaStream_t>(stream));
}

extern "C" int ps_quantize_tensors_given(const long long* words, const void* absmax,
                                         void* scale, void* stream) {
  TensorTable t;
  if (const int err = read_table(words, &t)) return err;
  return launch_quantize(t, static_cast<const float*>(absmax), static_cast<float*>(scale),
                         static_cast<cudaStream_t>(stream));
}
