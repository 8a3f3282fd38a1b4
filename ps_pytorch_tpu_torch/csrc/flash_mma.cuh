// The tensor-core building blocks of the bf16 flash kernels K4
// (flash_fwd.cu) and K5/K6 (flash_bwd.cu): bf16 tiles in padded shared
// rows filled by cp.async, ldmatrix fragments, mma.sync.m16n8k16 with f32
// accumulators in registers, and the bf16 hi + lo split that lets an f32
// operand enter a product (the TPU kernels take P and dS in f32).
//
// Shared rows are D + kPad bf16 long: the 16 bytes of padding put the 8
// rows an ldmatrix phase reads into 8 different bank groups.
#pragma once

#include "common.cuh"

namespace ps {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 per smem row past D: 16 bytes

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; with
// src_bytes = 0 nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. With .trans each matrix arrives transposed.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16). Fragments, for
// g = lane / 4 and t = lane % 4: c[0..1] = (row g, cols 2t, 2t+1), c[2..3]
// = (row g + 8, the same cols); a[0] = (row g, cols 2t, 2t+1), a[1] = (row
// g + 8, ...), a[2] / a[3] the same 8 columns on; b[0] = (rows 2t, 2t+1,
// col g), b[1] = (rows 2t + 8, 2t + 9, col g).
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a bf16 pair hi = bf16(x) (round to nearest even) and
// the rest lo = bf16(x - hi): hi + lo carries x to about 2^-16 of |x|.
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Rows [r0, r0 + ROWS) of a [T, D] bf16 head slice (row stride st) into
// shared rows of pitch D + kPad, 16 bytes a copy by each of the block's
// THREADS threads; rows past T are zeroed.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long st,
                                          int r0, int T_len) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks, t = r0 + r;
    const bf16* g = src + (long long)(t < T_len ? t : 0) * st + c * 8;
    cp_async16(dst + r * (D + kPad) + c * 8, g, t < T_len ? 16 : 0);
  }
}

// acc (16 x N as N / 8 fragments) += A (16 x KD) . B^T, B N x KD; A and B
// row-major bf16 in shared memory, pitch P.
template <int N, int KD, int P>
__device__ __forceinline__ void gemm_abt(float (&acc)[N / 8][4], const bf16* a,
                                         const bf16* b, int lane) {
#pragma unroll
  for (int k = 0; k < KD; k += 16) {
    unsigned af[4];
    ldsm4(af, a + (lane % 16) * P + k + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < N; n += 16) {
      unsigned bf[4];
      ldsm4(bf, b + (n + lane % 8 + (lane / 16) * 8) * P + k + (lane / 8 % 2) * 8);
      mma16816(acc[n / 8], af, bf[0], bf[1]);
      mma16816(acc[n / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D as D / 8 fragments) += X . B, X the f32 16 x N fragments a
// gemm_abt left (its C layout is the A layout of the next product), B
// N x D row-major bf16 in shared memory, pitch P. X enters as hi + lo:
// two products into the same accumulator.
template <int N, int D, int P>
__device__ __forceinline__ void gemm_split_ab(float (&acc)[D / 8][4],
                                              const float (&x)[N / 8][4],
                                              const bf16* b, int lane) {
#pragma unroll
  for (int k = 0; k < N; k += 16) {
    unsigned hi[4], lo[4];
    const float* c0 = x[k / 8];
    const float* c1 = x[k / 8 + 1];
    split2(c0[0], c0[1], hi[0], lo[0]);
    split2(c0[2], c0[3], hi[1], lo[1]);
    split2(c1[0], c1[1], hi[2], lo[2]);
    split2(c1[2], c1[3], hi[3], lo[3]);
#pragma unroll
    for (int n = 0; n < D; n += 16) {
      unsigned bf[4];
      ldsm4_t(bf, b + (k + lane % 16) * P + n + (lane / 16) * 8);
      mma16816(acc[n / 8], hi, bf[0], bf[1]);
      mma16816(acc[n / 8 + 1], hi, bf[2], bf[3]);
      mma16816(acc[n / 8], lo, bf[0], bf[1]);
      mma16816(acc[n / 8 + 1], lo, bf[2], bf[3]);
    }
  }
}

// One pair of adjacent output columns, straight from a C fragment.
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The tensor-core routes copy 16-byte chunks and store output pairs: every
// [D] row starts on a 16-byte boundary (base address aligned, batch, time
// and head strides multiples of vec elements: 8 bf16, 4 f32).
inline bool rows_aligned(const void* p, const long long* st, int vec = 8) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % vec == 0 &&
         st[1] % vec == 0 && st[2] % vec == 0;
}

}  // namespace ps
