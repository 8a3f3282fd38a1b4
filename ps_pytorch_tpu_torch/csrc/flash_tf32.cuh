// The TF32 tensor-core building blocks of the f32 flash kernels: K4
// (flash_fwd.cu) and K5 / K6 (flash_bwd.cu) on f32 inputs. They overload
// flash_mma.cuh's bf16 tile helpers (load_rows, gemm_abt, gemm_split_ab)
// for float tiles, so one kernel body serves both input types.
//
// 3xTF32. The TPU kernels take every product in f32; one TF32 product
// (10 mantissa bits) misses the port's 5e-5 bound by 6-23x. Each f32
// operand enters as a pair hi = tf32(x), lo = tf32(x - hi), both rounded
// by cvt.rna (to nearest, ties away from zero), and each 8-deep step of
// a . b becomes three m16n8k8 products: hi.lo and lo.hi first, then
// hi.hi (the missing lo.lo and the rounding of lo are ~2^-21 of |a b|),
// at 494.7 / 3 = 164.9 TFLOP/s on the H100, 2.5x its f32 CUDA-core peak.
//
// The tensor cores truncate the sum an mma leaves in its accumulator
// (round toward zero; Fasi et al. 2021). Chained over a whole
// contraction into the running accumulator, that bias grows with its
// length: on the H100 the gradients drifted to 2e-5 of their largest
// value at T = 2048, 12-38x the error of the f32 CUDA-core sums they
// replaced. So each step's three products go into a fresh accumulator,
// and the step is added to the running one by an f32 add, rounded to
// nearest, outside the tensor cores (Ootomo and Yokota 2022): 2.5-5x
// that error, 2.7e-6 of the largest value at most (PERF.md).
//
// Shared rows are D + kPad32 floats long (16 bytes of padding), so that
// every row starts on a 16-byte boundary for cp.async and, D being a
// multiple of 32, the pitch P is 4 (mod 32) words. The two ways a tile is
// read as B are then both free of bank conflicts:
//   * along D (B of Q.K^T): lane (g, t) reads row g, column t (+4):
//     bank 4 g + t, 32 distinct;
//   * along the rows (B of dS.K, in the permuted contraction order of
//     gemm_split_ab): lane (g, t) reads rows 2 t and 2 t + 1, column g:
//     banks 8 t + g and 8 t + 4 + g, 32 distinct each.
// A pitch of D + 8 (8 mod 32) makes both 2-way; an unpermuted row read
// (rows t, t + 4) would be 2-way at D + 4. The A fragments (row g, column
// t) read like the first case.
#pragma once

#include <type_traits>

#include "flash_mma.cuh"

namespace ps {

constexpr int kPad32 = 4;  // floats per smem row past D: 16 bytes

// Shared rows: D plus 16 bytes of padding (flash_mma.cuh, above).
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + (sizeof(T) == sizeof(bf16) ? kPad : kPad32);
}

// x rounded to TF32 (cvt.rna: to nearest, ties away from zero), as the
// f32 bit pattern with its low 13 mantissa bits zero
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16 x 8, f32) += a (16 x 8, tf32) . b (8 x 8, tf32). Fragments, for
// g = lane / 4 and t = lane % 4: a[0] = (row g, k t), a[1] = (row g + 8,
// k t), a[2] = (row g, k t + 4), a[3] = (row g + 8, k t + 4); b0 = (k t,
// col g), b1 = (k t + 4, col g); c as mma16816's: c[0..1] = (row g, cols
// 2t, 2t+1), c[2..3] = (row g + 8, the same cols).
__device__ __forceinline__ void mma1688(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b from split operands: the two small products, then the large,
// into a fresh accumulator that one f32 add per element folds into c
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4],
                                           const unsigned (&bhi)[2],
                                           const unsigned (&blo)[2]) {
  float s[4] = {};
  mma1688(s, ahi, blo[0], blo[1]);
  mma1688(s, alo, bhi[0], bhi[1]);
  mma1688(s, ahi, bhi[0], bhi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];
}

// Rows [r0, r0 + ROWS) of a [T, D] f32 head slice (row stride st) into
// shared rows of pitch D + kPad32, 16 bytes a copy by each of the block's
// THREADS threads; rows past T are zeroed.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long st,
                                          int r0, int T_len) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks, t = r0 + r;
    const float* g = src + (long long)(t < T_len ? t : 0) * st + c * 4;
    cp_async16(dst + r * (D + kPad32) + c * 4, g, t < T_len ? 16 : 0);
  }
}

// A shared f32 tile of pitch P as an operand: raw values, each split into
// a TF32 pair as it is read (const float*), or a SplitTile, split once
// into hi / lo planes: hi = tf32(x) and lo = tf32(x - hi), as f32 bit
// patterns.
struct SplitTile {
  const float* hi;
  const float* lo;
};

__device__ __forceinline__ void tf32_pair(const float* t, int i, unsigned& hi, unsigned& lo) {
  split_tf32(t[i], hi, lo);
}

__device__ __forceinline__ void tf32_pair(SplitTile t, int i, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(t.hi[i]);
  lo = __float_as_uint(t.lo[i]);
}

template <typename X>
constexpr bool kF32Tile = std::is_convertible_v<X, const float*> || std::is_same_v<X, SplitTile>;

// Rows [0, ROWS) of a shared f32 tile of pitch D + kPad32 split in place
// into planes: hi stays in t, lo goes to the same place in lo; 16 bytes a
// step by each of the block's THREADS threads.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void split_rows(float* t, float* lo) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int at = (i / kChunks) * (D + kPad32) + (i % kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(t + at);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(t + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// acc (16 x N as N / 8 fragments) += A (16 x KD) . B^T, B N x KD; A and B
// row-major f32 tiles in shared memory, pitch P; 3xTF32.
template <int N, int KD, int P, typename A, typename B,
          typename = std::enable_if_t<kF32Tile<A> && kF32Tile<B>>>
__device__ __forceinline__ void gemm_abt(float (&acc)[N / 8][4], A a, B b, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int k = 0; k < KD; k += 8) {
    unsigned ahi[4], alo[4];
    const int ar = g * P + k + t;
    tf32_pair(a, ar, ahi[0], alo[0]);
    tf32_pair(a, ar + 8 * P, ahi[1], alo[1]);
    tf32_pair(a, ar + 4, ahi[2], alo[2]);
    tf32_pair(a, ar + 8 * P + 4, ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < N; n += 8) {
      const int br = (n + g) * P + k + t;
      unsigned bhi[2], blo[2];
      tf32_pair(b, br, bhi[0], blo[0]);
      tf32_pair(b, br + 4, bhi[1], blo[1]);
      mma_3xtf32(acc[n / 8], ahi, alo, bhi, blo);
    }
  }
}

// acc (16 x D as D / 8 fragments) += X . B, X the f32 16 x N C fragments a
// gemm_abt left, B N x D row-major f32 in shared memory, pitch P; X and B
// both enter as TF32 pairs (3xTF32). A C fragment holds columns 2t, 2t + 1
// of its n8 tile where A wants k-slots t, t + 4, so the contraction runs
// in a permuted order (a sum does not care): k-slot t <-> column 2t,
// k-slot t + 4 <-> column 2t + 1. X then feeds A register for register,
// a = (c0, c2, c1, c3), and B's rows are read in the same order: rows
// 2t (b0) and 2t + 1 (b1). No shuffle, no round trip through shared
// memory.
template <int N, int D, int P, typename B, typename = std::enable_if_t<kF32Tile<B>>>
__device__ __forceinline__ void gemm_split_ab(float (&acc)[D / 8][4],
                                              const float (&x)[N / 8][4], B b, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    unsigned hi[4], lo[4];
    split_tf32(x[j][0], hi[0], lo[0]);  // (row g,     k-slot t)     = (g, 2t)
    split_tf32(x[j][2], hi[1], lo[1]);  // (row g + 8, k-slot t)     = (g + 8, 2t)
    split_tf32(x[j][1], hi[2], lo[2]);  // (row g,     k-slot t + 4) = (g, 2t + 1)
    split_tf32(x[j][3], hi[3], lo[3]);  // (row g + 8, k-slot t + 4) = (g + 8, 2t + 1)
    const int br = (8 * j + 2 * t) * P + g;
#pragma unroll
    for (int n = 0; n < D; n += 8) {
      unsigned bhi[2], blo[2];
      tf32_pair(b, br + n, bhi[0], blo[0]);
      tf32_pair(b, br + P + n, bhi[1], blo[1]);
      mma_3xtf32(acc[n / 8], hi, lo, bhi, blo);
    }
  }
}

}  // namespace ps
