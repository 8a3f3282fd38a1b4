// The one mask rule of the flash kernels K4 (flash_fwd.cu), K5 and K6
// (flash_bwd.cu): the counterpart of
// ps_pytorch_tpu/ops/flash_attention.py:_mask_scores, whose docstring warns
// that gradients silently stop matching the forward when the forward and
// backward masks diverge. Every kernel decides which (query, key) pairs
// are kept, and which tiles it may skip, through this header alone.
//
// A pair (local query row q, local key position k) is kept when
//   k < kv_len                              (key-length mask, LOCAL positions)
//   and, under causal, k_off + k <= q_off + q   (GLOBAL positions).
// q_off / k_off are the global positions of local row 0 of the query and
// key operands: 0 on one device; on a sequence-parallel ring hop the
// shard offsets me * t_loc and ((me + s) % n) * t_loc. They come either as
// two scalars or from a device int32 table with one (q_off, k_off) row per
// batch index, so one launch covers every stacked shard of a hop.
#pragma once

#include "common.cuh"

namespace ps {

struct FlashMask {
  int causal;
  int kv_len;            // keys at or past it are masked
  long long q_off, k_off;
};

__device__ __forceinline__ FlashMask flash_mask(int causal, int k_len, int Tk,
                                                const int* off_table, int q_off,
                                                int k_off, int b) {
  FlashMask m;
  m.causal = causal;
  m.kv_len = k_len >= 0 ? min(k_len, Tk) : Tk;
  m.q_off = off_table != nullptr ? off_table[2 * b] : q_off;
  m.k_off = off_table != nullptr ? off_table[2 * b + 1] : k_off;
  return m;
}

__device__ __forceinline__ bool keep(const FlashMask& m, int q, int key) {
  return key < m.kv_len && (!m.causal || m.k_off + key <= m.q_off + q);
}

// The causal tile-skip rule, seen from a query tile: query rows [0, q_end)
// keep no key at or past the returned count, so key tiles from there on
// contribute exactly nothing (K4: alpha = 1, p = 0; K5: ds = 0).
__device__ __forceinline__ int key_limit(const FlashMask& m, int q_end) {
  long long n = m.kv_len;
  if (m.causal) {
    const long long need = m.q_off + q_end - m.k_off;  // last row's keys + 1
    n = min(n, need > 0 ? need : 0LL);
  }
  return (int)n;
}

// Every pair of query rows [q0, ...) and keys [k0, k0 + nk) is kept: the
// keys lie below kv_len and, under causal, the last of them is at or
// before the first query. K5/K6 skip keep() on such tiles and evaluate it
// per fragment element only on tiles that cross the diagonal, k_len or
// Tk (rows past Tq are zeroed by the lse guard, not by the mask).
__device__ __forceinline__ bool tile_kept(const FlashMask& m, int q0, int k0, int nk) {
  return k0 + nk <= m.kv_len && (!m.causal || m.k_off + k0 + nk - 1 <= m.q_off + q0);
}

// The same rule seen from a key tile starting at key0 (K6): no query row
// before the returned one keeps any key >= key0; Tq when none does.
__device__ __forceinline__ int first_query(const FlashMask& m, int key0, int Tq) {
  if (key0 >= m.kv_len) return Tq;
  if (!m.causal) return 0;
  const long long f = m.k_off + key0 - m.q_off;
  return (int)(f < 0 ? 0LL : (f > Tq ? (long long)Tq : f));
}

}  // namespace ps
