"""Slot-pooled KV cache for the continuous-batching engine (the port of
serve/kv.py).

One ``[depth, slots, max_len, heads, head_dim]`` buffer pair, each slot
an independent sequence at its own position. Two formats, selected by
``ServeConfig.kv_int8``:

- compute-dtype (f32/bf16) K/V, attended by the single-request decoder's
  own ``_attend_cached`` (per-slot length vector) — the token-exactness
  oracle path;
- int8 K/V with one f32 absmax scale per (position, head) vector,
  quantized by kernel K1 (ops/quantize.quantize_int8, block = head_dim).
  Attention upcasts the int8 payload for the products and folds the
  scales into the f32 score and probability rows instead of
  materializing a dequantized pool (kv.py:127-147).

Writes update the pool IN PLACE (the JAX version returns new buffers):
a slice assignment at admission (prefill) and an indexed assignment at
each slot's own position inside the decode step. The attention products
stay ``torch.einsum`` (matmul work JAX leaves to XLA).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import DeviceLike, resolve_device
from ..models.decode import NEG_INF, _attend_cached
from ..models.transformer import TransformerConfig
from ..ops.quantize import quantize_int8


def init_kv_pool(cfg: TransformerConfig, slots: int, max_len: int,
                 int8: bool = False, device: DeviceLike = None) -> Dict:
    """Zeroed slot pool: compute-dtype buffers, or int8 payloads plus f32
    per-(position, head) scale rows when ``int8``."""
    dev = resolve_device(device)
    shape = (cfg.depth, slots, max_len, cfg.heads, cfg.head_dim)
    if not int8:
        cd = cfg.effective_compute_dtype
        return {"k": torch.zeros(shape, dtype=cd, device=dev),
                "v": torch.zeros(shape, dtype=cd, device=dev)}
    sshape = (cfg.depth, slots, max_len, cfg.heads, 1)
    return {
        "k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
        "k_s": torch.zeros(sshape, dtype=torch.float32, device=dev),
        "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v_s": torch.zeros(sshape, dtype=torch.float32, device=dev),
    }


def pool_is_int8(pool: Dict) -> bool:
    return "k_q" in pool


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``[..., H, hd]`` to int8 with one scale per head vector:
    block = head_dim divides the flattened size, so no block straddles a
    (position, head) boundary. bf16 input goes to K1 as it is (the
    kernel widens it to f32 exactly, as kv.py:70's cast does)."""
    hd = x.shape[-1]
    q, s = quantize_int8(x, block_size=hd)
    return q.reshape(x.shape), s.reshape(x.shape[:-1] + (1,))


def write_slot(pool: Dict, block: int, slot: int,
               k: torch.Tensor, v: torch.Tensor) -> Dict:
    """Admission write: this block's full-prompt K/V ``[T, H, hd]`` into
    slot positions ``[0, T)``."""
    t = k.shape[0]
    if not pool_is_int8(pool):
        for name, val in (("k", k), ("v", v)):
            buf = pool[name]
            buf[block, slot, :t] = val.to(buf.dtype)
        return pool
    for name, val in (("k", k), ("v", v)):
        q, s = _quant_rows(val)
        pool[name + "_q"][block, slot, :t] = q
        pool[name + "_s"][block, slot, :t] = s
    return pool


def write_token(pool: Dict, block: int, pos: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor) -> Dict:
    """Decode-step write: one token's K/V ``[S, H, hd]`` at each slot's
    OWN position (``pos`` int ``[S]``)."""
    sl = torch.arange(k.shape[0], device=k.device)
    if not pool_is_int8(pool):
        for name, val in (("k", k), ("v", v)):
            buf = pool[name]
            buf[block, sl, pos] = val.to(buf.dtype)
        return pool
    for name, val in (("k", k), ("v", v)):
        q, s = _quant_rows(val)
        pool[name + "_q"][block, sl, pos] = q
        pool[name + "_s"][block, sl, pos] = s
    return pool


def attend_pool(pool: Dict, block: int, q: torch.Tensor,
                lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """q ``[S, 1, H, hd]`` against this block's pool rows; per-slot
    positions >= ``lengths[s]`` masked."""
    if not pool_is_int8(pool):
        return _attend_cached(q, pool["k"][block], pool["v"][block],
                              lengths, scale)
    k_q, k_s = pool["k_q"][block], pool["k_s"][block]
    v_q, v_s = pool["v_q"][block], pool["v_s"][block]
    # scores[b,h,1,l] = (q . k_q[l,h]) * scale * k_s[l,h]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_q.float()) * scale
    row_scale = k_s[..., 0].transpose(1, 2)[:, :, None, :]  # [S, H, 1, L]
    scores = scores * row_scale
    pos = torch.arange(k_q.shape[1], device=q.device)
    mask = pos[None, None, None, :] < lengths.reshape(-1, 1, 1, 1)
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    # fold v's scale into the probability row; p is never cast
    pv = p * v_s[..., 0].transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", pv, v_q.float())
    return out.to(q.dtype)
