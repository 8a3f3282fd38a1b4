"""Slot-pooled KV cache for the continuous-batching engine (the port of
serve/kv.py).

One ``[depth, slots, max_len, heads, head_dim]`` buffer pair, each slot
an independent sequence at its own position. Two formats, selected by
``ServeConfig.kv_int8``:

- compute-dtype (f32/bf16) K/V, attended by the single-request decoder's
  own ``_attend_cached`` (per-slot length vector) — the token-exactness
  oracle path;
- int8 K/V with one f32 absmax scale per (position, head) vector.
  Attention upcasts the int8 payload for the products and folds the
  scales into the f32 score and probability rows instead of
  materializing a dequantized pool (kv.py:127-147).

Writes update the pool IN PLACE (the JAX version returns new buffers):
a slice at admission (prefill) and each slot's own position inside the
decode step. On the int8 pool one launch a layer of kernel K1's KV entry
(ops/quantize.quantize_kv_write) quantizes K and V and stores them, a
decode position read on the device (JAX: ``_quant_rows`` then the
update, kv.py:62-113). The attention products stay ``torch.einsum``
(matmul work JAX leaves to XLA).
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import DeviceLike, resolve_device
from ..models.decode import NEG_INF, _attend_cached
from ..models.transformer import TransformerConfig
from ..ops.quantize import quantize_kv_write


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


def _int8_views(pool: Dict, block: int):
    return (pool["k_q"][block], pool["k_s"][block], pool["v_q"][block], pool["v_s"][block])


def write_slot(pool: Dict, block: int, slot: int,
               k: torch.Tensor, v: torch.Tensor) -> Dict:
    """Admission write: this block's full-prompt K/V ``[T, H, hd]`` into
    slot positions ``[0, T)``."""
    if not pool_is_int8(pool):
        t = k.shape[0]
        for name, val in (("k", k), ("v", v)):
            buf = pool[name]
            buf[block, slot, :t] = val.to(buf.dtype)
        return pool
    quantize_kv_write(k, v, *_int8_views(pool, block), slot=slot)
    return pool


def write_token(pool: Dict, block: int, pos: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor) -> Dict:
    """Decode-step write: one token's K/V ``[S, H, hd]`` at each slot's
    OWN position (``pos`` int ``[S]``). Both pools wrap a negative
    position once by ``max_len`` and drop one still outside ``[0,
    max_len)``, as JAX's scatter does."""
    if not pool_is_int8(pool):
        max_len = pool["k"].shape[2]
        p = pos.long()
        p = torch.where(p < 0, p + max_len, p)
        # a dropped row writes its slot's current value back (no host
        # sync: the mask stays on the device)
        keep = ((p >= 0) & (p < max_len))[:, None, None]
        p = p.clamp(0, max_len - 1)
        sl = torch.arange(k.shape[0], device=k.device)
        for name, val in (("k", k), ("v", v)):
            buf = pool[name]
            buf[block, sl, p] = torch.where(keep, val.to(buf.dtype), buf[block, sl, p])
        return pool
    quantize_kv_write(k, v, *_int8_views(pool, block), pos=pos)
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
