"""Within-device reference attention (the port of
parallel/ring_attention.full_attention, ring_attention.py:454-476).

This is the ``"naive"`` ``attention_impl`` and the oracle the flash
kernel is held against. The ring itself (K/V rotation over a sequence
mesh, flash per hop) comes with the sequence-parallel slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_BIG = -1e30


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact softmax attention, ``[B, T, H, D]``. Scores and softmax in
    f32 whatever the input dtype; ``p`` is cast to v's dtype before the PV
    product (ring_attention.py:473), with f32 accumulation."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        scores = torch.where(
            mask[None, None], scores,
            torch.full((), _NEG_BIG, device=q.device),
        )
    p = torch.softmax(scores, dim=-1)
    # p rounds to v's dtype (as the JAX einsum operand does); the product
    # of two values of that dtype is exact in f32, so upcasting both keeps
    # the f32 accumulation of preferred_element_type=f32
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
