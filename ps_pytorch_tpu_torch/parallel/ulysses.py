"""Ulysses (all-to-all) sequence parallelism (the port of
parallel/ulysses.py), the alternative to the ring.

Activations stay sequence-sharded ``[B, T/n, H, D]`` everywhere except
inside attention, where two all_to_alls re-shard them:

    [B, T/n, H, D] --a2a(split H, concat T)--> [B, T, H/n, D]
        attention over the COMPLETE sequence, local heads
    [B, T, H/n, D] --a2a(split T, concat H)--> [B, T/n, H, D]

On the stacked backend the n shards are one tensor ``[n, B, T/n, H, D]``
and each all_to_all is ``WorkerAxis.all_to_all`` on a ``[sender,
receiver, ...]`` arrangement of it. ``impl="flash"`` runs the local
attention on ``flash_attention`` (K4 forward, K5 + K6 backward in the
input dtype), on every receiver's gathered sequence in one launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import WorkerAxis
from .ring_attention import full_attention, shard_sequence, unshard_sequence


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: WorkerAxis, causal: bool = False,
                      scale: Optional[float] = None,
                      impl: str = "naive") -> torch.Tensor:
    """Exact attention over stacked sequence shards ``[n, B, T_loc, H, D]``
    via two all_to_alls (ulysses.py:37). Needs ``H % n == 0``. Returns the
    stacked output shards."""
    n, b, t, h, d = q.shape
    if n != axis.size:
        raise ValueError(f"expected stacked shards [{axis.size}, B, T_loc, H, D], "
                         f"got {tuple(q.shape)}")
    if h % n:
        raise ValueError(f"heads {h} not divisible by sequence axis size {n}")
    hn = h // n

    def seq_to_heads(x):  # [n, B, t, H, D] -> [n * B, n * t, H/n, D]
        x = x.reshape(n, b, t, n, hn, d).permute(0, 3, 1, 2, 4, 5)  # [src, dst, ...]
        x = axis.all_to_all(x)  # [dst, src, B, t, H/n, D]
        return x.permute(0, 2, 1, 3, 4, 5).reshape(n * b, n * t, hn, d)

    def heads_to_seq(x):  # [n * B, n * t, H/n, D] -> [n, B, t, H, D]
        x = x.reshape(n, b, n, t, hn, d).permute(0, 2, 1, 3, 4, 5)  # [heads, seq, ...]
        x = axis.all_to_all(x)  # [seq shard, head group, B, t, H/n, D]
        return x.permute(0, 2, 3, 1, 4, 5).reshape(n, b, t, h, d)

    if impl == "flash":
        from ..ops.flash_attention import flash_attention as attend
    elif impl == "naive":
        attend = full_attention
    else:
        raise ValueError(f"unknown attention_impl {impl!r}")
    o = attend(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
               causal=causal, scale=scale)
    return heads_to_seq(o)


def make_ulysses_attention(axis: WorkerAxis, causal: bool = False, impl: str = "naive"):
    """Sequence-sharded attention (ulysses.py:81): (q, k, v) ``[B, T, H, D]``
    global -> ``[B, T, H, D]`` global, T split over the axis's workers (the
    contract of ``ring_attention.make_ring_attention``)."""
    def attend(q, k, v):
        shards = (shard_sequence(x, axis) for x in (q, k, v))
        return unshard_sequence(ulysses_attention(*shards, axis=axis, causal=causal, impl=impl),
                                axis)

    return attend
