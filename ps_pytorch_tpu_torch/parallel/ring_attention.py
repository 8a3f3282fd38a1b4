"""Ring attention — sequence parallelism over a stacked worker axis (the
port of parallel/ring_attention.py).

Each of the n workers of a sequence axis holds a ``[B, T/n, H, D]`` shard
of Q/K/V; K/V rotate around the ring and every hop folds its block into a
running (max m, sum l, numerator) triple, so softmax is exact without the
``[T, T]`` score matrix. On the stacked backend (parallel/mesh.py) the n
shards are one tensor ``[n, B, T_loc, H, D]`` on one device; a hop is one
computation over all of them, and the rotation is ``WorkerAxis.ppermute``
(``[(j, (j - 1) % n)]``: worker j's block goes to j - 1, so after s hops
worker i holds block ``(i + s) % n``).

- ``ring_attention``: the jnp ring (``--attention-impl naive``), plain
  PyTorch, differentiated by autograd;
- ``ring_flash_attention``: the flash kernel inside every hop (K4's
  partial triple, one launch per hop for every stacked shard, with each
  shard's offsets in a device table) and a backward ring of K5 + K6 in
  which the f32 dk/dv accumulators travel with their K/V shard and are
  home after n rotations (ring_attention.py:355-448);
- both rotate both ways with ``bidirectional=True``: the own block, then
  ``_bidir_plan(n)`` two-block hops. Where even n brings offset n/2 on
  both streams, the JAX ring computes the duplicate and masks it to a
  no-op; here it is not computed (the merge of a masked triple is the
  identity, bit for bit), so each offset costs one hop either way.

``full_attention`` is the single-device reference and the ``naive``
within-device attention.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mesh import WorkerAxis, make_mesh

SEQ_AXIS = "seq"

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


def _perm_fwd(n: int):
    """Send my block to the previous worker (ring_attention.py:123)."""
    return [(j, (j - 1) % n) for j in range(n)]


def _perm_bwd(n: int):
    return [(j, (j + 1) % n) for j in range(n)]


def _bidir_plan(n: int):
    """Offsets 1..n-1 covered by +s (fwd) and -s (bwd) streams; for even n
    the offset n/2 arrives on both — drop the bwd duplicate."""
    n_hops = (n - 1 + 1) // 2
    use_bwd = np.ones(n_hops, bool)
    if n % 2 == 0 and n_hops:
        use_bwd[-1] = False
    return n_hops, use_bwd


def _hop_shifts(n: int, bidirectional: bool):
    """The block shifts a forward visits, in order, as (stream, shift):
    stream 0 the one-way or forward stream, 1 the backward one."""
    if not bidirectional or n <= 2:
        return [(0, s) for s in range(n)]
    n_hops, use_bwd = _bidir_plan(n)
    out = [(0, 0)]
    for i, s in enumerate(range(1, n_hops + 1)):
        out.append((0, s))
        if use_bwd[i]:
            out.append((1, -s))
    return out


def _visits(k, v, axis: WorkerAxis, bidirectional: bool):
    """The K/V blocks a forward visits, in order, as (shift, k, v): worker
    i holds block ``(i + shift) % n``. Each stream rotates only as far as
    its next shift needs."""
    n = axis.size
    streams = {0: (k, v, 0), 1: (k, v, 0)}
    for stream, shift in _hop_shifts(n, bidirectional):
        kc, vc, rotated = streams[stream]
        perm = _perm_fwd(n) if stream == 0 else _perm_bwd(n)
        for _ in range(abs(shift) - rotated):
            kc, vc = axis.ppermute(kc, perm), axis.ppermute(vc, perm)
        streams[stream] = (kc, vc, abs(shift))
        yield shift, kc, vc


# ----------------------------------------------------------- the jnp ring


def _block_attend(q, k, v, mask, scale):
    """One (query-block x key-block) contribution on stacked shards.

    q: ``[n, B, Tq, H, D]``; k/v: ``[n, B, Tk, H, D]``; mask: ``[n, Tq,
    Tk]`` bool or None. Returns (m_blk ``[n, B, H, Tq]``, p_sum, pv ``[n,
    B, Tq, H, D]`` f32): statistics f32 whatever the input dtype, p cast
    to v's dtype for the PV product (ring_attention.py:39-67)."""
    scores = torch.einsum("nbqhd,nbkhd->nbhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full((), _NEG_BIG, device=q.device))
    m_blk = scores.amax(dim=-1)
    p = torch.exp(scores - m_blk[..., None])
    if mask is not None:
        # rows with no valid key: m_blk == _NEG_BIG and p would be exp(0)=1
        p = torch.where(mask[:, None, None], p, torch.zeros((), device=q.device))
    pv = torch.einsum("nbhqk,nbkhd->nbqhd", p.to(v.dtype).float(), v.float())
    return m_blk, p.sum(dim=-1), pv


def _accumulate(acc, m_blk, p_sum, pv):
    """Fold one block's (max, sum, numerator) into the running triple."""
    o, m, l = acc
    m_new = torch.maximum(m, m_blk)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_blk - m_new)
    l_new = l * alpha + p_sum * beta
    o_new = (o * alpha.transpose(-1, -2)[..., None]
             + pv * beta.transpose(-1, -2)[..., None])
    return o_new, m_new, l_new


def _shard_check(q, k, v, axis: WorkerAxis) -> None:
    if q.dim() != 5 or q.shape[0] != axis.size:
        raise ValueError(f"expected stacked shards [{axis.size}, B, T_loc, H, D], "
                         f"got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v shards must share one shape")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: WorkerAxis, causal: bool = False,
                   scale: Optional[float] = None,
                   bidirectional: bool = False) -> torch.Tensor:
    """Exact attention over sequence shards rotating on a ring
    (ring_attention.py:84), on stacked shards ``[n, B, T_loc, H, D]``
    (worker i holds global positions ``i * T_loc ...``). Returns the
    stacked output shards. Plain PyTorch; autograd differentiates it
    (the rotation's gradient is the inverse rotation)."""
    _shard_check(q, k, v, axis)
    n, b, t_loc, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    me = axis.axis_index(q.device)
    pos = torch.arange(t_loc, device=q.device)
    q_pos = me[:, None] * t_loc + pos  # [n, Tq] global query positions

    def block_mask(shift):
        if not causal:
            return None
        k_pos = ((me + shift) % n)[:, None] * t_loc + pos
        return k_pos[:, None, :] <= q_pos[:, :, None]  # [n, Tq, Tk]

    m0 = torch.full((n, b, h, t_loc), _NEG_BIG, device=q.device)
    acc = (torch.zeros(q.shape, dtype=torch.float32, device=q.device), m0,
           torch.zeros_like(m0))
    for shift, kc, vc in _visits(k, v, axis, bidirectional):
        acc = _accumulate(acc, *_block_attend(q, kc, vc, block_mask(shift), scale))
    o, _, l = acc
    # causal guarantees >= 1 valid key per query (its own position), so l > 0
    return (o / l.transpose(-1, -2)[..., None]).to(q.dtype)


# ---------------------------------------------------------- ring + flash


def _merge_triple(acc, hop):
    """Online-softmax merge of two (pv ``[N, T, H, D]``, m ``[N, H, T]``,
    l ``[N, H, T]``) triples (ring_attention.py:206)."""
    pv, m, l = acc
    pv_h, m_h, l_h = hop
    m_new = torch.maximum(m, m_h)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_h - m_new)
    return (pv * alpha.transpose(1, 2)[..., None] + pv_h * beta.transpose(1, 2)[..., None],
            m_new, l * alpha + l_h * beta)


def _hop_offsets(axis: WorkerAxis, b: int, t_loc: int, shift: int, device):
    """Per stacked batch row (worker-major, ``[n * B]``): the global
    offsets of the local queries and of the visiting key block
    ``(me + shift) % n`` (ring_attention.py:289-300)."""
    me = axis.axis_index(device)
    q_off = (me * t_loc).repeat_interleave(b)
    k_off = (((me + shift) % axis.size) * t_loc).repeat_interleave(b)
    return q_off, k_off


class _RingFlash(torch.autograd.Function):
    """ring_flash_attention's custom VJP (ring_attention.py:235-451)."""

    @staticmethod
    def forward(ctx, q, k, v, axis: WorkerAxis, causal: bool, scale: float,
                bidirectional: bool):
        from ..ops.flash_attention import flash_partial

        n, b, t_loc, h, d = q.shape
        fold = lambda x: x.reshape(n * b, t_loc, h, d)  # a view: no copy
        q3 = fold(q)
        acc = None
        for shift, kc, vc in _visits(k, v, axis, bidirectional):
            # only the causal mask reads global positions (a non-causal
            # ring passes offset 0, ring_attention.py:279-284)
            q_off, k_off = (_hop_offsets(axis, b, t_loc, shift, q.device)
                            if causal else (0, 0))
            hop = flash_partial(q3, fold(kc), fold(vc), causal, scale, q_off, k_off)
            # merging the first triple into (0, NEG_INF, 0) returns it
            # unchanged, so the running triple starts from it
            acc = hop if acc is None else _merge_triple(acc, hop)
        pv, m, l = acc
        l_safe = torch.where(l == 0.0, torch.ones((), device=l.device), l)
        o3 = pv / l_safe.transpose(1, 2)[..., None]
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, o3, lse)
        ctx.cfg = (axis, causal, scale, bidirectional)
        return o3.to(q.dtype).reshape(q.shape)

    @staticmethod
    def backward(ctx, do):
        from ..ops.flash_attention import flash_grads_partial

        q, k, v, o3, lse = ctx.saved_tensors
        axis, causal, scale, bidirectional = ctx.cfg
        n, b, t_loc, h, d = q.shape
        fold = lambda x: x.reshape(n * b, t_loc, h, d)
        in_dtype = do.dtype
        do3 = fold(do).to(q.dtype)
        # delta from the f32 normalized output (ring_attention.py:368-369)
        delta = (do3.float() * o3).sum(dim=-1).transpose(1, 2).contiguous()
        q3 = fold(q)

        def grads_at(kc, vc, shift):
            q_off, k_off = (_hop_offsets(axis, b, t_loc, shift, q.device)
                            if causal else (0, 0))
            dq_h, dk_h, dv_h = flash_grads_partial(q3, fold(kc), fold(vc), do3, lse,
                                                   delta, scale, causal, q_off, k_off)
            return dq_h, dk_h.reshape(k.shape), dv_h.reshape(v.shape)

        fwd, bwd = _perm_fwd(n), _perm_bwd(n)
        if not bidirectional or n <= 2:
            dq, kc, vc, dkc, dvc = None, k, v, None, None
            for s in range(n):
                dq_h, dk_h, dv_h = grads_at(kc, vc, s)
                dq = dq_h if dq is None else dq + dq_h
                dkc = dk_h if dkc is None else dkc + dk_h
                dvc = dv_h if dvc is None else dvc + dv_h
                # dk/dv accumulators travel WITH their k/v shard; after n
                # rotations every shard (and its gradient) is home
                if s < n - 1:
                    kc, vc = axis.ppermute(kc, fwd), axis.ppermute(vc, fwd)
                dkc, dvc = axis.ppermute(dkc, fwd), axis.ppermute(dvc, fwd)
            dk, dv = dkc, dvc
        else:
            dq, dk_own, dv_own = grads_at(k, v, 0)  # own block, no comm
            n_hops, use_bwd = _bidir_plan(n)
            zeros = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            kf, vf, dkf, dvf = k, v, zeros, zeros
            kb, vb, dkb, dvb = k, v, zeros, zeros
            for i, s in enumerate(range(1, n_hops + 1)):
                kf, vf, dkf, dvf = (axis.ppermute(x, fwd) for x in (kf, vf, dkf, dvf))
                kb, vb, dkb, dvb = (axis.ppermute(x, bwd) for x in (kb, vb, dkb, dvb))
                dq_f, dkh, dvh = grads_at(kf, vf, s)
                dq, dkf, dvf = dq + dq_f, dkf + dkh, dvf + dvh
                if use_bwd[i]:  # the even-n duplicate is not computed
                    dq_b, dkh, dvh = grads_at(kb, vb, -s)
                    dq, dkb, dvb = dq + dq_b, dkb + dkh, dvb + dvh
            # deliver the traveling accumulators home in one rotation each:
            # after n_hops forward rotations, worker j's forward accumulator
            # is block (j + n_hops) % n's (ring_attention.py:431-445)
            home_f = [(j, (j + n_hops) % n) for j in range(n)]
            home_b = [(j, (j - n_hops) % n) for j in range(n)]
            dk = dk_own + axis.ppermute(dkf, home_f) + axis.ppermute(dkb, home_b)
            dv = dv_own + axis.ppermute(dvf, home_f) + axis.ppermute(dvb, home_b)
        return (dq.reshape(q.shape).to(in_dtype), dk.to(in_dtype), dv.to(in_dtype),
                None, None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis: WorkerAxis, causal: bool = False,
                         scale: Optional[float] = None,
                         bidirectional: bool = False) -> torch.Tensor:
    """ring_attention with the flash kernel inside each hop (K4's partial
    triple forward, K5 + K6 backward), on stacked shards ``[n, B, T_loc,
    H, D]``. Exact (the same math as ``ring_attention``); per-hop memory
    is the f32 (pv, m, l) triple, never a ``[T_loc, T_loc]`` tile on the
    card. CPU tensors run the kernels' plain versions."""
    _shard_check(q, k, v, axis)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _RingFlash.apply(q, k, v, axis, bool(causal), float(scale),
                            bool(bidirectional))


def make_seq_mesh(num_shards: int) -> WorkerAxis:
    """1-D sequence-parallel axis of ``num_shards`` stacked workers."""
    return make_mesh(num_shards)


def shard_sequence(x: torch.Tensor, axis: WorkerAxis) -> torch.Tensor:
    """``[B, T, ...]`` -> stacked shards ``[n, B, T / n, ...]`` (the
    counterpart of placing T sharded along the mesh axis)."""
    b, t = x.shape[0], x.shape[1]
    n = axis.size
    if t % n:
        raise ValueError(f"sequence length {t} is not divisible by {n} shards")
    rest = tuple(x.shape[2:])
    return x.reshape((b, n, t // n) + rest).transpose(0, 1).contiguous()


def unshard_sequence(x: torch.Tensor, axis: WorkerAxis) -> torch.Tensor:
    """Inverse of ``shard_sequence``: ``[n, B, T / n, ...]`` -> ``[B, T, ...]``."""
    axis._check(x)
    n, b, t_loc = x.shape[0], x.shape[1], x.shape[2]
    return x.transpose(0, 1).reshape((b, n * t_loc) + tuple(x.shape[3:]))


def make_ring_attention(axis: WorkerAxis, causal: bool = False,
                        bidirectional: bool = False, impl: str = "naive"):
    """Sequence-sharded attention (ring_attention.py:486): (q, k, v)
    ``[B, T, H, D]`` global -> ``[B, T, H, D]`` global, T split over the
    axis's workers. ``impl="flash"`` runs the flash kernels per hop."""
    if impl not in ("naive", "flash"):
        raise ValueError(f"unknown ring impl {impl!r}")
    ring = ring_flash_attention if impl == "flash" else ring_attention

    def attend(q, k, v):
        shards = (shard_sequence(x, axis) for x in (q, k, v))
        return unshard_sequence(
            ring(*shards, axis=axis, causal=causal, bidirectional=bidirectional), axis)

    return attend
