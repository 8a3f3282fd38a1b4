"""Gradient aggregation on the stacked worker backend (the port of
parallel/collectives.py: the flat wires, serial schedule).

Every per-worker gradient leaf is worker-stacked ``[N, *shape]``; an
aggregate comes back once, without the worker dimension (the replicated
result of the JAX collective). Reference semantics:

- ``psum_mean``: sum over workers / num_aggregate
  (sync_replicas_master_nn.py:204-208);
- ``aggregation_mask``: partial ("backup-worker") aggregation, only K of
  N gradients enter the sum (:179-186); ``random_k`` models "first K to
  arrive", ``first_k`` is the deterministic variant;
- ``quantized_psum``: every piece quantized in one kernel call (shared
  absmax, the pmax, and int8 payload of each piece: K2 per tensor, K1's
  shared-scale entry per block), then per piece the exact integer psum
  -> dequantize / K. ``wire_domain="homomorphic"`` sums in
  the minimal exact accumulator (``accum_dtype``: int16 through 258
  workers) and folds 1/K into the one deferred scale multiply;
- ``quantized_allreduce_2round``: the int8-on-the-wire two-round scheme
  (round 1 quantize -> all_to_all -> exact region sums; round 2
  requantize with local scales -> all_gather), or on the homomorphic
  wire round 1 -> K3's fused accumulate-rescale -> all_gather -> one
  deferred multiply by the round-1 scales;
- ``local_quantized_contribution``: what each worker's gradient becomes
  after its int8 round trip (error feedback);
- ``aggregate_gradients``: mask -> (quantized) reduce -> / K.

A piece is one leaf (``bucket_bytes=None``) or one bucket of each
worker's flattened tree (``buckets.piece_stream``); every scheme and the
EF contribution share that stream. Each quantize stage takes all of a
step's pieces in one multi-tensor kernel call
(``ops.quantize.quantize_int8_many``); what follows it runs per piece.

Division by the aggregation count: the JAX step divides by a Python
float inside jit, which XLA turns into a multiply by the f32 reciprocal
(``x / 5.0`` is ``x * f32(1/5)``); the port multiplies by that constant
so the wire is bit-exact against the reference. K3's rescale is the one
true division (an IEEE quotient): for the accumulations it sees,
``|acc| <= 127 * K``, both spellings give the same rounded integer.

``jax.random.permutation`` cannot be reproduced in torch: the random_k
mask takes its permutation from a ``torch.Generator``, or the caller
injects one (the parity tests inject JAX's).

The same functions run on ``mesh.ProcessWorkerAxis``, where each
process holds its own workers' rows ``[N_loc, *shape]`` and the axis's
collectives cross the processes (its docstring has the dtype and order
rules); the quantize stage then takes the split route
(``quantize_int8_many``).

Not ported yet, and refused with a pointer to ROADMAP.md: the
hierarchical wire (a tuple axis), the pipelined order, stochastic
rounding, a traced (adaptive) ``num_aggregate`` and ``bucket_peaks``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.quantize import (
    accum_dtype,
    accumulate_rescale_int8,
    dequantize_int8,
    fold_recip,
    quantize_int8_many,
    quantize_rows_many,
    quantize_tensors,
)
from .buckets import piece_stream, tree_flatten, tree_unflatten
from .mesh import ProcessWorkerAxis, WorkerAxis

_ROADMAP = "is not ported yet (ROADMAP.md queue 1"


def reciprocal(denominator: float) -> float:
    """The f32 constant XLA multiplies by where the JAX code divides by
    the Python float ``denominator`` inside jit."""
    return float(np.float32(1.0) / np.float32(denominator))


def _check_axis(axis) -> None:
    if not isinstance(axis, (WorkerAxis, ProcessWorkerAxis)):
        raise NotImplementedError(
            f"axis {axis!r}: the stacked WorkerAxis and the process-spanning "
            f"ProcessWorkerAxis are ported; tuple axes (the hierarchical DCN x ICI "
            f"wire) {_ROADMAP} item 14)"
        )


def _check_rounding(rounding: str, key) -> None:
    if rounding != "nearest" or key is not None:
        raise NotImplementedError(f"stochastic rounding {_ROADMAP} item 5)")


def _per_worker(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-worker ``[N]`` value shaped to broadcast against a
    worker-stacked ``[N, *shape]`` tensor."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1)).to(like.dtype)


def random_permutation(num_workers: int, generator: torch.Generator) -> torch.Tensor:
    """The random_k mask's permutation of worker indices, drawn from a
    (CPU) ``torch.Generator``: the port's stand-in for
    ``jax.random.permutation(key, num_workers)``."""
    return torch.randperm(num_workers, generator=generator)


def aggregation_mask(
    axis: WorkerAxis,
    num_workers: int,
    num_aggregate,
    perm: Optional[torch.Tensor] = None,
    mode: str = "random_k",
    device=None,
) -> torch.Tensor:
    """Per-worker {0,1} f32 ``[N]`` (this process's ``[N_loc]`` rows on
    a process-spanning axis): does worker w's gradient enter the sum?
    With num_aggregate None or >= num_workers every worker does.
    ``random_k`` selects ``perm[:num_aggregate]`` (``perm`` a permutation
    of ``range(N)``, the same on every process: the caller draws it, see
    ``random_permutation``), ``first_k`` selects ``w < num_aggregate``."""
    _check_axis(axis)
    if isinstance(num_aggregate, torch.Tensor):
        raise NotImplementedError(f"a traced (adaptive) num_aggregate {_ROADMAP} item 15)")
    if num_aggregate is None or num_aggregate >= num_workers:
        return torch.ones((axis.local_size,), dtype=torch.float32, device=device)
    if mode == "first_k":
        return (axis.axis_index(device) < num_aggregate).float()
    if mode == "random_k":
        if perm is None:
            raise ValueError("random_k masking needs a permutation of the workers")
        perm = torch.as_tensor(perm, dtype=torch.long).to(device)
        selected = torch.zeros((num_workers,), dtype=torch.float32, device=device)
        return axis.local(selected.index_fill(0, perm[:num_aggregate], 1.0))
    raise ValueError(f"unknown aggregation mode {mode!r}")


def psum_mean(tree, axis: WorkerAxis, denominator: float,
              bucket_bytes: Optional[int] = None, flat_output: bool = False):
    """Sum over workers / denominator, per piece (parity: _model_update
    divides the aggregate buffer by num_aggregate). ``flat_output``
    returns the padded flat vector instead of the tree."""
    _check_axis(axis)
    recip = reciprocal(denominator)
    pieces, _, rebuild = piece_stream(tree, bucket_bytes, flat_output=flat_output)
    return rebuild([axis.psum(g) * recip for g in pieces])


def quantized_psum(
    tree,
    axis: WorkerAxis,
    denominator: float,
    block_size: int = 0,
    rounding: str = "nearest",
    key=None,
    bucket_bytes: Optional[int] = None,
    flat_output: bool = False,
    wire_domain: str = "dequant",
    num_workers: Optional[int] = None,
    return_contribution: bool = False,
):
    """int8-quantized gradient all-reduce, per piece: shared absmax (the
    pmax) -> int8 quantize -> exact integer psum -> dequantize /
    denominator. Deterministic (one scale for all workers).

    The dequant wire sums in int32 and divides after dequantizing,
    ``(s * scale) * (1/K)``. The homomorphic wire (collectives.py:271-278)
    sums in ``accum_dtype(num_workers)`` (int16 through 258 workers:
    half the bytes, the same integers) and dequantizes once with
    ``scale / K``, which XLA folds with the scale's own ``* (1/127)``
    into ``absmax * fold_recip(K)`` (one f32 constant). The spellings
    differ in the last bit, so each is copied as XLA runs it.

    ``return_contribution`` also returns each worker's dequantized
    payload (worker-stacked, tree-shaped): the value
    ``local_quantized_contribution`` computes, from the same
    quantization instead of a second one."""
    _check_axis(axis)
    _check_rounding(rounding, key)
    homomorphic = wire_domain == "homomorphic"
    if homomorphic and num_workers is None:
        raise ValueError("homomorphic quantized_psum needs num_workers (it sizes "
                         "the exact accumulator dtype)")
    recip = reciprocal(denominator)
    align = block_size or 1
    pieces, _, rebuild = piece_stream(tree, bucket_bytes, align=align,
                                      flat_output=flat_output)
    outs, contribs = [], []
    quantized = quantize_int8_many([g.float() for g in pieces], axis, block_size)
    for g, (q, scale, absmax) in zip(pieces, quantized):
        shape = tuple(g.shape[1:])
        if homomorphic:
            s = axis.psum(q.to(accum_dtype(num_workers)))
            outs.append(dequantize_int8(s, absmax * fold_recip(denominator),
                                        block_size=block_size, shape=shape))
        else:
            s = axis.psum(q.to(torch.int32))
            outs.append(dequantize_int8(s, scale, block_size=block_size, shape=shape)
                        * recip)
        if return_contribution:
            contribs.append(dequantize_int8(q.to(torch.int32), scale,
                                            block_size=block_size, shape=shape))
    agg = rebuild(outs)
    if not return_contribution:
        return agg
    return agg, piece_stream(tree, bucket_bytes, align=align)[2](contribs)


def _slice_len(total: int, n: int, block_size: int) -> int:
    """Per-worker region length: ceil(total/n) rounded up to whole
    quantization blocks (collectives.py:295)."""
    bs = block_size or 1
    return (-(-total // n) + bs - 1) // bs * bs


def _q2r_scatter_stage(q1: torch.Tensor, scale1: torch.Tensor, axis: WorkerAxis, n: int,
                       s: int, block_size: int) -> torch.Tensor:
    """Round 1 of the two-round scheme for one piece (collectives.py:302),
    after its shared-scale int8 quantize ``q1`` (``[N, n*s]`` as a flat
    padded piece) and ``scale1``: all_to_all int8 -> exact int32 region
    sums -> dequantize each region with its own rows of the shared
    scales. Returns ``partial [n, s]`` f32: row w is worker w's region of
    the sum (an int8-wire reduce_scatter)."""
    recv = axis.all_to_all(q1.reshape(-1, n, s))  # [n(region), N(sender), s]
    partial = recv.to(torch.int32).sum(1, dtype=torch.int32)
    if block_size:
        nb_loc = s // block_size
        my_scales = axis.local(scale1.reshape(n, nb_loc, 1))
        return (partial.reshape(-1, nb_loc, block_size).float() * my_scales).reshape(-1, s)
    return partial.float() * scale1


def _deq_shared(full: torch.Tensor, scale, gain: float, block_size: int) -> torch.Tensor:
    """THE single deferred scale-multiply of the homomorphic wire
    (collectives.py:370): int8 payload x (shared scale x gain) -> f32,
    per block row or per tensor."""
    if block_size:
        return (full.reshape(-1, block_size).float() * (scale * gain)).reshape(-1)
    return full.float() * (scale * gain)


def _q2r_gather_stage(partials, axis: WorkerAxis, n: int, block_size: int):
    """Round 2 (collectives.py:383) for every piece: requantize each
    region's partial sum with LOCAL scales (no cross-worker agreement:
    the regions are disjoint) and all_gather int8 plus the scale rows ->
    each piece's dequantized full ``[n*s]``. Per tensor: ONE K2 call over
    every region of every piece (each region has its own absmax). Block
    mode: ONE K1 ``quantize_rows_many`` call over the block rows of every
    piece (rows are independent, so this equals n per-region calls per
    piece)."""
    if block_size:
        rows = quantize_rows_many([p.reshape(-1, block_size) for p in partials])
        outs = []
        for partial, (q2, scale2) in zip(partials, rows):
            s = partial.shape[1]
            full = axis.all_gather(q2.reshape(-1, s))
            scales2 = axis.all_gather(scale2.reshape(-1, s // block_size, 1))  # [n*nb_loc, 1]
            outs.append((full.reshape(-1, block_size).float() * scales2).reshape(-1))
        return outs
    nl = axis.local_size
    regions = quantize_tensors([partial[w] for partial in partials for w in range(nl)])
    outs = []
    for i, partial in enumerate(partials):
        mine = regions[i * nl:(i + 1) * nl]
        full = axis.all_gather(torch.stack([q for q, _, _ in mine]))
        scales2 = axis.all_gather(torch.stack([sc for _, sc, _ in mine]).reshape(nl, 1))
        outs.append((full.reshape(n, partial.shape[1]).float() * scales2[:, None]).reshape(-1))
    return outs


def quantized_allreduce_2round(
    tree,
    axis: WorkerAxis,
    denominator: float,
    num_workers: int,
    block_size: int = 0,
    rounding: str = "nearest",
    key=None,
    bucket_bytes: Optional[int] = None,
    flat_output: bool = False,
    wire_domain: str = "dequant",
    return_contribution: bool = False,
):
    """The two-round int8 all-reduce whose wire carries int8
    (collectives.py:405). Each piece is flattened and padded to ``[n,
    s]``; round 1 quantizes every piece in one kernel call (shared-scale
    int8), then per piece all_to_all and exact region sums ->

    - dequant wire: round 2 requantizes each region with local scales
      (every region of every piece in one call: K2 per tensor, K1's
      ``quantize_rows_many`` per block), all_gathers int8 plus the scale
      rows, and dequantizes; then * 1/K;
    - homomorphic wire: K3 sums each region's worker rows and rescales
      them by K back onto the int8 lattice, the result is all_gathered,
      and ONE deferred multiply by the round-1 scales dequantizes it (the
      denominator is already folded into K3).

    Stacked launch shape: worker w's K3 call would take its region's
    ``[N, s]`` rows after the all_to_all, and the all_gather would
    concatenate the n results. The regions lie side by side in the
    stacked round-1 payload ``[N, n*s]``, so ONE launch over it equals
    that concatenation: one K3 launch per piece (once per step at
    ``bucket_bytes=0``).

    ``return_contribution`` also returns each worker's round-1 round
    trip, worker-stacked and tree-shaped (the EF contribution mirrors
    round 1 only; round 2's noise is not residual-tracked, as in JAX):
    the value ``local_quantized_contribution`` computes, from round 1's
    own quantization (the padding to ``n*s`` is zeros, which changes no
    scale and no block boundary)."""
    _check_axis(axis)
    _check_rounding(rounding, key)
    if axis.size != num_workers:
        raise ValueError(f"axis holds {axis.size} workers, not {num_workers}")
    n = num_workers
    recip = reciprocal(denominator)
    align = block_size or 1
    pieces, _, rebuild = piece_stream(tree, bucket_bytes, align=align,
                                      flat_output=flat_output)
    shapes = [tuple(g.shape[1:]) for g in pieces]
    totals = [int(np.prod(shape, dtype=np.int64)) for shape in shapes]
    slices = [_slice_len(total, n, block_size) for total in totals]
    nl = axis.local_size
    padded = [torch.nn.functional.pad(g.float().reshape(nl, total), (0, n * s - total))
              for g, total, s in zip(pieces, totals, slices)]
    round1 = quantize_int8_many(padded, axis, block_size)  # every piece, one call
    if wire_domain == "homomorphic":
        # the all_to_all hands this process's workers the [N, s] rows of
        # their regions; K3 over them side by side ([N, n_loc*s]) computes
        # every local region at once, and the all_gather concatenates the
        # regions. In the stacked backend the all_to_all is a transposed
        # view and its inverse gives q1 [N, n*s] back without a copy: one
        # K3 launch over it, as before
        deqs = [_deq_shared(axis.all_gather(accumulate_rescale_int8(
                    axis.all_to_all(q1.reshape(nl, n, s)).transpose(0, 1).reshape(n, nl * s),
                    denominator).reshape(nl, s)),
                            scale1, 1.0, block_size)  # denominator folded into K3
                for (q1, scale1, _), s in zip(round1, slices)]
    else:
        partials = [_q2r_scatter_stage(q1, scale1, axis, n, s, block_size)
                    for (q1, scale1, _), s in zip(round1, slices)]
        deqs = [deq * recip for deq in _q2r_gather_stage(partials, axis, n, block_size)]
    outs = [deq[:total].reshape(shape) for deq, total, shape in zip(deqs, totals, shapes)]
    agg = rebuild(outs)
    if not return_contribution:
        return agg
    contribs = []
    for (q1, scale1, _), total, shape, s in zip(round1, totals, shapes, slices):
        qc = q1.reshape((nl, -1, block_size) if block_size else (nl, n * s))
        c = dequantize_int8(qc.to(torch.int32), scale1, block_size=block_size,
                            shape=(n * s,))
        contribs.append(c[:, :total].reshape((nl,) + shape))
    return agg, piece_stream(tree, bucket_bytes, align=align)[2](contribs)


def local_quantized_contribution(
    grads,
    axis: WorkerAxis,
    block_size: int = 0,
    rounding: str = "nearest",
    key=None,
    bucket_bytes: Optional[int] = None,
):
    """What each worker's gradient becomes after its shared-scale int8
    round trip, worker-stacked and tree-shaped: the transmitted value
    whose difference from the gradient is the error-feedback residual
    (mirrors ``quantized_psum`` and round 1 of the two-round scheme
    exactly: same pieces, same scales, same rounding)."""
    _check_axis(axis)
    _check_rounding(rounding, key)
    pieces, _, rebuild = piece_stream(grads, bucket_bytes, align=block_size or 1)
    quantized = quantize_int8_many([g.float() for g in pieces], axis, block_size)
    return rebuild([dequantize_int8(q.to(torch.int32), scale, block_size=block_size,
                                    shape=tuple(g.shape[1:]))
                    for g, (q, scale, _) in zip(pieces, quantized)])


def aggregate_gradients(
    grads,
    axis: WorkerAxis,
    num_workers: int,
    num_aggregate=None,
    perm: Optional[torch.Tensor] = None,
    mask_mode: str = "random_k",
    compress: Optional[str] = None,
    quant_block_size: int = 0,
    quant_rounding: str = "nearest",
    quant_key=None,
    return_contribution: bool = False,
    bucket_bytes: Optional[int] = None,
    flat_output: bool = False,
    pipelined: bool = False,
    wire_domain: str = "dequant",
    bucket_peaks=None,
):
    """The full PS aggregation: mask -> (bucket) -> (quantized) reduce ->
    / K.

    ``grads`` is a tree of worker-stacked ``[N, *shape]`` leaves. The
    aggregate is the tree (or, with ``flat_output``, the padded flat f32
    vector) without the worker dimension. ``bucket_bytes`` picks the wire granularity: None =
    one piece per leaf, 0 = one fused buffer, N = ~N-byte buckets.
    ``return_contribution`` also returns each worker's transmitted
    (post-mask, post-round-trip) value, worker-stacked and tree-shaped:
    what error feedback subtracts. ``perm`` is random_k's permutation
    (``random_permutation``)."""
    if wire_domain not in ("dequant", "homomorphic"):
        raise ValueError(f"bad wire_domain {wire_domain!r}")
    if wire_domain == "homomorphic":
        if compress in (None, "none"):
            raise ValueError(
                "wire_domain='homomorphic' needs a compress mode — an "
                "uncompressed f32 psum has no compressed domain to sum in")
        if quant_rounding == "stochastic":
            raise ValueError("wire_domain='homomorphic' needs quant_rounding='nearest'")
    _check_axis(axis)
    if axis.size != num_workers:
        raise ValueError(f"axis holds {axis.size} workers, not {num_workers}")
    if bucket_peaks is not None:
        raise NotImplementedError(f"adaptive per-bucket precision {_ROADMAP} item 15)")
    if pipelined:
        raise NotImplementedError(f"the pipelined wire (--overlap on) {_ROADMAP} item 13)")
    k = (num_aggregate
         if (num_aggregate is not None and num_aggregate < num_workers)
         else num_workers)
    if k != num_workers:
        leaves, skeleton = tree_flatten(grads)
        sel = aggregation_mask(axis, num_workers, num_aggregate, perm, mask_mode,
                               device=leaves[0].device)
        grads = tree_unflatten(skeleton, [g * _per_worker(sel, g) for g in leaves])
    wire = dict(bucket_bytes=bucket_bytes, flat_output=flat_output)
    if compress in (None, "none"):
        agg = psum_mean(grads, axis, float(k), **wire)
        contribution = grads  # lossless transmit: the residual is zero
    elif compress == "int8":
        out = quantized_psum(
            grads, axis, float(k), block_size=quant_block_size,
            rounding=quant_rounding, key=quant_key, wire_domain=wire_domain,
            num_workers=num_workers, return_contribution=return_contribution, **wire,
        )
        agg, contribution = out if return_contribution else (out, None)
    elif compress == "int8_2round":
        out = quantized_allreduce_2round(
            grads, axis, float(k), num_workers, block_size=quant_block_size,
            rounding=quant_rounding, key=quant_key, wire_domain=wire_domain,
            return_contribution=return_contribution, **wire,
        )
        agg, contribution = out if return_contribution else (out, None)
    else:
        raise ValueError(f"unknown compression {compress!r}")
    if not return_contribution:
        return agg
    return agg, contribution
