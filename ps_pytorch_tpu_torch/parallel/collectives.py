"""Gradient aggregation on the stacked worker backend (the port of
parallel/collectives.py).

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
so the wire is bit-exact against the reference. K3's rescale is a true
division (an IEEE quotient): for the accumulations it sees, ``|acc| <=
127 * K``, both spellings give the same rounded integer. The adaptive
count (``num_aggregate`` a device int32 tensor, resilience/elastic.py)
is traced in JAX, so there every division by it is a quotient, and the
port divides tensor by tensor (``_divide``); K3 reads it from device
memory.

``jax.random.permutation`` cannot be reproduced in torch: the random_k
mask takes its permutation from a ``torch.Generator``, or the caller
injects one (the parity tests inject JAX's). Stochastic rounding takes
its U[0, 1) draws from a draw source, ``draws(piece_id, round, shape)
-> f32 [N, *shape]`` (every worker's draws for one piece; the wire keeps
this process's rows): JAX folds its key by the worker, then the piece's
key id (the leaf's index, or on a bucketed wire the bucket's START
OFFSET), then 1 for the two-round wire's round 2 (collectives.py:244,
:474, :495). ``parallel.ps.draw_step`` makes one from the step's
generator; the parity tests make JAX's.

Adaptive per-bucket precision (``bucket_peaks``, a device f32 vector of
lattice peaks, one per bucket of the wire's plan in canonical order):
each bucket quantizes through ``quantize_lattice`` at its peak, in plain
PyTorch (no K1 / K2 launch), as JAX takes no Pallas kernel there.

The same functions run on ``mesh.ProcessWorkerAxis``, where each
process holds its own workers' rows ``[N_loc, *shape]`` and the axis's
collectives cross the processes (its docstring has the dtype and order
rules); the quantize stage then takes the split route
(``quantize_int8_many``).

The pipelined schedule (``pipelined=True``, a bucketed wire) has one
implementation, ``_bucket_reduce``: one bucket's whole wire a call,
under a profiler range named ``bucket_reduce_o<start>`` as JAX's named
scope is, so each kernel stage takes one bucket a call. ``bucket_wire``
puts the step's mask in front of it for the PS step, which calls it as
each bucket's gradients exist (``ps._BucketStream``); ``_pipelined``
drives it over a whole tree in readiness order for the wires'
``pipelined=`` keyword. The values are the serial wire's, bit for bit.

The hierarchical DCN x ICI wire (``quantized_allreduce_2round_hier``)
runs on the hybrid grid (JAX's tuple axis): ``mesh.HybridWorkerAxis`` on
one process, or ``mesh.ProcessHybridAxis``, whose processes each hold
whole hosts. ``aggregate_gradients`` routes ``int8_2round`` there, and
every other wire reduces over the grid as over the flat axis.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops._tape import worker_rows
from ..ops.quantize import (
    _INT8_PEAK,
    RECIP_127,
    _inv_scale,
    _round,
    accum_dtype,
    accumulate_rescale_int8,
    dequantize_int8,
    fold_recip,
    quantize_int8,
    quantize_int8_many,
    quantize_lattice,
    quantize_rows_many,
    quantize_tensors,
)
from .buckets import piece_stream, tree_flatten, tree_unflatten
from .mesh import GRIDS, ProcessWorkerAxis, WorkerAxis

def reciprocal(denominator: float) -> float:
    """The f32 constant XLA multiplies by where the JAX code divides by
    the Python float ``denominator`` inside jit."""
    return float(np.float32(1.0) / np.float32(denominator))


def _check_axis(axis) -> None:
    if not isinstance(axis, (WorkerAxis, ProcessWorkerAxis)):
        raise TypeError(
            f"axis {axis!r}: a worker axis is a mesh.WorkerAxis, a ProcessWorkerAxis, or "
            f"the hybrid DCN x ICI grid (mesh.make_hybrid_mesh: JAX's tuple axis)")


# draws(piece_id, round, shape) -> f32 U[0, 1) [N, *shape]
UniformDraws = Callable[[int, int, Tuple[int, ...]], torch.Tensor]


def _check_rounding(rounding: str, draws) -> None:
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if rounding == "stochastic" and draws is None:
        raise ValueError("stochastic rounding needs a key (the port: a draw source, "
                         "collectives.UniformDraws)")


def _uniform(draws: Optional[UniformDraws], axis, piece_id: int, round_: int, shape,
             device) -> Optional[torch.Tensor]:
    """This process's workers' draws for one piece, on ``device`` (None
    without a source)."""
    if draws is None:
        return None
    return axis.local(draws(int(piece_id), round_, tuple(int(d) for d in shape))).to(device)


def _divide(x: torch.Tensor, denominator) -> torch.Tensor:
    """``x / K`` as the JAX step computes it: a static K is a Python
    float, which XLA turns into a multiply by its f32 reciprocal; the
    adaptive count is traced there, a true quotient (here a 0-d f32
    device tensor, divided tensor by tensor)."""
    if isinstance(denominator, torch.Tensor):
        return x / denominator
    return x * reciprocal(denominator)


def _hom_scale(scale: torch.Tensor, absmax: torch.Tensor, denominator,
               lattice: bool) -> torch.Tensor:
    """The homomorphic wire's deferred scale ``scale / K``. For the int8
    quantizer's static scale ``absmax / 127`` and a static K, XLA folds
    both constants into one (``absmax * fold_recip(K)``); a traced K is a
    quotient of the scale; a lattice scale (a quotient itself) is
    multiplied by a static K's reciprocal."""
    if isinstance(denominator, torch.Tensor):
        return scale / denominator
    if lattice:
        return scale * reciprocal(denominator)
    return absmax * fold_recip(denominator)


def _bucket_ordinal(key_ids) -> dict:
    """Each piece's canonical bucket ordinal (collectives.py:51): key ids
    on a bucketed wire are start offsets, ascending, so the ordinal is
    the offset's rank."""
    order = sorted(key_ids)
    return {i: order.index(i) for i in key_ids}


def _lattice_payload_dtype(hi_peak: int) -> torch.dtype:
    """The least integer dtype holding the HI tag's peak: the static
    payload dtype every tag of an adaptive bucket rides
    (collectives.py:61)."""
    if hi_peak <= _INT8_PEAK:
        return torch.int8
    if hi_peak <= 2 ** 15 - 1:
        return torch.int16
    return torch.int32


def _resolve_peak(bucket_peaks, ordinal, i):
    """This piece's lattice peak (a 0-d device tensor), or None on the
    static wire."""
    if bucket_peaks is None:
        return None
    return bucket_peaks[ordinal[i]]


def _check_adaptive(bucket_peaks, rounding: str, wire_domain: str) -> None:
    """JAX's refusals of the adaptive and stochastic combinations
    (collectives.py:225-239, :458-466)."""
    if bucket_peaks is not None and rounding == "stochastic":
        raise ValueError("adaptive precision needs rounding='nearest' (the traced-"
                         "peak lattice is shared-scale by construction)")
    if wire_domain == "homomorphic" and rounding == "stochastic":
        raise ValueError("homomorphic wire needs rounding='nearest' (per-worker "
                         "stochastic noise is incoherent on a shared lattice)")


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
    ``random_permutation``), ``first_k`` selects ``w < num_aggregate``.

    ``num_aggregate`` may be a device int32 tensor (the adaptive count,
    traced in JAX): the mask is then always computed, ``random_k`` by
    each worker's rank in the permutation (``argsort(perm)[w] < k``: the
    set ``perm[:k]``), so at ``k == N`` it is 1.0 everywhere and the step
    multiplies by exactly 1.0."""
    _check_axis(axis)
    dynamic = isinstance(num_aggregate, torch.Tensor)
    if not dynamic and (num_aggregate is None or num_aggregate >= num_workers):
        return torch.ones((axis.local_size,), dtype=torch.float32, device=device)
    if mode == "first_k":
        return (axis.axis_index(device) < num_aggregate).float()
    if mode == "random_k":
        if perm is None:
            raise ValueError("random_k masking needs a permutation of the workers")
        perm = torch.as_tensor(perm, dtype=torch.long).to(device)
        if dynamic:
            return axis.local((torch.argsort(perm) < num_aggregate).float())
        selected = torch.zeros((num_workers,), dtype=torch.float32, device=device)
        return axis.local(selected.index_fill(0, perm[:num_aggregate], 1.0))
    raise ValueError(f"unknown aggregation mode {mode!r}")


def _bucket_scope(key_id):
    """One bucket's reduce chain under a profiler range named as JAX's
    named scope is (``bucket_reduce_o<start offset>``, collectives.py:123),
    so a trace shows each bucket of the pipelined wire."""
    return torch.profiler.record_function(f"bucket_reduce_o{int(key_id)}")


def _psum_pieces(pieces, axis, denominator):
    """The uncompressed wire: the f32 sum / K; the transmitted value is
    the piece itself."""
    return [_divide(axis.psum(g), denominator) for g in pieces], list(pieces)


def psum_mean(tree, axis: WorkerAxis, denominator,
              bucket_bytes: Optional[int] = None, flat_output: bool = False,
              pipelined: bool = False):
    """Sum over workers / denominator, per piece (parity: _model_update
    divides the aggregate buffer by num_aggregate). ``flat_output``
    returns the padded flat vector instead of the tree; ``pipelined``
    reduces the buckets one by one in readiness order (``_pipelined``:
    the same values)."""
    _check_axis(axis)
    if pipelined and bucket_bytes is not None:
        return _pipelined(tree, bucket_bytes, 1, flat_output, False, lambda starts, _: (
            _bucket_reduce(axis, axis.size, starts, denominator)))
    pieces, _, rebuild = piece_stream(tree, bucket_bytes, flat_output=flat_output)
    return rebuild(_psum_pieces(pieces, axis, denominator)[0])


def _quantize_pieces(pieces, key_ids, axis, block_size: int, rounding: str, draws,
                     bucket_peaks, hi_peak: int, out_dtype: torch.dtype, ordinal=None,
                     round_: int = 0, rows=None):
    """Every piece's shared-scale quantize ``(q, scale, absmax)``: the
    static nearest wire in ONE multi-tensor kernel call (K2 per tensor,
    K1's shared-scale entry per block); stochastic rounding (the draws of
    ``round_``) and each bucket's lattice piece by piece in plain
    PyTorch, as JAX's jnp route. A lattice's absmax is None: its scale is
    a quotient, nothing folds into it. ``pieces`` are f32
    worker-stacked; ``ordinal`` maps a key id to its canonical bucket
    (default: the rank among ``key_ids``). On the hierarchical grid a
    piece may be one group of workers (its scales shared over ``axis``,
    that group's axis): ``rows[j]`` selects piece j's rows of every
    worker's draws (global worker ids: this process's)."""
    if rounding == "nearest" and bucket_peaks is None:
        return quantize_int8_many(pieces, axis, block_size)
    if ordinal is None and bucket_peaks is not None:
        ordinal = _bucket_ordinal(key_ids)
    out = []
    for j, (i, g) in enumerate(zip(key_ids, pieces)):
        peak = _resolve_peak(bucket_peaks, ordinal, i)
        if peak is not None:
            q, scale = quantize_lattice(g, peak, axis_name=axis, block_size=block_size,
                                        hi_peak=hi_peak, out_dtype=out_dtype)
            out.append((q, scale, None))
            continue
        n = int(np.prod(g.shape[1:], dtype=np.int64))
        shape = (-(-n // block_size), block_size) if block_size else tuple(g.shape[1:])
        if rows is None or draws is None:
            u = _uniform(draws, axis, i, round_, shape, g.device)
        else:
            u = draws(int(i), round_, tuple(int(d) for d in shape))[rows[j]].to(g.device)
        out.append(quantize_int8(g, axis_name=axis, block_size=block_size, rounding=rounding,
                                 uniform=u, return_absmax=True))
    return out


def _qpsum_pieces(pieces, key_ids, axis, denominator, block_size: int, rounding: str, draws,
                  wire_domain: str, num_workers, bucket_peaks, lattice_hi_peak: int,
                  ordinal=None, want_contrib: bool = True):
    """``quantized_psum``'s wire over ``pieces``: ``(aggregates, each
    worker's dequantized payload, or [] without want_contrib)``."""
    homomorphic = wire_domain == "homomorphic"
    payload = (accum_dtype(num_workers) if homomorphic
               else _lattice_payload_dtype(lattice_hi_peak))
    outs, contribs = [], []
    quantized = _quantize_pieces([g.float() for g in pieces], key_ids, axis, block_size,
                                 rounding, draws, bucket_peaks, lattice_hi_peak, payload,
                                 ordinal)
    for g, (q, scale, absmax) in zip(pieces, quantized):
        shape = tuple(g.shape[1:])
        if homomorphic:
            s = axis.psum(q.to(accum_dtype(num_workers)))
            outs.append(dequantize_int8(
                s, _hom_scale(scale, absmax, denominator, bucket_peaks is not None),
                block_size=block_size, shape=shape))
        else:
            s = axis.psum(q.to(torch.int32))
            outs.append(_divide(dequantize_int8(s, scale, block_size=block_size, shape=shape),
                                denominator))
        if want_contrib:
            contribs.append(dequantize_int8(q.to(torch.int32), scale, block_size=block_size,
                                            shape=shape))
    return outs, contribs


def quantized_psum(
    tree,
    axis: WorkerAxis,
    denominator,
    block_size: int = 0,
    rounding: str = "nearest",
    draws: Optional[UniformDraws] = None,
    bucket_bytes: Optional[int] = None,
    flat_output: bool = False,
    wire_domain: str = "dequant",
    num_workers: Optional[int] = None,
    return_contribution: bool = False,
    bucket_peaks=None,
    lattice_hi_peak: int = _INT8_PEAK,
    pipelined: bool = False,
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
    differ in the last bit, so each is copied as XLA runs it
    (``_hom_scale``).

    ``rounding="stochastic"`` takes each worker's draws from ``draws``
    (round 0, the piece's key id); ``bucket_peaks`` quantizes each
    bucket onto its lattice, into ``accum_dtype`` on the homomorphic
    wire and the HI peak's payload dtype on the dequant one.
    ``pipelined`` (a bucketed wire) quantizes and reduces one bucket a
    call, in readiness order (``_pipelined``): one kernel call a bucket,
    the same values.

    ``return_contribution`` also returns each worker's dequantized
    payload (worker-stacked, tree-shaped): the value
    ``local_quantized_contribution`` computes, from the same
    quantization instead of a second one."""
    _check_axis(axis)
    _check_adaptive(bucket_peaks, rounding, wire_domain)
    _check_rounding(rounding, draws)
    if wire_domain == "homomorphic" and num_workers is None:
        raise ValueError("homomorphic quantized_psum needs num_workers (it sizes "
                         "the exact accumulator dtype)")
    align = block_size or 1
    if pipelined and bucket_bytes is not None:
        return _pipelined(tree, bucket_bytes, align, flat_output, return_contribution,
                          lambda starts, _: _bucket_reduce(
                              axis, num_workers, starts, denominator, compress="int8",
                              block_size=block_size, rounding=rounding, draws=draws,
                              wire_domain=wire_domain, bucket_peaks=bucket_peaks,
                              lattice_hi_peak=lattice_hi_peak,
                              want_contrib=return_contribution))
    pieces, key_ids, rebuild = piece_stream(tree, bucket_bytes, align=align,
                                            flat_output=flat_output)
    ordinal = None if bucket_peaks is None else _bucket_ordinal(key_ids)
    outs, contribs = _qpsum_pieces(pieces, key_ids, axis, denominator, block_size, rounding,
                                   draws, wire_domain, num_workers, bucket_peaks,
                                   lattice_hi_peak, ordinal, return_contribution)
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


def _requantize_regions(partials, key_ids, axis, block_size: int, rounding: str, draws,
                        round_: int = 1):
    """Round 2's requantize of every local region of every piece with
    LOCAL scales (no cross-worker agreement: the regions are disjoint).
    Per tensor: ``[(q [s], scale, absmax)]`` for each piece's local
    regions in turn; block mode: ``[(q [nl*nb, bs], scale [nl*nb, 1])]``
    a piece. Nearest: ONE kernel call over everything (K2 per tensor, K1's
    ``quantize_rows_many`` per block: rows are independent). Stochastic:
    each worker's region as JAX quantizes it (quantize.py:133, no axis:
    its own absmax), with the round-2 draws (fold 1) of its piece, the
    local regions of a piece in one pass."""
    if rounding == "nearest":
        if block_size:
            return quantize_rows_many([p.reshape(-1, block_size) for p in partials])
        with worker_rows(axis.local_size):  # a recorded step: one site a region
            return quantize_tensors([partial[w] for partial in partials
                                     for w in range(axis.local_size)])
    out = []
    for i, partial in zip(key_ids, partials):
        s = partial.shape[1]
        shape = (s // block_size, block_size) if block_size else (s,)
        u = _uniform(draws, axis, i, round_, shape, partial.device)
        # every local region at once: its own absmax (per block row)
        xb = partial.reshape((-1,) + shape)
        absmax = xb.abs().amax(-1, keepdim=True)
        q = torch.clamp(_round(xb, _inv_scale(absmax), rounding, u),
                        -_INT8_PEAK, _INT8_PEAK).to(torch.int8)
        scale = absmax * RECIP_127
        if block_size:
            out.append((q.reshape(-1, block_size), scale.reshape(-1, 1)))
        else:
            out.extend((q[w], scale[w, 0], None) for w in range(axis.local_size))
    return out


def _q2r_gather_stage(partials, axis: WorkerAxis, n: int, block_size: int, key_ids=None,
                      rounding: str = "nearest", draws: Optional[UniformDraws] = None,
                      round_: int = 1):
    """Round 2 (collectives.py:383) for every piece: requantize each
    region's partial sum with LOCAL scales (``_requantize_regions``) and
    all_gather int8 plus the scale rows -> each piece's dequantized full
    ``[n*s]``."""
    regions = _requantize_regions(partials, key_ids, axis, block_size, rounding, draws, round_)
    if block_size:
        outs = []
        for partial, (q2, scale2) in zip(partials, regions):
            s = partial.shape[1]
            full = axis.all_gather(q2.reshape(-1, s))
            scales2 = axis.all_gather(scale2.reshape(-1, s // block_size, 1))  # [n*nb_loc, 1]
            outs.append((full.reshape(-1, block_size).float() * scales2).reshape(-1))
        return outs
    nl = axis.local_size
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
    denominator,
    num_workers: int,
    block_size: int = 0,
    rounding: str = "nearest",
    draws: Optional[UniformDraws] = None,
    bucket_bytes: Optional[int] = None,
    flat_output: bool = False,
    wire_domain: str = "dequant",
    return_contribution: bool = False,
    bucket_peaks=None,
    pipelined: bool = False,
):
    """The two-round int8 all-reduce whose wire carries int8
    (collectives.py:405). Each piece is flattened and padded to ``[n,
    s]``; round 1 quantizes every piece in one kernel call (shared-scale
    int8), then per piece all_to_all and exact region sums ->

    - dequant wire: round 2 requantizes each region with local scales
      (every region of every piece in one call: K2 per tensor, K1's
      ``quantize_rows_many`` per block), all_gathers int8 plus the scale
      rows, and dequantizes; then / K;
    - homomorphic wire: K3 sums each region's worker rows and rescales
      them by K back onto the int8 lattice, the result is all_gathered,
      and ONE deferred multiply by the round-1 scales dequantizes it (the
      denominator is already folded into K3, which reads a device K from
      device memory).

    Stochastic rounding (dequant wire only) draws round 1 at fold 0 and
    round 2 at fold 1 of each piece's key id; ``bucket_peaks`` quantizes
    round 1 onto each bucket's lattice (int8 payload: the two-round
    wire's HI peak is 127). Both take round 1 off the kernel (plain
    PyTorch, as JAX); round 2 stays on its kernels under nearest
    rounding.

    Stacked launch shape: worker w's K3 call would take its region's
    ``[N, s]`` rows after the all_to_all, and the all_gather would
    concatenate the n results. The regions lie side by side in the
    stacked round-1 payload ``[N, n*s]``, so ONE launch over it equals
    that concatenation: one K3 launch per piece (once per step at
    ``bucket_bytes=0``).

    ``pipelined`` (a bucketed wire) runs both rounds one bucket a call,
    in readiness order (``_pipelined``): each kernel stage launches once a
    bucket.

    ``return_contribution`` also returns each worker's round-1 round
    trip, worker-stacked and tree-shaped (the EF contribution mirrors
    round 1 only; round 2's noise is not residual-tracked, as in JAX):
    the value ``local_quantized_contribution`` computes, from round 1's
    own quantization (the padding to ``n*s`` is zeros, which changes no
    scale and no block boundary)."""
    _check_axis(axis)
    _check_adaptive(bucket_peaks, rounding, wire_domain)
    _check_rounding(rounding, draws)
    if axis.size != num_workers:
        raise ValueError(f"axis holds {axis.size} workers, not {num_workers}")
    align = block_size or 1
    if pipelined and bucket_bytes is not None:
        return _pipelined(tree, bucket_bytes, align, flat_output, return_contribution,
                          lambda starts, _: _bucket_reduce(
                              axis, num_workers, starts, denominator, compress="int8_2round",
                              block_size=block_size, rounding=rounding, draws=draws,
                              wire_domain=wire_domain, bucket_peaks=bucket_peaks,
                              want_contrib=return_contribution))
    pieces, key_ids, rebuild = piece_stream(tree, bucket_bytes, align=align,
                                            flat_output=flat_output)
    ordinal = None if bucket_peaks is None else _bucket_ordinal(key_ids)
    outs, contribs = _q2r_pieces(pieces, key_ids, axis, denominator, num_workers, block_size,
                                 rounding, draws, wire_domain, bucket_peaks, ordinal,
                                 return_contribution)
    agg = rebuild(outs)
    if not return_contribution:
        return agg
    return agg, piece_stream(tree, bucket_bytes, align=align)[2](contribs)


def _q2r_pieces(pieces, key_ids, axis, denominator, n: int, block_size: int, rounding: str,
                draws, wire_domain: str, bucket_peaks, ordinal, want_contrib: bool):
    """The two-round wire over ``pieces``: ``(aggregates, each worker's
    round-1 round trip or [])``."""
    shapes = [tuple(g.shape[1:]) for g in pieces]
    totals = [int(np.prod(shape, dtype=np.int64)) for shape in shapes]
    slices = [_slice_len(total, n, block_size) for total in totals]
    nl = axis.local_size
    padded = [torch.nn.functional.pad(g.float().reshape(nl, total), (0, n * s - total))
              for g, total, s in zip(pieces, totals, slices)]
    # every piece, one call on the static nearest wire
    round1 = _quantize_pieces(padded, key_ids, axis, block_size, rounding, draws,
                              bucket_peaks, _INT8_PEAK, torch.int8, ordinal)
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
        deqs = [_divide(deq, denominator) for deq in _q2r_gather_stage(
            partials, axis, n, block_size, key_ids, rounding, draws)]
    outs = [deq[:total].reshape(shape) for deq, total, shape in zip(deqs, totals, shapes)]
    contribs = []
    for (q1, scale1, _), total, shape, s in zip(round1 if want_contrib else (), totals, shapes,
                                                slices):
        qc = q1.reshape((nl, -1, block_size) if block_size else (nl, n * s))
        c = dequantize_int8(qc.to(torch.int32), scale1, block_size=block_size,
                            shape=(n * s,))
        contribs.append(c[:, :total].reshape((nl,) + shape))
    return outs, contribs


def _grid_scale(q, scale, block_size: int, groups: int, per: int, s: int) -> torch.Tensor:
    """Each group's region sums dequantized with its own rows of its
    group's shared scales: ``q`` int32 ``[groups, per(region), s]``,
    ``scale`` the groups' scales stacked (``[groups]``, or ``[groups,
    per*s/bs, 1]``) -> f32 ``[groups, per, s]``."""
    if block_size:
        nb = s // block_size
        return (q.reshape(groups, per, nb, block_size).float()
                * scale.reshape(groups, per, nb, 1)).reshape(groups, per, s)
    return q.float() * scale.reshape(groups, 1, 1)


def _hier_gain_scale(scale, absmax, gain_num: int, denominator, lattice: bool):
    """The hierarchical homomorphic wire's deferred scale ``scale * gain``
    with ``gain = (per_host * hosts) / denominator`` (collectives.py:603),
    as XLA runs it: a traced count is a quotient; a static gain of 1 drops
    out; any other static gain folds with the int8 scale's own ``1/127``
    into one f32 constant (``absmax * f32(f32(1/127) * f32(gain))``), and
    multiplies a lattice scale (itself a quotient) as it is."""
    if isinstance(denominator, torch.Tensor):
        return scale * (torch.full_like(denominator, float(gain_num)) / denominator)
    gain = float(np.float32(gain_num / float(denominator)))
    if gain == 1.0:
        return scale
    if lattice:
        return scale * gain
    return absmax * float(np.float32(RECIP_127) * np.float32(gain))


def _hier_pieces(pieces, key_ids, grid, denominator, block_size: int, rounding: str, draws,
                 wire_domain: str, bucket_peaks, ordinal, want_contrib: bool):
    """``quantized_allreduce_2round_hier`` over ``pieces`` on the grid:
    ``(aggregates, each of this process's workers' round-1 round trip or
    [])``. The pieces hold this process's hosts, ``[hosts_loc, per_host,
    ...]`` stacked (every host on the stacked grid).

    Launch shapes: an all_to_all is a permuted copy of the local rows (the
    DCN one crosses the processes first), so one K3 launch covers every
    local region of a hop: two launches a piece on the homomorphic wire,
    one at the ICI hop (``[per_host, N_loc * s1]``, divisor per_host) and
    one at the DCN hop (``[hosts, N_loc * s2]``, divisor hosts)."""
    hh, pp = grid.hosts, grid.per_host
    nl = grid.local_size
    hl, h0 = nl // pp, grid.first // pp  # this process's hosts [h0, h0 + hl)
    bs = block_size
    homomorphic = wire_domain == "homomorphic"
    shapes = [tuple(g.shape[1:]) for g in pieces]
    totals = [int(np.prod(shape, dtype=np.int64)) for shape in shapes]
    s1s = [_slice_len(total, pp, bs) for total in totals]
    xs = [torch.nn.functional.pad(g.float().reshape(nl, total), (0, pp * s1 - total))
          for g, total, s1 in zip(pieces, totals, s1s)]
    outs, contribs = [], []
    if homomorphic:
        # round 1 on ONE lattice: the scales shared over both axes
        round1 = _quantize_pieces(xs, key_ids, grid, bs, rounding, draws, bucket_peaks,
                                  _INT8_PEAK, torch.int8, ordinal)
        for (q1, scale1, absmax), total, shape, s1 in zip(round1, totals, shapes, s1s):
            s2 = _slice_len(s1, hh, bs)
            q1 = q1.reshape(hl, pp, pp, s1)  # [h, j(sender), c(region), s1]
            # ICI hop: worker (h, j) sends region c to (h, c) (the hosts ride
            # along), which sums it over j, rescaled / per_host
            recv = grid.ici.all_to_all(q1.permute(1, 2, 0, 3))  # [c, j, h, s1]
            q_mid = accumulate_rescale_int8(
                recv.permute(1, 2, 0, 3).reshape(pp, nl * s1), float(pp)).reshape(nl, s1)
            q_mid = torch.nn.functional.pad(q_mid, (0, hh * s2 - s1))
            # DCN hop: worker (h', c) sends chunk h to (h, c), which sums it
            # over the hosts h', rescaled / hosts
            recv = grid.dcn.all_to_all(q_mid.reshape(hl, pp, hh, s2).permute(0, 2, 1, 3))
            q2 = accumulate_rescale_int8(
                recv.permute(1, 0, 2, 3).reshape(hh, nl * s2), float(hh)).reshape(hl, pp, s2)
            # int8 gathers: over DCN (the region), then over ICI (the piece)
            chunks = grid.dcn.all_gather(q2.reshape(hl, 1, pp, s2))  # [h, c, s2]
            full = _ici_gather(grid, _ici_region(chunks, s1))
            scale = _hier_gain_scale(scale1, absmax, hh * pp, denominator,
                                     bucket_peaks is not None)
            outs.append(_deq_shared(full, scale, 1.0, bs)[:total].reshape(shape))
            if want_contrib:
                qc = q1.reshape((nl, -1, bs) if bs else (nl, pp * s1))
                c = dequantize_int8(qc.to(torch.int32), scale1, block_size=bs,
                                    shape=(pp * s1,))
                contribs.append(c[:, :total].reshape((nl,) + shape))
        return outs, contribs
    ici, dcn = grid.ici, grid.dcn
    # round 1 over ICI: each host's workers share scales (rows of this
    # process's pieces; draw_rows: the same workers' global ids)
    host_rows = [slice(h * pp, (h + 1) * pp) for h in range(hl)]
    draw_rows = [slice((h0 + h) * pp, (h0 + h + 1) * pp) for h in range(hl)]
    with worker_rows(hl):  # a recorded step: one site a piece, as JAX's one pmax
        round1 = _quantize_pieces([x[r] for x in xs for r in host_rows],
                                  [i for i in key_ids for _ in host_rows], ici, bs, rounding,
                                  draws, bucket_peaks, _INT8_PEAK, torch.int8, ordinal,
                                  rows=draw_rows * len(xs))
    partials2 = []
    for j, (total, shape, s1) in enumerate(zip(totals, shapes, s1s)):
        r1 = round1[j * hl:(j + 1) * hl]
        q1 = torch.stack([q.reshape(pp, pp * s1) for q, _, _ in r1])  # [h, j, c*s1]
        scale1 = torch.stack([sc for _, sc, _ in r1])
        # the ICI all_to_all (worker (h, j) sends region c to (h, c)), then
        # the exact region sums over the senders j
        recv = ici.all_to_all(q1.reshape(hl, pp, pp, s1).permute(1, 2, 0, 3))  # [c, j, h, s1]
        part = recv.to(torch.int32).sum(1, dtype=torch.int32).permute(1, 0, 2)  # [h, c, s1]
        partial = _grid_scale(part, scale1, bs, hl, pp, s1).reshape(nl, s1)
        if want_contrib:
            c = torch.cat([dequantize_int8(q.to(torch.int32), sc, block_size=bs,
                                           shape=(pp * s1,)) for q, sc, _ in r1])
            contribs.append(c[:, :total].reshape((nl,) + shape))
        s2 = _slice_len(s1, hh, bs)
        partials2.append((torch.nn.functional.pad(partial, (0, hh * s2 - s1)), s1, s2))
    # the DCN hop's round 1: the same ICI index on every host shares scales
    # (across the processes: the split route's absmax_max)
    col_rows = [torch.arange(h0 * pp + c, (h0 + hl) * pp, pp) for c in range(pp)]
    dcn_in = [p2.reshape(hl, pp, -1)[:, c].contiguous() for p2, _, _ in partials2
              for c in range(pp)]
    with worker_rows(pp):
        round_d = _quantize_pieces(dcn_in, [i for i in key_ids for _ in range(pp)], dcn, bs,
                                   rounding, draws, None, _INT8_PEAK, torch.int8, round_=2,
                                   rows=col_rows * len(xs))
    regions = []
    for j, (_, s1, s2) in enumerate(partials2):
        rd = round_d[j * pp:(j + 1) * pp]
        qd = torch.stack([q.reshape(hl, hh, s2) for q, _, _ in rd])  # [c, h', h(region), s2]
        # the DCN all_to_all (worker (h', c) sends chunk h to (h, c)), then
        # the exact sums over the senders h'
        recv = dcn.all_to_all(qd.permute(1, 2, 0, 3))  # [h, h', c, s2]
        sums = recv.to(torch.int32).sum(1, dtype=torch.int32).permute(1, 0, 2)  # [c, h, s2]
        scale_d = torch.stack([sc for _, sc, _ in rd])
        if bs:  # this process's regions' rows of each ICI index's scales
            scale_d = scale_d.reshape(pp, hh, -1, 1)[:, h0:h0 + hl]
        regions.append(_grid_scale(sums, scale_d, bs, pp, hl, s2)  # [c, h, s2]
                       .permute(1, 0, 2).reshape(nl, s2))
    # the DCN hop's round 2 (local scales, fold 2 then 1: round 3) and its gather
    fulls = _q2r_local_gather(regions, key_ids, grid, bs, rounding, draws)
    for full, total, shape, s1 in zip(fulls, totals, shapes, s1s):
        # the ICI reassembly gather (f32) of the regions, then / K
        outs.append(_divide(_ici_gather(grid, _ici_region(full, s1))[:total],
                            denominator).reshape(shape))
    return outs, contribs


def _ici_region(chunks: torch.Tensor, s1: int) -> torch.Tensor:
    """Each ICI index's region ``[per_host, s1]`` from the DCN-gathered
    chunks ``[hosts, per_host, s2]`` (chunk h of region c at ``[h, c]``)."""
    hh, pp, s2 = chunks.shape
    return chunks.permute(1, 0, 2).reshape(pp, hh * s2)[:, :s1]


def _ici_gather(grid, region: torch.Tensor) -> torch.Tensor:
    """The ICI all_gather of every worker's region (``region [per_host,
    s1]``: every host holds the same one after the DCN gather) -> the
    flat piece, ``[per_host * s1]``."""
    pp = grid.per_host
    s1 = region.shape[1]
    # worker (h, c)'s region c, for each of this process's hosts h
    every = region[:, None, None].expand(pp, 1, grid.local_size // pp, s1)
    return grid.ici.all_gather(every)[:, 0].reshape(-1)


def _q2r_local_gather(regions, key_ids, grid, block_size: int, rounding: str, draws):
    """Every local worker's region ``[N_loc, s]`` (worker (h, c) holding
    chunk h of ICI region c) requantized with its own scales (round 3 of
    the draws), the int8 chunks and their scale rows all_gathered over
    DCN, and dequantized: ``[hosts, per_host, s]`` a piece."""
    req = _requantize_regions(regions, key_ids, grid, block_size, rounding, draws, round_=3)
    pp = grid.per_host
    nl = grid.local_size

    def gather(x):  # [n_loc, ...] -> the DCN all_gather, [hosts, per_host, ...]
        return grid.dcn.all_gather(x.reshape(nl // pp, 1, pp, *x.shape[1:]))

    if block_size:
        return [(gather(q2.reshape(nl, -1, block_size)).float()
                 * gather(scale2.reshape(nl, -1, 1))).reshape(grid.hosts, pp, r.shape[1])
                for r, (q2, scale2) in zip(regions, req)]
    outs = []
    for j in range(len(regions)):
        mine = req[j * nl:(j + 1) * nl]
        q = gather(torch.stack([q for q, _, _ in mine]))
        outs.append(q.float() * gather(torch.stack([sc for _, sc, _ in mine]))[..., None])
    return outs


def quantized_allreduce_2round_hier(
    tree,
    grid,
    denominator,
    block_size: int = 0,
    rounding: str = "nearest",
    draws: Optional[UniformDraws] = None,
    bucket_bytes: Optional[int] = None,
    flat_output: bool = False,
    wire_domain: str = "dequant",
    return_contribution: bool = False,
    bucket_peaks=None,
):
    """The hierarchical (DCN x ICI) two-round int8 all-reduce
    (collectives.py:513) on a grid of ``hosts x per_host`` workers
    (``mesh.HybridWorkerAxis``, or ``mesh.ProcessHybridAxis`` with whole
    hosts in each process: the DCN hops and the scales shared over DCN
    cross the processes, the ICI hop stays in one). Per piece:

    - dequant wire: round 1 quantizes with scales shared over each host's
      workers (ICI), all_to_all over ICI and exact region sums, each
      worker's region dequantized with its host's scales; a full
      two-round over DCN on that region (its round 1 shares scales over
      the workers of one ICI index, its round 2 requantizes with local
      scales); an f32 gather over ICI; / K;
    - homomorphic wire: round 1 on ONE lattice (scales shared over both
      axes), K3 at the ICI hop (divisor per_host), K3 at the DCN hop
      (divisor hosts), int8 gathers over DCN and ICI, and one deferred
      scale multiply with gain ``(per_host * hosts) / K``.

    Stochastic rounding (dequant wire only) draws round 1 at round 0, the
    DCN hop's round 1 at round 2 and its round 2 at round 3 of the
    piece's key id (JAX: the leaf key, its fold 2, and fold 2 then 1; the
    draw source folds the worker by its DCN index, then its ICI index).
    ``return_contribution`` returns each worker's round-1 round trip: over
    ICI scales on the dequant wire, over the global scales on the
    homomorphic one, as JAX's EF mirror is."""
    if not isinstance(grid, GRIDS):
        raise TypeError(f"the hierarchical wire takes the hybrid grid (mesh.HybridWorkerAxis "
                        f"or mesh.ProcessHybridAxis), got {grid!r}")
    _check_adaptive(bucket_peaks, rounding, wire_domain)
    _check_rounding(rounding, draws)
    align = block_size or 1
    pieces, key_ids, rebuild = piece_stream(tree, bucket_bytes, align=align,
                                            flat_output=flat_output)
    ordinal = None if bucket_peaks is None else _bucket_ordinal(key_ids)
    outs, contribs = _hier_pieces(pieces, key_ids, grid, denominator, block_size, rounding,
                                  draws, wire_domain, bucket_peaks, ordinal, return_contribution)
    agg = rebuild(outs)
    if not return_contribution:
        return agg
    return agg, piece_stream(tree, bucket_bytes, align=align)[2](contribs)


def local_quantized_contribution(
    grads,
    axis: WorkerAxis,
    block_size: int = 0,
    rounding: str = "nearest",
    draws: Optional[UniformDraws] = None,
    bucket_bytes: Optional[int] = None,
    bucket_peaks=None,
    lattice_hi_peak: int = _INT8_PEAK,
):
    """What each worker's gradient becomes after its shared-scale int8
    round trip, worker-stacked and tree-shaped: the transmitted value
    whose difference from the gradient is the error-feedback residual
    (mirrors ``quantized_psum`` and round 1 of the two-round scheme
    exactly: same pieces, same scales, same rounding and draws, the same
    lattice at each bucket's peak)."""
    _check_axis(axis)
    _check_adaptive(bucket_peaks, rounding, "dequant")
    _check_rounding(rounding, draws)
    pieces, key_ids, rebuild = piece_stream(grads, bucket_bytes, align=block_size or 1)
    quantized = _quantize_pieces([g.float() for g in pieces], key_ids, axis, block_size,
                                 rounding, draws, bucket_peaks, lattice_hi_peak,
                                 _lattice_payload_dtype(lattice_hi_peak))
    return rebuild([dequantize_int8(q.to(torch.int32), scale, block_size=block_size,
                                    shape=tuple(g.shape[1:]))
                    for g, (q, scale, _) in zip(pieces, quantized)])


def _bucket_reduce(axis, num_workers: int, starts, denominator, sel=None,
                   compress: Optional[str] = None, block_size: int = 0,
                   rounding: str = "nearest", draws: Optional[UniformDraws] = None,
                   wire_domain: str = "dequant", bucket_peaks=None,
                   lattice_hi_peak: int = _INT8_PEAK, want_contrib: bool = False,
                   hier: bool = False):
    """THE pipelined wire: ``reduce(key_id, piece) -> (aggregate [size],
    contribution [N, size] or None)`` for one bucket of a plan with
    ``starts``, ``piece`` worker-stacked (EF already added, before the
    mask ``sel``). Each call is one bucket's whole wire, its kernel calls
    and collectives, under its profiler scope; the values are the serial
    wire's. ``hier`` runs the two-round wire's hierarchical form (``axis``
    the hybrid grid)."""
    ordinal = None if bucket_peaks is None else _bucket_ordinal(starts)

    def wire(ps, ids):
        if compress in (None, "none"):
            return _psum_pieces(ps, axis, denominator)
        if compress == "int8":
            return _qpsum_pieces(ps, ids, axis, denominator, block_size, rounding, draws,
                                 wire_domain, num_workers, bucket_peaks, lattice_hi_peak,
                                 ordinal, want_contrib)
        if hier:
            return _hier_pieces(ps, ids, axis, denominator, block_size, rounding, draws,
                                wire_domain, bucket_peaks, ordinal, want_contrib)
        return _q2r_pieces(ps, ids, axis, denominator, num_workers, block_size, rounding,
                           draws, wire_domain, bucket_peaks, ordinal, want_contrib)

    def reduce(key_id, piece):
        if sel is not None:
            piece = piece * _per_worker(sel, piece)
        with _bucket_scope(key_id):
            outs, contribs = wire([piece], [key_id])
        return outs[0], (contribs[0] if want_contrib else None)

    return reduce


def _pipelined(tree, bucket_bytes: int, align: int, flat_output: bool,
               return_contribution: bool, make_reduce):
    """The pipelined schedule over a whole tree: the pieces in readiness
    order (``piece_stream(pipelined=True)``), each through the reduce
    ``make_reduce(starts, device)`` builds (``_bucket_reduce``), the
    results rebuilt into the tree (or the flat vector), the
    contributions too with ``return_contribution``."""
    pieces, key_ids, rebuild = piece_stream(tree, bucket_bytes, align=align,
                                            flat_output=flat_output, pipelined=True)
    reduce = make_reduce(sorted(key_ids), pieces[0].device)
    outs, contribs = zip(*(reduce(i, g) for i, g in zip(key_ids, pieces)))
    agg = rebuild(list(outs))
    if not return_contribution:
        return agg
    return agg, piece_stream(tree, bucket_bytes, align=align, pipelined=True)[2](list(contribs))


def bucket_wire(axis, num_workers: int, starts, num_aggregate=None, perm=None,
                mask_mode: str = "random_k", compress: Optional[str] = None,
                quant_block_size: int = 0, quant_rounding: str = "nearest",
                quant_draws: Optional[UniformDraws] = None, wire_domain: str = "dequant",
                bucket_peaks=None, lattice_hi_peak: int = _INT8_PEAK,
                return_contribution: bool = False, device=None):
    """The replicated wire of ``aggregate_gradients`` one bucket at a time:
    the step's mask and count (``_mask_and_count``), then
    ``_bucket_reduce``. The pipelined step calls its reduce as each
    bucket's gradients exist."""
    sel, denom = _mask_and_count(axis, num_workers, num_aggregate, perm, mask_mode,
                                    compress, quant_rounding, wire_domain, bucket_peaks,
                                    device)
    return _bucket_reduce(axis, num_workers, starts, denom, sel, compress, quant_block_size,
                          quant_rounding, quant_draws, wire_domain, bucket_peaks,
                          lattice_hi_peak, return_contribution,
                          hier=compress == "int8_2round" and isinstance(axis, GRIDS))


def _mask_and_count(axis, num_workers, num_aggregate, perm, mask_mode, compress,
                    quant_rounding, wire_domain, bucket_peaks, device=None):
    """The checks every wire shares, then ``(mask or None, the
    denominator)``: the static count a Python float, the adaptive one an
    f32 device tensor (a quotient)."""
    if wire_domain not in ("dequant", "homomorphic"):
        raise ValueError(f"bad wire_domain {wire_domain!r}")
    if bucket_peaks is not None:
        if compress in (None, "none"):
            raise ValueError(
                "adaptive precision (bucket_peaks) needs a compress mode — an "
                "uncompressed f32 wire has no lattice to retune")
        if quant_rounding == "stochastic":
            raise ValueError("adaptive precision (bucket_peaks) needs quant_rounding='nearest'")
    if wire_domain == "homomorphic":
        if compress in (None, "none"):
            raise ValueError(
                "wire_domain='homomorphic' needs a compress mode — an "
                "uncompressed f32 psum has no compressed domain to sum in")
        if quant_rounding == "stochastic":
            raise ValueError("wire_domain='homomorphic' needs quant_rounding='nearest'")
    if compress not in (None, "none", "int8", "int8_2round"):
        raise ValueError(f"unknown compression {compress!r}")
    _check_axis(axis)
    if axis.size != num_workers:
        raise ValueError(f"axis holds {axis.size} workers, not {num_workers}")
    dynamic = isinstance(num_aggregate, torch.Tensor)
    if dynamic:
        k = num_aggregate.to(torch.float32)
    else:
        k = (num_aggregate
             if (num_aggregate is not None and num_aggregate < num_workers)
             else num_workers)
    sel = None
    if dynamic or k != num_workers:
        sel = aggregation_mask(axis, num_workers, num_aggregate, perm, mask_mode,
                               device=device)
    return sel, (k if dynamic else float(k))


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
    quant_draws: Optional[UniformDraws] = None,
    return_contribution: bool = False,
    bucket_bytes: Optional[int] = None,
    flat_output: bool = False,
    pipelined: bool = False,
    wire_domain: str = "dequant",
    bucket_peaks=None,
    lattice_hi_peak: int = _INT8_PEAK,
):
    """The full PS aggregation: mask -> (bucket) -> (quantized) reduce ->
    / K.

    ``grads`` is a tree of worker-stacked ``[N, *shape]`` leaves. The
    aggregate is the tree (or, with ``flat_output``, the padded flat f32
    vector) without the worker dimension. ``bucket_bytes`` picks the wire
    granularity: None = one piece per leaf, 0 = one fused buffer, N =
    ~N-byte buckets. ``return_contribution`` also returns each worker's
    transmitted (post-mask, post-round-trip) value, worker-stacked and
    tree-shaped: what error feedback subtracts. ``perm`` is random_k's
    permutation (``random_permutation``); ``quant_draws`` stochastic
    rounding's draw source (``UniformDraws``).

    ``axis`` may be the hybrid grid (``mesh.GRIDS``, JAX's tuple axis,
    stacked or over processes): ``int8_2round`` then runs the hierarchical wire
    (``quantized_allreduce_2round_hier``), and every other wire reduces
    over the grid as over the flat axis. ``pipelined`` (a bucketed wire)
    runs each bucket's whole wire in turn, in readiness order
    (``_pipelined`` over ``bucket_wire``): one kernel call a bucket, the
    values of the serial wire.

    ``num_aggregate`` may be a device int32 tensor (the adaptive count):
    the mask is then always applied (1.0 everywhere at the full count)
    and the denominator is the count as an f32 device tensor, divided by
    as a quotient (at a power-of-two worker count the full count is bit
    for bit the static step). ``bucket_peaks`` (adaptive precision)
    needs a compress mode and nearest rounding, as in JAX."""
    if pipelined and bucket_bytes is not None:
        align = (quant_block_size or 1) if compress not in (None, "none") else 1
        return _pipelined(grads, bucket_bytes, align, flat_output, return_contribution,
                          lambda starts, dev: bucket_wire(
                              axis, num_workers, starts, num_aggregate, perm, mask_mode,
                              compress, quant_block_size, quant_rounding, quant_draws,
                              wire_domain, bucket_peaks, lattice_hi_peak,
                              return_contribution, device=dev))
    leaves, skeleton = tree_flatten(grads)
    sel, denom = _mask_and_count(axis, num_workers, num_aggregate, perm, mask_mode,
                                    compress, quant_rounding, wire_domain, bucket_peaks,
                                    leaves[0].device)
    if sel is not None:
        grads = tree_unflatten(skeleton, [g * _per_worker(sel, g) for g in leaves])
    wire = dict(bucket_bytes=bucket_bytes, flat_output=flat_output)
    if compress in (None, "none"):
        agg = psum_mean(grads, axis, denom, **wire)
        contribution = grads  # lossless transmit: the residual is zero
    else:
        kw = dict(block_size=quant_block_size, rounding=quant_rounding, draws=quant_draws,
                  wire_domain=wire_domain, return_contribution=return_contribution,
                  bucket_peaks=bucket_peaks, **wire)
        if compress == "int8":
            out = quantized_psum(grads, axis, denom, num_workers=num_workers,
                                 lattice_hi_peak=lattice_hi_peak, **kw)
        elif isinstance(axis, GRIDS):
            out = quantized_allreduce_2round_hier(grads, axis, denom, **kw)
        else:
            out = quantized_allreduce_2round(grads, axis, denom, num_workers, **kw)
        agg, contribution = out if return_contribution else (out, None)
    if not return_contribution:
        return agg
    return agg, contribution
