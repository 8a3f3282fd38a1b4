"""Gradient aggregation on the stacked worker backend (the port of
parallel/collectives.py, main-path subset).

Every per-worker gradient leaf is worker-stacked ``[N, *shape]``; an
aggregate comes back once, without the worker dimension (the replicated
result of the JAX collective). Reference semantics:

- ``psum_mean``: sum over workers / num_aggregate
  (sync_replicas_master_nn.py:204-208);
- ``aggregation_mask``: partial ("backup-worker") aggregation, only K of
  N gradients enter the sum (:179-186); ``random_k`` models "first K to
  arrive", ``first_k`` is the deterministic variant;
- ``quantized_psum``: per leaf, shared absmax (pmax) -> int8 quantize
  (kernel K2 per tensor, K1's shared-scale entry per block) -> int32
  psum -> dequantize / K;
- ``local_quantized_contribution``: what each worker's gradient becomes
  after its int8 round trip (error feedback);
- ``aggregate_gradients``: mask -> (quantized) reduce -> / K.

Division by the aggregation count: the JAX step divides by a Python
float inside jit, which XLA turns into a multiply by the f32 reciprocal
(``x / 5.0`` is ``x * f32(1/5)``); the port multiplies by that constant
so the wire is bit-exact against the reference.

``jax.random.permutation`` cannot be reproduced in torch: the random_k
mask takes its permutation from a ``torch.Generator``, or the caller
injects one (the parity tests inject JAX's).

The two-round, hierarchical and homomorphic wires, stochastic rounding,
adaptive ``agg_count`` and ``bucket_peaks`` raise ``NotImplementedError``
(ROADMAP.md, Slice B).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.quantize import dequantize_int8, quantize_int8
from .buckets import piece_stream, tree_flatten, tree_unflatten
from .mesh import WorkerAxis

_SLICE_B = "is not ported yet (ROADMAP.md queue 1, Slice B)"


def reciprocal(denominator: float) -> float:
    """The f32 constant XLA multiplies by where the JAX code divides by
    the Python float ``denominator`` inside jit."""
    return float(np.float32(1.0) / np.float32(denominator))


def _check_axis(axis) -> None:
    if not isinstance(axis, WorkerAxis):
        raise NotImplementedError(
            f"axis {axis!r}: only the stacked WorkerAxis backend is ported; "
            f"tuple axes (hierarchical DCN x ICI) and torch.distributed "
            f"{_SLICE_B}"
        )


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
    """Per-worker {0,1} f32 ``[N]``: does worker w's gradient enter the
    sum? With num_aggregate None or >= num_workers every worker does.
    ``random_k`` selects ``perm[:num_aggregate]`` (``perm`` a permutation
    of ``range(N)``: the caller draws it, see ``random_permutation``),
    ``first_k`` selects ``w < num_aggregate``."""
    _check_axis(axis)
    if isinstance(num_aggregate, torch.Tensor):
        raise NotImplementedError(f"a traced (adaptive) num_aggregate {_SLICE_B}")
    if num_aggregate is None or num_aggregate >= num_workers:
        return torch.ones((num_workers,), dtype=torch.float32, device=device)
    if mode == "first_k":
        return (axis.axis_index(device) < num_aggregate).float()
    if mode == "random_k":
        if perm is None:
            raise ValueError("random_k masking needs a permutation of the workers")
        perm = torch.as_tensor(perm, dtype=torch.long).to(device)
        selected = torch.zeros((num_workers,), dtype=torch.float32, device=device)
        return selected.index_fill(0, perm[:num_aggregate], 1.0)
    raise ValueError(f"unknown aggregation mode {mode!r}")


def psum_mean(tree, axis: WorkerAxis, denominator: float,
              bucket_bytes: Optional[int] = None, flat_output: bool = False):
    """Sum over workers / denominator, per leaf (parity: _model_update
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
    return_contribution: bool = False,
):
    """int8-quantized gradient all-reduce, per leaf: shared absmax (the
    pmax) -> int8 quantize -> int32 psum -> dequantize / denominator.
    Exact-sum in int32; deterministic (one scale for all workers).

    ``return_contribution`` also returns each worker's dequantized
    payload (worker-stacked, tree-shaped): the value
    ``local_quantized_contribution`` computes, from the same
    quantization instead of a second one."""
    _check_axis(axis)
    if rounding != "nearest" or key is not None:
        raise NotImplementedError(f"stochastic rounding {_SLICE_B}")
    if wire_domain != "dequant":
        raise NotImplementedError(f"wire_domain={wire_domain!r} {_SLICE_B}")
    recip = reciprocal(denominator)
    pieces, _, rebuild = piece_stream(tree, bucket_bytes, align=block_size or 1,
                                      flat_output=flat_output)
    outs, contribs = [], []
    for g in pieces:
        shape = tuple(g.shape[1:])
        q, scale = quantize_int8(g.float(), axis_name=axis, block_size=block_size)
        s = axis.psum(q.to(torch.int32))
        outs.append(dequantize_int8(s, scale, block_size=block_size, shape=shape) * recip)
        if return_contribution:
            contribs.append(dequantize_int8(
                q.to(torch.int32), scale, block_size=block_size, shape=shape))
    agg = rebuild(outs)
    if not return_contribution:
        return agg
    _, _, rebuild_tree = piece_stream(tree, bucket_bytes)
    return agg, rebuild_tree(contribs)


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
    (mirrors ``quantized_psum`` exactly: same scales, same rounding)."""
    _check_axis(axis)
    if rounding != "nearest" or key is not None:
        raise NotImplementedError(f"stochastic rounding {_SLICE_B}")
    pieces, _, rebuild = piece_stream(grads, bucket_bytes)
    outs = []
    for g in pieces:
        q, scale = quantize_int8(g.float(), axis_name=axis, block_size=block_size)
        outs.append(dequantize_int8(q.to(torch.int32), scale,
                                    block_size=block_size, shape=tuple(g.shape[1:])))
    return rebuild(outs)


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
    wire_domain: str = "dequant",
    bucket_peaks=None,
):
    """The full PS aggregation: mask -> (quantized) reduce -> / K.

    ``grads`` is a tree of worker-stacked ``[N, *shape]`` leaves. The
    aggregate is the tree (or, with ``flat_output``, the padded flat f32
    vector) without the worker dimension. ``return_contribution`` also
    returns each worker's transmitted (post-mask, post-round-trip) value,
    worker-stacked and tree-shaped: what error feedback subtracts.
    ``perm`` is random_k's permutation (``random_permutation``)."""
    _check_axis(axis)
    if axis.size != num_workers:
        raise ValueError(f"axis holds {axis.size} workers, not {num_workers}")
    if compress == "int8_2round":
        raise NotImplementedError(f"the two-round int8 wire {_SLICE_B}")
    if bucket_peaks is not None:
        raise NotImplementedError(f"adaptive per-bucket precision {_SLICE_B}")
    k = (num_aggregate
         if (num_aggregate is not None and num_aggregate < num_workers)
         else num_workers)
    if k != num_workers:
        leaves, skeleton = tree_flatten(grads)
        sel = aggregation_mask(axis, num_workers, num_aggregate, perm, mask_mode,
                               device=leaves[0].device)
        grads = tree_unflatten(skeleton, [g * _per_worker(sel, g) for g in leaves])
    if compress in (None, "none"):
        agg = psum_mean(grads, axis, float(k), bucket_bytes=bucket_bytes,
                        flat_output=flat_output)
        contribution = grads  # lossless transmit: the residual is zero
    elif compress == "int8":
        out = quantized_psum(
            grads, axis, float(k), block_size=quant_block_size,
            rounding=quant_rounding, key=quant_key, bucket_bytes=bucket_bytes,
            flat_output=flat_output, wire_domain=wire_domain,
            return_contribution=return_contribution,
        )
        agg, contribution = out if return_contribution else (out, None)
    else:
        raise ValueError(f"unknown compression {compress!r}")
    if not return_contribution:
        return agg
    return agg, contribution
