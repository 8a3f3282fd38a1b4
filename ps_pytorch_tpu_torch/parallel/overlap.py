"""When each gradient leaf is produced in a backward (the readiness half of
parallel/overlap.py).

The JAX package reads the order from a traced jaxpr: the equation that
produces each output of ``jax.grad`` (``grad_leaf_readiness``,
overlap.py:90). Eager PyTorch has no jaxpr; the port measures the order
on a real backward instead, with a hook on every leaf (the hook that
fires under ``torch.autograd.grad``, which the PS step uses:
``register_post_accumulate_grad_hook`` does not). The pipelined step's
bucket stream (``ps._BucketStream``) is driven by the same hooks, and
``buckets.readiness_bucket_order`` turns the ranks into the order its
buckets become complete.

The static half of the JAX module (``jaxpr_overlap_headroom``, a
dataflow walk of the traced step) belongs to the static analysis
(ROADMAP.md queue 1 item 23).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .buckets import tree_flatten, tree_unflatten


def grad_leaf_readiness(loss_fn: Callable, params) -> Tuple[int, ...]:
    """Production rank of each leaf's gradient (``tree_flatten`` order) in
    the backward of ``loss_fn(params)``: 0 for the first produced. One
    forward and backward run; ``params`` is not changed."""
    leaves, skel = tree_flatten(params)
    inputs = [leaf.detach().requires_grad_(True) for leaf in leaves]
    fired = []
    for i, leaf in enumerate(inputs):
        leaf.register_hook(lambda g, i=i: fired.append(i))
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(skel, inputs))
        torch.autograd.grad(loss, inputs)
    ranks = [0] * len(inputs)
    for r, i in enumerate(fired):
        ranks[i] = r
    return tuple(ranks)
