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

The static half of the JAX module, the schedule freedom of a traced
step (``jaxpr_overlap_headroom``, overlap.py:134-232), runs here over a
RECORDED step instead (``check/walker.py``): ``tape_overlap_headroom``
records one call and ``overlap_headroom_from`` computes the same cones
over the tape's dataflow graph (every node weighs 1: a tape has no
nested bodies).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

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


def tape_overlap_headroom(fn: Callable, *args, devices: int = 1, **kwargs) -> dict:
    """Schedule-freedom report for one recorded call ``fn(*args,
    **kwargs)`` (the port of JAX's ``jaxpr_overlap_headroom``: the step
    runs once under ``check.walker.recording``); see
    ``overlap_headroom_from``."""
    from ..check.walker import record_step

    tape, _ = record_step(fn, *args, devices=devices, **kwargs)
    return overlap_headroom_from(tape)


def overlap_headroom_from(tape) -> dict:
    """The cone computation of JAX's ``overlap_headroom_from`` over a
    recorded step's tape. For every reduce-kind collective node (the
    gradient psum / psum_scatter / all_to_all family, the metrics pmean
    included, as in JAX): ``independent_frac`` = the share of the tape's
    nodes that are neither its dataflow ancestors nor its descendants
    (what MAY run while it is in flight), ``prefix_frac`` = the share of
    its ancestors (what MUST retire before it starts). Returns
    ``{n_collectives, total_weight, per_collective, overlap_headroom (the
    mean independent_frac), first_dispatch_prefix, mean_dispatch_prefix}``:
    a serial step's buckets all wait for one global concat, so every
    prefix is large; the pipelined wire's first bucket needs only its own
    leaves' chain."""
    from ..check.walker import REDUCE_KINDS

    nodes = tape.nodes
    total = len(nodes)
    coll = [n.index for n in nodes if any(p.kind in REDUCE_KINDS for p in n.payloads)]
    if not coll:
        return {"n_collectives": 0, "total_weight": 0, "per_collective": [],
                "overlap_headroom": None, "first_dispatch_prefix": None,
                "mean_dispatch_prefix": None}
    children: List[List[int]] = [[] for _ in nodes]
    for n in nodes:
        for p in n.parents:
            children[p].append(n.index)

    def cone(start: int, adj) -> set:
        seen = {start}
        stack = [start]
        while stack:
            for y in adj(stack.pop()):
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return seen

    per: List[Dict] = []
    for i in coll:
        anc = cone(i, lambda x: nodes[x].parents)
        desc = cone(i, lambda x: children[x])
        independent = total - len(anc | desc)
        per.append({
            "node": i,
            "name": nodes[i].name,
            "independent_weight": independent,
            "independent_frac": round(independent / total, 4),
            "prefix_frac": round((len(anc) - 1) / total, 4),
        })
    prefixes = sorted(p["prefix_frac"] for p in per)
    return {
        "n_collectives": len(per),
        "total_weight": total,
        "per_collective": per,
        "overlap_headroom": round(sum(p["independent_frac"] for p in per) / len(per), 4),
        "first_dispatch_prefix": prefixes[0],
        "mean_dispatch_prefix": round(sum(prefixes) / len(prefixes), 4),
    }
