"""Honest device synchronization for timing code.

PyTorch returns from a CUDA call before the card has run it, so a host
clock read after it measures the enqueue. ``host_sync`` waits for the
card (``torch.cuda.synchronize``) and then reads one element of every
tensor passed back to the host, so it returns only once each of them
exists — the same contract as the JAX package's ``utils/sync.host_sync``.
"""

from __future__ import annotations

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor) and tree.numel():
        yield tree


def host_sync(*trees) -> float:
    """Block until every tensor of every tree is computed. Returns the
    (meaningless) sum of one element of each, read on the host."""
    leaves = [x for t in trees for x in _leaves(t)]
    if not leaves:
        return 0.0
    if any(x.is_cuda for x in leaves):
        torch.cuda.synchronize()
    return float(sum(float(x.reshape(-1)[0]) for x in leaves))
