"""Weight carrier between the JAX package and the port.

The port keeps the JAX params tree's names and ``[in, out]`` layouts, so
a transfer is a copy of each leaf: numpy arrays in, torch tensors out,
and back. Tests hand weights across this way (the two frameworks meet
only as numpy arrays).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import DeviceLike, resolve_device


def params_from_jax(tree: Any, device: DeviceLike = None):
    """A JAX params tree given as numpy arrays (nested dicts/lists) ->
    the same tree of torch tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)


def params_to_numpy(tree: Any):
    """Inverse of ``params_from_jax``: torch tensors -> numpy arrays
    (bf16 leaves widen to f32, which numpy can hold)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def cnn_from_jax(params: Any, batch_stats: Any, device: DeviceLike = None):
    """A flax CNN's ``params`` and ``batch_stats`` (numpy trees) -> the
    port's ``(params, batch_stats)``. The port keeps flax's names and its
    HWIO / ``[in, out]`` layouts, so this is a copy of each leaf: the
    flattened leaves, and therefore the flat state and the block-128
    quantization rows, are element for element the JAX ones."""
    return params_from_jax(params, device), params_from_jax(batch_stats or {}, device)
