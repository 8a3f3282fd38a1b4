"""SGD with PyTorch update semantics (the port of optim/sgd.py).

Applied to the ALREADY aggregated gradient, as the reference PS does
(optim/sgd.py:59-92 of the reference):

    d_p = g + weight_decay * p
    buf = d_p                                  (first step: no dampening)
    buf = momentum * buf + (1-dampening) * d_p (later steps)
    d_p = d_p + momentum * buf   if nesterov else   buf
    p  -= lr * d_p

The state is a small ``SGDState`` (a device int32 ``count`` and the
momentum buffer); ``init`` and ``update`` are plain functions over a
tensor or a tree of tensors. Under ``state_layout="flat"`` every operand
is one padded flat f32 vector, so the whole update is one elementwise
chain (the padding stays zero: a zero gradient makes a zero update). The
JAX package's whole-vector variant ``sgd_flat`` is therefore the same
function here: a flat vector is a one-leaf tree.
The first-step dampening skip is a device-side ``where`` on ``count``, so
the non-finite guard's rollback of ``count`` keeps it right.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ..parallel.buckets import tree_flatten, tree_map


@dataclasses.dataclass
class SGDState:
    count: torch.Tensor
    momentum_buffer: Optional[Any]


@dataclasses.dataclass(frozen=True)
class SGD:
    learning_rate: Union[float, Callable[[torch.Tensor], Any]]
    momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False

    def __post_init__(self):
        if self.nesterov and (self.momentum <= 0 or self.dampening != 0):
            # parity: the reference's sgd.py:51-52
            raise ValueError("Nesterov momentum requires a momentum and zero dampening")

    def init(self, params) -> SGDState:
        leaf = tree_flatten(params)[0][0]
        buf = tree_map(torch.zeros_like, params) if self.momentum != 0 else None
        return SGDState(count=torch.zeros((), dtype=torch.int32, device=leaf.device),
                        momentum_buffer=buf)

    def update(self, grads, state: SGDState, params=None):
        """-> (updates, new_state); apply with ``params + updates``."""
        d = grads
        if self.weight_decay != 0:
            if params is None:
                raise ValueError("weight_decay requires params")
            d = tree_map(lambda g, p: g + self.weight_decay * p, d, params)
        buf = None
        if self.momentum != 0:
            damp = torch.where(state.count == 0, 0.0, self.dampening)
            buf = tree_map(lambda b, g: self.momentum * b + (1.0 - damp) * g,
                           state.momentum_buffer, d)
            d = (tree_map(lambda g, b: g + self.momentum * b, d, buf)
                 if self.nesterov else buf)
        lr = (self.learning_rate(state.count) if callable(self.learning_rate)
              else self.learning_rate)
        updates = tree_map(lambda g: -lr * g, d)
        return updates, SGDState(count=state.count + 1, momentum_buffer=buf)


def sgd(learning_rate, momentum: float = 0.0, dampening: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> SGD:
    return SGD(learning_rate, momentum, dampening, weight_decay, nesterov)


def apply_updates(params, updates):
    return tree_map(torch.add, params, updates)
