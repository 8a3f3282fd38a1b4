"""Adam (with optional AMSGrad) with PyTorch update semantics (the port of
optim/adam.py).

Applied to the ALREADY aggregated gradient, as the reference PS does
(optim/adam.py:38-95 of the reference):

    g       = g + weight_decay * p
    m       = beta1 * m + (1-beta1) * g
    v       = beta2 * v + (1-beta2) * g^2
    v_hat   = max(v_hat, v)              (amsgrad only; denom uses v_hat)
    denom   = sqrt(v or v_hat) + eps     (eps added AFTER the sqrt)
    step_sz = lr * sqrt(1-beta2^t) / (1-beta1^t)
    p      -= step_sz * m / denom

Plain tensor ops that copy the JAX package's expression op for op, not
``torch.optim.Adam``: that one divides ``sqrt(v)`` by ``sqrt(bias2)``
before adding eps, and ``lr`` by ``bias1`` alone. Here the learning rate
is read at the count BEFORE the step (a schedule sees 0 on the first
step), ``beta^t`` is an f32 ``pow`` of the f32 count, and the update is a
tensor-by-tensor IEEE quotient. XLA-CPU may contract ``b1*m + c*g`` and
``g + wd*p`` into FMAs where PyTorch rounds twice, and its f32 ``pow``
is not libm's: the parity tests state their ulp bound for that.

As with ``SGD``, a flat state is a one-leaf tree, so the JAX package's
whole-vector ``adam_flat`` is this same function on a flat vector (the
padding stays zero: a zero gradient keeps m = v = 0 and its update is
``-step * 0 / (0 + eps) = 0``). The JAX package computes Adam in plain
``jnp`` outside any Pallas kernel, so these ops are the port's version on
the card too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ..parallel.buckets import tree_flatten, tree_map


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor
    exp_avg: Any
    exp_avg_sq: Any
    max_exp_avg_sq: Optional[Any]


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: Union[float, Callable[[torch.Tensor], Any]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    amsgrad: bool = False

    def init(self, params) -> AdamState:
        leaf = tree_flatten(params)[0][0]
        zeros = lambda: tree_map(torch.zeros_like, params)
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=leaf.device),
                         exp_avg=zeros(), exp_avg_sq=zeros(),
                         max_exp_avg_sq=zeros() if self.amsgrad else None)

    def update(self, grads, state: AdamState, params=None):
        """-> (updates, new_state); apply with ``params + updates``."""
        b1, b2, eps = self.b1, self.b2, self.eps
        g = grads
        if self.weight_decay != 0:
            if params is None:
                raise ValueError("weight_decay requires params")
            g = tree_map(lambda g_, p: g_ + self.weight_decay * p, g, params)
        count = state.count + 1
        m = tree_map(lambda m_, g_: b1 * m_ + (1 - b1) * g_, state.exp_avg, g)
        v = tree_map(lambda v_, g_: b2 * v_ + (1 - b2) * g_ * g_, state.exp_avg_sq, g)
        vmax = tree_map(torch.maximum, state.max_exp_avg_sq, v) if self.amsgrad else None
        c = count.float()
        one = torch.ones((), dtype=torch.float32, device=c.device)
        bias1 = 1 - torch.full_like(one, b1).pow(c)
        bias2 = 1 - torch.full_like(one, b2).pow(c)
        lr = (self.learning_rate(state.count) if callable(self.learning_rate)
              else self.learning_rate)
        step_size = lr * torch.sqrt(bias2) / bias1
        updates = tree_map(lambda m_, d: -step_size * m_ / (torch.sqrt(d) + eps),
                           m, vmax if self.amsgrad else v)
        return updates, AdamState(count=count, exp_avg=m, exp_avg_sq=v, max_exp_avg_sq=vmax)


def adam(learning_rate=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, amsgrad: bool = False) -> Adam:
    return Adam(learning_rate, b1, b2, eps, weight_decay, amsgrad)
