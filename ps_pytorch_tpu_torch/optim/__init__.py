"""Optimizers with PyTorch update semantics (the port of optim/).

``build_optimizer`` mirrors the JAX factory: SGD and Adam / AMSGrad. The
same update serves the tree and the flat state (the JAX package's
``flat=True`` variants ``sgd_flat`` / ``adam_flat``: a flat vector is a
one-leaf tree). The LM trainer's learning-rate schedules are in
``schedules.py``.
"""

from __future__ import annotations

from typing import Union

from .adam import Adam, AdamState, adam
from .sgd import SGD, SGDState, apply_updates, sgd

OPTIMIZER_REGISTRY = ("sgd", "adam", "amsgrad")


def build_optimizer(name: str, learning_rate, momentum: float = 0.9,
                    dampening: float = 0.0, weight_decay: float = 0.0,
                    nesterov: bool = False, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, flat: bool = False) -> Union[SGD, Adam]:
    """``flat`` is accepted for the JAX signature: the port's updates
    take the flat vector and the tree alike."""
    del flat
    name = name.lower()
    if name == "sgd":
        return sgd(learning_rate, momentum=momentum, dampening=dampening,
                   weight_decay=weight_decay, nesterov=nesterov)
    if name in ("adam", "amsgrad"):
        return adam(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                    amsgrad=name == "amsgrad")
    raise ValueError(f"unknown optimizer {name!r}; choose from {OPTIMIZER_REGISTRY}")


__all__ = ["Adam", "AdamState", "SGD", "SGDState", "adam", "apply_updates",
           "build_optimizer", "sgd"]
