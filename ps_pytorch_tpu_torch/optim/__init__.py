"""Optimizers with PyTorch update semantics (the port of optim/).

``build_optimizer`` mirrors the JAX factory for SGD; the same update
serves the tree and the flat state (the JAX package's ``flat=True``
variant). Adam/AMSGrad are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from .sgd import SGD, SGDState, apply_updates, sgd

OPTIMIZER_REGISTRY = ("sgd", "adam", "amsgrad")


def build_optimizer(name: str, learning_rate, momentum: float = 0.9,
                    dampening: float = 0.0, weight_decay: float = 0.0,
                    nesterov: bool = False) -> SGD:
    name = name.lower()
    if name == "sgd":
        return sgd(learning_rate, momentum=momentum, dampening=dampening,
                   weight_decay=weight_decay, nesterov=nesterov)
    if name in ("adam", "amsgrad"):
        raise NotImplementedError(
            f"--optimizer {name} is not ported yet (ROADMAP.md queue 1 item 3)")
    raise ValueError(f"unknown optimizer {name!r}; choose from {OPTIMIZER_REGISTRY}")


__all__ = ["SGD", "SGDState", "apply_updates", "build_optimizer", "sgd"]
