"""Shared building blocks of the CNN zoo (the port of models/common.py).

Layouts follow the flax tree, so a JAX checkpoint's leaves carry over as
they are: conv kernels HWIO ``[kh, kw, in, out]``, dense ``[in, out]``,
BatchNorm ``scale``/``bias`` params and ``mean``/``var`` batch stats.
Activations enter NHWC, as the JAX models take them; each model computes
in NCHW through permuted views (``w.permute(3, 2, 0, 1)`` is the OIHW
kernel ``F.conv2d`` wants) and the gradient lands back in the HWIO leaf.

BatchNorm keeps flax's semantics (common.py:25-32): momentum 0.9, eps
1e-5, the biased batch variance both to normalize and in the running
update ``var = 0.9 * var + 0.1 * batch_var`` (PyTorch's own BatchNorm
keeps the unbiased one). Initializers keep flax's distributions
(variance scaling, truncated normal); the values come from a
``torch.Generator`` and differ from ``jax.random``'s.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# flax's truncated-normal variance scaling divides by the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(shape, scale: float, mode: str, generator: torch.Generator):
    """flax ``variance_scaling(scale, mode, "truncated_normal")`` for an
    HWIO or ``[in, out]`` kernel."""
    fan_in, fan_out = _fans(tuple(shape))
    fan = fan_in if mode == "fan_in" else fan_out
    std = math.sqrt(scale / fan) / _TRUNC_STD
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def he_normal(shape, generator):
    """common.py:16: variance_scaling(2.0, "fan_out", "truncated_normal")."""
    return variance_scaling(shape, 2.0, "fan_out", generator)


def lecun_normal(shape, generator):
    """flax's default kernel init."""
    return variance_scaling(shape, 1.0, "fan_in", generator)


def conv(x: torch.Tensor, p: Dict, stride: int = 1, padding=0) -> torch.Tensor:
    """NCHW ``x`` through an HWIO kernel (and bias, if the leaf has one)."""
    w = p["kernel"].permute(3, 2, 0, 1)
    return F.conv2d(x, w, p.get("bias"), stride=stride, padding=padding)


def dense(x: torch.Tensor, p: Dict) -> torch.Tensor:
    out = x @ p["kernel"]
    return out + p["bias"] if "bias" in p else out


def init_batch_norm(c: int) -> Tuple[Dict, Dict]:
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def batch_norm(x: torch.Tensor, p: Dict, stats: Dict, train: bool,
               new_stats: Dict, name: str) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over NCHW ``x``. In train mode it normalizes
    with the batch statistics and writes ``name``'s updated running
    stats into ``new_stats``; in eval mode it reads the running ones."""
    if not train:
        return F.batch_norm(x, stats["mean"], stats["var"], p["scale"], p["bias"],
                            training=False, eps=BN_EPS)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        new_stats[name] = {
            "mean": BN_MOMENTUM * stats["mean"] + (1.0 - BN_MOMENTUM) * mean,
            "var": BN_MOMENTUM * stats["var"] + (1.0 - BN_MOMENTUM) * var,
        }
    return F.batch_norm(x, None, None, p["scale"], p["bias"], training=True,
                        eps=BN_EPS)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC batch (channels-last in memory: no copy)."""
    return x.permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """flax's ``x.reshape((B, -1))`` of an NHWC activation, from NCHW
    ``x``: the dense layer after it reads features in H, W, C order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
