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

Compute dtype (flax's ``dtype=``): each layer runs in its input's dtype
and casts its f32 params to it, so a model that casts its input to bf16
computes in bf16 over f32 params, and the gradients land back in f32.
BatchNorm follows flax's casts: statistics reduced in f32, the normalize
in f32, the output in the input's dtype, the running stats in f32.

Worker-stacked params (synced BatchNorm): a leaf with a leading worker
dim (a ``[N, kh, kw, in, out]`` kernel, ``[N, C]`` BN scale) is each of
N workers' own copy, and the batch's rows are the N workers' batches in
order. Each worker's rows go through its own copy; BatchNorm reduces its
statistics over every worker's rows, as flax's ``axis_name`` pmean does
across devices, so one backward of the summed losses gives each copy
its gradient, the cross-worker terms included.
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


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def conv(x: torch.Tensor, p: Dict, stride: int = 1, padding=0) -> torch.Tensor:
    """NCHW ``x`` through an HWIO kernel (and bias, if the leaf has one),
    in ``x``'s dtype; a worker-stacked kernel convolves each worker's
    rows with its own copy."""
    w, b = p["kernel"].to(x.dtype), _cast(p.get("bias"), x.dtype)
    if w.dim() == 4:
        return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride, padding=padding)
    return torch.cat([
        F.conv2d(xw, w[i].permute(3, 2, 0, 1), None if b is None else b[i], stride=stride,
                 padding=padding)
        for i, xw in enumerate(x.chunk(w.shape[0]))])


def dense(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """``x @ kernel + bias`` in ``x``'s dtype; a worker-stacked kernel
    multiplies each worker's rows by its own copy."""
    k, b = p["kernel"].to(x.dtype), _cast(p.get("bias"), x.dtype)
    if k.dim() == 2:
        out = x @ k
        return out + b if b is not None else out
    out = torch.bmm(x.reshape(k.shape[0], -1, x.shape[-1]), k)
    if b is not None:
        out = out + b[:, None, :]
    return out.reshape(-1, k.shape[-1])


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(keep, x / (1 - rate), 0)``, the
    division as the reciprocal multiply XLA makes of it under jit
    (``x * 2`` at rate 0.5). ``keep`` is the caller's boolean draw."""
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


def init_batch_norm(c: int) -> Tuple[Dict, Dict]:
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def _running(stats: Dict, x: torch.Tensor) -> Dict:
    """flax's running update from the biased batch statistics of ``x``,
    reduced in f32."""
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        return {"mean": BN_MOMENTUM * stats["mean"] + (1.0 - BN_MOMENTUM) * mean,
                "var": BN_MOMENTUM * stats["var"] + (1.0 - BN_MOMENTUM) * var}


def batch_norm(x: torch.Tensor, p: Dict, stats: Dict, train: bool,
               new_stats: Dict, name: str) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over NCHW ``x``. In train mode it normalizes
    with the batch statistics and writes ``name``'s updated running
    stats into ``new_stats``; in eval mode it reads the running ones.
    A bf16 ``x`` is normalized in f32 against f32 params and stats
    (``F.batch_norm``'s mixed-dtype path) and comes out in bf16."""
    scale, bias = p["scale"], p["bias"]
    if scale.dim() == 2:
        return _synced_batch_norm(x, scale, bias, stats, train, new_stats, name)
    if not train:
        return F.batch_norm(x, stats["mean"], stats["var"], scale, bias, training=False,
                            eps=BN_EPS)
    new_stats[name] = _running(stats, x)
    return F.batch_norm(x, None, None, scale, bias, training=True, eps=BN_EPS)


def _synced_batch_norm(x, scale, bias, stats, train, new_stats, name):
    """BatchNorm over the rows of every worker (statistics shared), then
    each worker's own affine, in f32; the output in ``x``'s dtype."""
    n = scale.shape[0]
    if train:
        new_stats[name] = _running(stats, x)
        xhat = F.batch_norm(x.float(), None, None, training=True, eps=BN_EPS)
    else:
        xhat = F.batch_norm(x.float(), stats["mean"], stats["var"], training=False,
                            eps=BN_EPS)
    y = xhat.reshape(n, -1, *x.shape[1:]) * scale[:, None, :, None, None] \
        + bias[:, None, :, None, None]
    return y.reshape(x.shape).to(x.dtype)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC batch (channels-last in memory: no copy)."""
    return x.permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """flax's ``x.reshape((B, -1))`` of an NHWC activation, from NCHW
    ``x``: the dense layer after it reads features in H, W, C order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
