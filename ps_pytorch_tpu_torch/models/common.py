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
order. Each worker's rows go through its own copy; BatchNorm takes each
worker's mean and mean of squares and combines them over the workers,
as flax's ``axis_name`` BatchNorm pmeans them across devices
(``E[x^2] - E[x]^2``, clipped at 0), so one backward of the summed
losses gives each copy its gradient, the cross-worker terms included.
The workers may span processes: inside ``synced_stats_axis(axis)`` the
statistics combine over ``axis`` (a ``ProcessWorkerAxis`` holds this
process's workers), whose backward brings the other processes' losses
in. Every per-worker op runs on one worker's rows, so a process computes
its workers' values as the stacked run does.
"""

from __future__ import annotations

import contextlib
import contextvars
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
    return torch.cat([xw @ k[i] + b[i] if b is not None else xw @ k[i]
                      for i, xw in enumerate(x.chunk(k.shape[0]))])


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(keep, x / (1 - rate), 0)``, the
    division as the reciprocal multiply XLA makes of it under jit
    (``x * 2`` at rate 0.5). ``keep`` is the caller's boolean draw."""
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


def init_batch_norm(c: int) -> Tuple[Dict, Dict]:
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def _running_update(stats: Dict, mean: torch.Tensor, var: torch.Tensor) -> Dict:
    """flax's running update from a batch's mean and biased variance."""
    with torch.no_grad():
        return {"mean": BN_MOMENTUM * stats["mean"] + (1.0 - BN_MOMENTUM) * mean,
                "var": BN_MOMENTUM * stats["var"] + (1.0 - BN_MOMENTUM) * var}


def _running(stats: Dict, x: torch.Tensor) -> Dict:
    """flax's running update from the biased batch statistics of ``x``,
    reduced in f32."""
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
    return _running_update(stats, mean, var)


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


# the worker axis synced BatchNorm combines its statistics over (None: the
# stacked workers of the call, every one in this process)
_STATS_AXIS = contextvars.ContextVar("synced_stats_axis", default=None)


@contextlib.contextmanager
def synced_stats_axis(axis):
    """Within, synced BatchNorm combines the per-worker statistics over
    ``axis`` (``parallel.mesh``'s ``WorkerAxis`` or a process-spanning
    one, whose ``local_size`` workers are the call's): the PS step sets
    it around its forward."""
    token = _STATS_AXIS.set(axis)
    try:
        yield
    finally:
        _STATS_AXIS.reset(token)


class _WorkerMean(torch.autograd.Function):
    """The mean over every worker of per-worker statistics ``s [n_loc,
    k]`` (``axis.pmean``: the rows gathered in worker order and reduced
    as the stacked backend reduces them), returned once a local worker,
    ``[n_loc, k]``. The backward sums every worker's gradient of its
    copy (``axis.psum``, the same order) and hands each row the sum over
    the workers count: the transpose of the pmean, which carries the
    other processes' losses into this process's statistics."""

    @staticmethod
    def forward(ctx, s, axis):
        ctx.axis, ctx.n = axis, s.shape[0] if axis is None else axis.size
        mean = s.mean(0) if axis is None else axis.pmean(s)
        return mean.expand(s.shape).clone()

    @staticmethod
    def backward(ctx, g):
        total = g.sum(0) if ctx.axis is None else ctx.axis.psum(g.contiguous())
        return (total / ctx.n).expand(g.shape).clone(), None


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A per-worker ``[n, C]`` value broadcast over its worker's rows of
    ``[n, B, C, H, W]``."""
    return t[:, None, :, None, None]


class _WorkerStats(torch.autograd.Function):
    """Each worker's mean and mean of squares over its rows of ``x [n B,
    C, H, W]`` (f32), ``[n, 2C]``. The forward reduces one worker's rows
    a call; the backward is elementwise over every row."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.save_for_backward(x)
        ctx.n = n
        return torch.stack([torch.cat([p.mean(dim=(0, 2, 3)), p.square().mean(dim=(0, 2, 3))])
                            for p in x.chunk(n)])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        n, c = ctx.n, x.shape[1]
        xs = x.reshape(n, -1, *x.shape[1:])
        count = xs[0].numel() // c
        dx = (_rows(g[:, :c]) + 2.0 * xs * _rows(g[:, c:])) / count
        return dx.reshape(x.shape), None


class _WorkerAffine(torch.autograd.Function):
    """``(x - mean) * mul + bias`` with each worker's own ``[n, C]``
    values on its rows of ``x [n B, C, H, W]``: elementwise over every
    row, and each per-worker gradient reduced over one worker's rows a
    call."""

    @staticmethod
    def forward(ctx, x, mean, mul, bias):
        ctx.save_for_backward(x, mean, mul)
        xs = x.reshape(mean.shape[0], -1, *x.shape[1:])
        return ((xs - _rows(mean)) * _rows(mul) + _rows(bias)).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, mean, mul = ctx.saved_tensors
        n = mean.shape[0]
        dx = g.reshape(n, -1, *g.shape[1:]) * _rows(mul)
        gs, xs = g.chunk(n), x.chunk(n)
        dbias = torch.stack([gw.sum(dim=(0, 2, 3)) for gw in gs])
        dmul = torch.stack([(gw * (xw - mean[i][:, None, None])).sum(dim=(0, 2, 3))
                            for i, (gw, xw) in enumerate(zip(gs, xs))])
        return dx.reshape(x.shape), -(dbias * mul), dmul, dbias


def _synced_batch_norm(x, scale, bias, stats, train, new_stats, name):
    """flax's synced BatchNorm on worker-stacked params: each worker's
    mean and mean of squares (f32), their mean over every worker
    (``_WorkerMean`` over ``synced_stats_axis``'s axis), the variance
    ``E[x^2] - E[x]^2`` clipped at 0, then each worker's own normalize
    and affine (flax's ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``), in f32; the output in ``x``'s dtype. Every reduction runs
    over one worker's rows, so its bits do not depend on how many
    workers the call holds."""
    n, c = scale.shape
    axis = _STATS_AXIS.get()
    if axis is not None and axis.local_size != n:
        raise ValueError(f"synced BatchNorm: {n} stacked copies, the axis holds "
                         f"{axis.local_size} workers here")
    xf = x.float()
    if train:
        m = _WorkerMean.apply(_WorkerStats.apply(xf, n), axis)
        mean, var = m[:, :c], torch.clamp_min(m[:, c:] - m[:, :c].square(), 0.0)
        new_stats[name] = _running_update(stats, mean[0].detach(), var[0].detach())
    else:
        mean = stats["mean"].expand(n, c)
        var = stats["var"].expand(n, c)
    mul = torch.rsqrt(var + BN_EPS) * scale
    return _WorkerAffine.apply(xf, mean, mul, bias).to(x.dtype)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC batch (channels-last in memory: no copy)."""
    return x.permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """flax's ``x.reshape((B, -1))`` of an NHWC activation, from NCHW
    ``x``: the dense layer after it reads features in H, W, C order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
