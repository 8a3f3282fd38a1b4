"""int8 symmetric block quantization (the port of ops/quantize.py).

Block mode only, which is what the serving slice runs: the int8 KV
cache quantizes every (position, head) vector with its own absmax scale
(serve/kv.py, block = head_dim).

- ``quantize_rows`` is the wrapper of kernel K1 (``csrc/quantize_rows.cu``):
  CUDA tensors launch the kernel, CPU tensors take the plain version
  ``quantize_rows_plain`` beside it. No fallback between the two.
- ``quantize_int8(x, block_size=...)`` / ``dequantize_int8`` keep the JAX
  signatures and arithmetic (quantize.py:147-170): absmax per row,
  ``scale = absmax / 127``, ``inv = where(absmax > 0, 127 / max(absmax,
  1e-30), 0)``, ``clip(round_half_even(x * inv), -127, 127)`` to int8 —
  bit-exact against the JAX function.

Per-tensor mode (kernel K2), the shared-scale ``axis_name`` path, the
given-``inv`` entry and stochastic rounding belong to the training
slice and raise ``NotImplementedError`` until then (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_TRAINING_SLICE = (
    "is part of the PS training slice, not ported yet (see ROADMAP.md, "
    "queue of kernels: K2 per-tensor, K1 given-inv, K3 accumulate-rescale)"
)


def quantize_rows_plain(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: f32/bf16 ``[NB, BS]`` -> (int8
    ``[NB, BS]``, f32 scale ``[NB, 1]``). ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    x = xb.float()
    absmax = x.abs().amax(dim=1, keepdim=True)
    # both divisions tensor by tensor: PyTorch computes `scalar / t` as
    # reciprocal(t) * scalar, and on CUDA `t / scalar` as t * (1 / scalar);
    # neither is the IEEE quotient JAX and the kernel produce
    c127 = torch.full_like(absmax, 127.0)
    scale = absmax / c127
    inv = torch.where(
        absmax > 0, c127 / torch.clamp_min(absmax, 1e-30),
        torch.zeros((), dtype=torch.float32, device=x.device),
    )
    q = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: per-row int8 quantization of ``[NB, BS]`` (f32 or bf16) ->
    (int8 ``[NB, BS]``, f32 scale ``[NB, 1]``).

    Replaces ps_pytorch_tpu/ops/quantize.py:_quant_rows_kernel (Pallas,
    quantize.py:64, launched at :101) and fuses the absmax/scale that
    XLA computed outside it. Bound on the H100: bytes (one read of x,
    one int8 write, one f32 scale per row); one warp per row, any row
    width and count. A CPU tensor runs ``quantize_rows_plain``; a CUDA
    tensor launches the kernel or raises."""
    if xb.dim() != 2:
        raise ValueError(f"quantize_rows takes [NB, BS], got {tuple(xb.shape)}")
    if not xb.is_cuda:
        return quantize_rows_plain(xb)
    from . import _build

    if xb.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"quantize_rows: unsupported dtype {xb.dtype}")
    xb = xb.contiguous()
    nb, bs = xb.shape
    q = torch.empty((nb, bs), dtype=torch.int8, device=xb.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=xb.device)
    if xb.numel() == 0:
        return q, scale
    lib = _build.load()
    with torch.cuda.device(xb.device):
        code = lib.ps_quantize_rows(
            xb.data_ptr(), _build.DTYPE_CODES[xb.dtype], q.data_ptr(),
            scale.data_ptr(), nb, bs, _build.stream_of(xb),
        )
    quantize_rows.launches += 1
    _build.check(code, "quantize_rows")
    return q, scale


quantize_rows.launches = 0


def quantize_int8(
    x: torch.Tensor,
    axis_name: Optional[str] = None,
    block_size: int = 0,
    rounding: str = "nearest",
    key=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization, block mode: q is ``[n_blocks,
    block_size]`` over the zero-padded flattened tensor, scale is
    ``[n_blocks, 1]``. Pass the original shape to ``dequantize_int8``."""
    if not block_size:
        raise NotImplementedError(f"per-tensor quantize_int8 {_TRAINING_SLICE}")
    if axis_name is not None:
        raise NotImplementedError(f"shared-scale quantize_int8 {_TRAINING_SLICE}")
    if rounding != "nearest" or key is not None:
        raise NotImplementedError(f"stochastic rounding {_TRAINING_SLICE}")
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // block_size)
    if nb * block_size != n:
        flat = F.pad(flat, (0, nb * block_size - n))
    return quantize_rows(flat.reshape(nb, block_size))


def dequantize_int8(
    q: torch.Tensor,
    scale: torch.Tensor,
    block_size: int = 0,
    shape: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """Invert ``quantize_int8`` (q may be an int32 sum of int8 payloads)."""
    out = q.float() * scale
    if block_size:
        if shape is None:
            raise ValueError("block mode dequantization needs the original shape")
        n = 1
        for d in shape:
            n *= int(d)
        out = out.reshape(-1)[:n].reshape(shape)
    return out
