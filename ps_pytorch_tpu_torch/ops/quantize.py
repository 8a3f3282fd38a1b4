"""int8 symmetric quantization (the port of ops/quantize.py).

Four wrappers, each of one hand-written kernel; CUDA tensors launch the
kernel, CPU tensors take the plain version beside it, with no fallback
between the two (the fourth, ``accumulate_rescale_int8``, is K3 below):

- ``quantize_rows`` — K1, fused entry (``csrc/quantize_rows.cu``): per-row
  absmax, scale and quantize of ``[NB, BS]``. The serving slice's int8 KV
  cache, and the block-scale wire without shared scales.
- ``quantize_rows_scaled`` — K1, shared-scale entry: rows ``[N*nb, bs]``
  of N workers quantized with a given per-row absmax ``[nb]`` that was
  already max-reduced over the workers (the block-scale gradient wire).
- ``quantize_tensor`` — K2 (``csrc/quantize_tensor.cu``): one absmax over
  the whole (worker-stacked) tensor, one shared scale.

``quantize_int8(x, axis_name=..., block_size=...)`` / ``dequantize_int8``
keep the JAX signatures. With ``axis_name`` (a ``parallel.mesh.WorkerAxis``)
``x`` is worker-stacked ``[N, *shape]``: the absmax is taken over every
worker (the pmax) and each worker's payload is quantized with that
shared scale; the scale comes back once, without the worker dimension.

The arithmetic is quantize.py:147-186 as XLA runs it under jit, op for op:
``inv = where(absmax > 0, 127 / max(absmax, 1e-30), 0)`` (an IEEE
quotient), ``clip(round_half_even(x * inv), -127, 127)`` to int8, and
``scale = absmax * (1/127)``: inside a jitted program XLA rewrites the
division by the constant 127 into a multiply by the f32 constant 1/127,
and every JAX caller of these functions (the train step, the serving
engine) is jitted. Bit-exact against the JAX function under jit.

The homomorphic (compressed-domain) algebra: ``accum_capacity`` /
``accum_dtype`` size the exact integer accumulator of a shared-lattice
sum, ``homomorphic_rescale`` rounds an accumulation back onto the int8
lattice, and ``accumulate_rescale_int8`` fuses the two over the worker
rows of a payload: K3 (``csrc/accum_rescale.cu``) on a CUDA tensor,
``accumulate_rescale_plain`` on a CPU one.

Stochastic rounding, ``quantize_lattice`` and int4 belong to later
slices and raise ``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_NOT_PORTED = (
    "is not ported yet (see ROADMAP.md, queue 1 items 5 and 15: "
    "stochastic rounding and the int4 lattice)"
)

_INT8_PEAK = 127  # symmetric int8 payloads live in [-127, 127]

# the f32 constant XLA multiplies by where the JAX code divides by 127.0
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def _inv_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``where(absmax > 0, 127 / max(absmax, 1e-30), 0)`` as an IEEE
    quotient: PyTorch computes ``127.0 / t`` as ``reciprocal(t) * 127``,
    so the numerator is a tensor too."""
    c127 = torch.full_like(absmax, 127.0)
    return torch.where(
        absmax > 0, c127 / torch.clamp_min(absmax, 1e-30),
        torch.zeros((), dtype=torch.float32, device=absmax.device),
    )


def _quant(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def quantize_rows_plain(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (fused): f32/bf16 ``[NB, BS]`` -> (int8
    ``[NB, BS]``, f32 scale ``[NB, 1]``)."""
    absmax = xb.float().abs().amax(dim=1, keepdim=True)
    return _quant(xb, _inv_scale(absmax)), absmax * RECIP_127


def quantize_rows_scaled_plain(
    xb: torch.Tensor, absmax: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1's shared-scale entry: rows ``[N*nb,
    bs]``, given absmax ``[nb]`` (row ``w*nb + r`` uses ``absmax[r]``) ->
    (int8 ``[N*nb, bs]``, f32 scale ``[nb, 1]``)."""
    amax = absmax.reshape(-1, 1).float()
    nb, bs = amax.shape[0], xb.shape[1]
    rows = xb.reshape(-1, nb, bs)
    q = _quant(rows, _inv_scale(amax)[None])
    return q.reshape(xb.shape), amax * RECIP_127


def quantize_tensor_plain(x: torch.Tensor, return_absmax: bool = False):
    """Plain PyTorch version of K2: one absmax over all of ``x`` -> (int8
    like ``x``, f32 scalar scale) [, the absmax]."""
    absmax = x.float().abs().amax()
    q, scale = _quant(x, _inv_scale(absmax)), absmax * RECIP_127
    return (q, scale, absmax) if return_absmax else (q, scale)


def _kernel_input(x: torch.Tensor, what: str) -> torch.Tensor:
    from . import _build

    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    return x.contiguous()


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

    xb = _kernel_input(xb, "quantize_rows")
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


def quantize_rows_scaled(
    xb: torch.Tensor, absmax: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1, shared-scale entry: rows ``[N*nb, bs]`` of N workers (f32 or
    bf16) quantized with the given absmax ``[nb]`` (f32, already
    max-reduced over the workers; row ``w*nb + r`` uses ``absmax[r]``)
    -> (int8 ``[N*nb, bs]``, f32 scale ``[nb, 1]``).

    Replaces the same Pallas kernel as ``quantize_rows`` where its ``inv``
    came from a pmax'd absmax (quantize.py:152-167). Bound: bytes (one
    read of x, one int8 write). A CPU tensor runs
    ``quantize_rows_scaled_plain``; a CUDA tensor launches the kernel or
    raises."""
    if xb.dim() != 2:
        raise ValueError(f"quantize_rows_scaled takes [N*nb, bs], got {tuple(xb.shape)}")
    nb = absmax.numel()
    if nb == 0 or xb.shape[0] % nb:
        raise ValueError(
            f"quantize_rows_scaled: {xb.shape[0]} rows are not a whole number "
            f"of workers' {nb} rows"
        )
    if not xb.is_cuda:
        return quantize_rows_scaled_plain(xb, absmax)
    from . import _build

    if not absmax.is_cuda or absmax.dtype != torch.float32:
        raise TypeError("quantize_rows_scaled: absmax must be f32 on the same card")
    xb = _kernel_input(xb, "quantize_rows_scaled")
    absmax = absmax.reshape(-1).contiguous()
    rows, bs = xb.shape
    q = torch.empty((rows, bs), dtype=torch.int8, device=xb.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=xb.device)
    if xb.numel() == 0:
        return q, scale
    lib = _build.load()
    with torch.cuda.device(xb.device):
        code = lib.ps_quantize_rows_scaled(
            xb.data_ptr(), _build.DTYPE_CODES[xb.dtype], absmax.data_ptr(), nb,
            q.data_ptr(), scale.data_ptr(), rows, bs, _build.stream_of(xb),
        )
    quantize_rows_scaled.launches += 1
    _build.check(code, "quantize_rows_scaled")
    return q, scale


quantize_rows_scaled.launches = 0


def quantize_tensor(x: torch.Tensor, return_absmax: bool = False):
    """K2: per-tensor int8 quantization of ``x`` (any shape, f32 or bf16)
    with one scale -> (int8 like ``x``, f32 scalar scale) [, the device
    absmax the scale came from].

    Replaces ps_pytorch_tpu/ops/quantize.py:_quant_kernel (Pallas,
    quantize.py:58, launched at :78) together with the absmax and
    inverse XLA computed around it. Two launches, nothing through the
    host: ``ps_absmax`` over all of ``x`` into a device scalar (for a
    worker-stacked ``x`` that is the pmax), then ``ps_quantize_tensor``,
    which reads it from device memory. Any length, no lane or row
    condition. Bound on the H100: bytes. A CPU tensor runs
    ``quantize_tensor_plain``; a CUDA tensor launches or raises."""
    if not x.is_cuda:
        return quantize_tensor_plain(x, return_absmax)
    from . import _build

    x = _kernel_input(x, "quantize_tensor")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    absmax = torch.empty((), dtype=torch.float32, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _build.load()
    code = _build.DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        stream = _build.stream_of(x)
        err = lib.ps_absmax(x.data_ptr(), code, x.numel(), absmax.data_ptr(), stream)
        _build.check(err, "quantize_tensor (absmax)")
        err = lib.ps_quantize_tensor(
            x.data_ptr(), code, x.numel(), absmax.data_ptr(), q.data_ptr(),
            scale.data_ptr(), stream,
        )
    quantize_tensor.launches += 1
    _build.check(err, "quantize_tensor")
    return (q, scale, absmax) if return_absmax else (q, scale)


quantize_tensor.launches = 0


def quantize_int8(
    x: torch.Tensor,
    axis_name=None,
    block_size: int = 0,
    rounding: str = "nearest",
    key=None,
    return_absmax: bool = False,
):
    """Symmetric int8 quantization.

    Per-tensor mode (``block_size=0``): q has x's shape, the scale is a
    scalar. Block mode: q is ``[n_blocks, block_size]`` over the
    zero-padded flattened tensor, the scale ``[n_blocks, 1]``; pass the
    original shape to ``dequantize_int8``.

    ``axis_name`` (a ``WorkerAxis``): ``x`` is worker-stacked ``[N,
    *shape]`` and the scales are shared over the workers. Per-tensor:
    q ``[N, *shape]``, one scalar scale. Block mode: each worker's
    flattened tensor is cut into blocks, q is ``[N, n_blocks,
    block_size]`` and the scale ``[n_blocks, 1]``.

    ``return_absmax`` (shared or per-tensor scales) also returns the
    absmax the scales came from, shaped like them: a consumer that
    multiplies the scale by a constant multiplies the absmax by the
    folded constant instead (``fold_recip``)."""
    if rounding != "nearest" or key is not None:
        raise NotImplementedError(f"stochastic rounding {_NOT_PORTED}")
    if axis_name is not None and not hasattr(axis_name, "size"):
        raise TypeError(
            f"axis_name must be a parallel.mesh.WorkerAxis, got {axis_name!r}"
        )
    if not block_size:
        # one absmax over the whole (stacked) tensor is the pmax
        return quantize_tensor(x, return_absmax)
    lead = (axis_name.size,) if axis_name is not None else ()
    if axis_name is not None and (x.dim() == 0 or x.shape[0] != axis_name.size):
        raise ValueError(
            f"shared-scale quantize_int8 takes [{axis_name.size}, ...], got "
            f"{tuple(x.shape)}"
        )
    flat = x.reshape(lead + (-1,))
    n = flat.shape[-1]
    nb = -(-n // block_size)
    if nb * block_size != n:
        flat = F.pad(flat, (0, nb * block_size - n))
    if axis_name is None:
        if return_absmax:
            raise ValueError("return_absmax needs shared (axis_name) or per-tensor scales")
        return quantize_rows(flat.reshape(nb, block_size))
    xb = flat.reshape(axis_name.size, nb, block_size)
    # per-(worker, block) absmax, then the pmax over workers: XLA ops
    # outside the kernel in JAX too (quantize.py:152-154)
    absmax = xb.abs().amax(dim=(0, 2)).float()
    q, scale = quantize_rows_scaled(xb.reshape(-1, block_size), absmax)
    q = q.reshape(axis_name.size, nb, block_size)
    return (q, scale, absmax.reshape(nb, 1)) if return_absmax else (q, scale)


def fold_recip(denominator: float) -> float:
    """``RECIP_127 * f32(1/denominator)``, rounded once to f32: the
    constant XLA folds a dequantize scale's two constant multiplies into
    (``(absmax * (1/127)) * (1/K)`` becomes ``absmax * c`` under jit).
    ``absmax * fold_recip(K)`` is then the JAX program's ``scale / K``."""
    return float(np.float32(RECIP_127) * np.float32(np.float32(1.0) / np.float32(denominator)))


def dequantize_int8(
    q: torch.Tensor,
    scale: torch.Tensor,
    block_size: int = 0,
    shape: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """Invert ``quantize_int8`` (q may be an int32 sum of int8 payloads).
    Block mode takes q ``[n_blocks, block_size]`` or, worker-stacked,
    ``[N, n_blocks, block_size]``, and ``shape`` without the worker
    dimension."""
    out = q.float() * scale
    if block_size:
        if shape is None:
            raise ValueError("block mode dequantization needs the original shape")
        n = 1
        for d in shape:
            n *= int(d)
        lead = tuple(out.shape[:-2])
        out = out.reshape(lead + (-1,))[..., :n].reshape(lead + tuple(shape))
    return out


# ------------------------------------------- homomorphic (compressed-domain)


def accum_capacity(dtype_name: str, peak: int = _INT8_PEAK) -> int:
    """Largest number of full-scale (``|q| = peak``) lattice payloads whose
    sum provably fits ``dtype_name``: ``floor(dtype_max / peak)``."""
    bits = {"int16": 15, "int32": 31}[dtype_name]
    return (2 ** bits - 1) // int(peak)


# the int8 lattice's capacities: int16 holds 258 workers (258 * 127 =
# 32766), int32 holds 16_909_320
ACCUM_CAPACITY = {
    "int16": accum_capacity("int16"),
    "int32": accum_capacity("int32"),
}


def accum_dtype(num_summands: int, peak: int = _INT8_PEAK) -> torch.dtype:
    """Smallest integer dtype that holds a sum of ``num_summands``
    payloads of ``|q| <= peak`` exactly: the wire dtype of a homomorphic
    psum (int16 through 258 workers on the int8 lattice). Past int32's
    capacity no accumulator is exact, and this raises."""
    if num_summands < 1:
        raise ValueError(f"accum_dtype needs >= 1 summand, got {num_summands}")
    if peak < 1:
        raise ValueError(f"accum_dtype needs peak >= 1, got {peak}")
    if num_summands <= accum_capacity("int16", peak):
        return torch.int16
    if num_summands <= accum_capacity("int32", peak):
        return torch.int32
    raise ValueError(
        f"homomorphic accumulation over {num_summands} full-scale "
        f"peak-{peak} payloads can overflow int32 (capacity "
        f"{accum_capacity('int32', peak)}) — use wire_domain='dequant'"
    )


def _divisor(divisor, device) -> torch.Tensor:
    """The rescale divisor as a 0-d f32 tensor on ``device``: a Python
    number becomes one through a fill (no host sync); a tensor must
    already be a one-element f32 on that device (the adaptive count)."""
    if isinstance(divisor, torch.Tensor):
        if divisor.numel() != 1 or divisor.dtype != torch.float32:
            raise TypeError(f"divisor must be a one-element f32 tensor, got "
                            f"{divisor.dtype} {tuple(divisor.shape)}")
        if divisor.device != torch.device(device):
            raise TypeError(f"divisor lies on {divisor.device}, the payload on {device}")
        return divisor.reshape(())
    return torch.full((), float(divisor), dtype=torch.float32, device=device)


def homomorphic_rescale(acc: torch.Tensor, divisor) -> torch.Tensor:
    """``clip(round_half_even(acc / divisor), -127, 127)`` to int8: an
    exact integer accumulation of at most ``divisor`` shared-lattice int8
    payloads, rounded back onto the lattice. The quotient is an IEEE f32
    division, tensor by tensor (``divisor`` a Python number or a 0-d f32
    tensor)."""
    q = torch.round(acc.float() / _divisor(divisor, acc.device))
    return torch.clamp(q, -_INT8_PEAK, _INT8_PEAK).to(torch.int8)


def accumulate_rescale_plain(recv: torch.Tensor, divisor) -> torch.Tensor:
    """Plain PyTorch version of K3: int8 ``[n, s]`` -> int8 ``[s]``, the
    exact int32 column sum then ``homomorphic_rescale``."""
    return homomorphic_rescale(recv.to(torch.int32).sum(0, dtype=torch.int32), divisor)


def accumulate_rescale_int8(recv: torch.Tensor, divisor) -> torch.Tensor:
    """K3: exact integer accumulation over the worker rows of an int8
    payload ``[n, s]`` fused with the lattice rescale -> int8 ``[s]``.

    Replaces ps_pytorch_tpu/ops/quantize.py:_accum_rescale_kernel
    (Pallas, quantize.py:409, launched at :424). ``divisor`` is a Python
    number or a 0-d f32 tensor on the card; the kernel reads it from
    device memory, as the TPU read it from SMEM, so a changing divisor
    costs no host sync and no rebuild. Any ``n >= 1`` and any ``s``: no
    lane or block condition (the Pallas wrapper needed ``s % 128 == 0``).
    Bound on the H100: bytes (``n*s`` int8 read once, ``s`` written). A
    CPU tensor runs ``accumulate_rescale_plain``; a CUDA tensor launches
    the kernel or raises."""
    if recv.dim() != 2 or recv.dtype != torch.int8:
        raise ValueError(f"accumulate_rescale_int8 takes int8 [n, s], got "
                         f"{recv.dtype} {tuple(recv.shape)}")
    if recv.shape[0] < 1:
        raise ValueError("accumulate_rescale_int8 needs at least one row")
    if not recv.is_cuda:
        return accumulate_rescale_plain(recv, divisor)
    from . import _build

    div = _divisor(divisor, recv.device)
    recv = recv.contiguous()
    n, s = recv.shape
    out = torch.empty((s,), dtype=torch.int8, device=recv.device)
    if s == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(recv.device):
        code = lib.ps_accumulate_rescale(recv.data_ptr(), n, s, div.data_ptr(),
                                         out.data_ptr(), _build.stream_of(recv))
    accumulate_rescale_int8.launches += 1
    _build.check(code, "accumulate_rescale_int8")
    return out


accumulate_rescale_int8.launches = 0
