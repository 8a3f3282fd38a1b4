"""Flash attention, forward and backward (the port of
ops/flash_attention.py).

Three hand-written kernels, each with a plain PyTorch version beside it
that computes from the full ``[Tq, Tk]`` score tile. CPU tensors take the
plain versions; CUDA tensors launch the kernel or raise.

- ``flash_fwd`` — K4 normalized (``csrc/flash_fwd.cu``): (o, lse), the
  forward of ``flash_attention`` and of the serving prefill;
- ``flash_partial`` — K4 with ``normalize=False`` (same kernel): one
  ring hop's unnormalized triple (pv, m, l) in f32;
- ``flash_bwd`` — K5 ``flash_bwd_dq`` and K6 ``flash_bwd_dkv``
  (``csrc/flash_bwd.cu``): (dq, dk, dv) from the final lse and delta,
  in f32 (``flash_grads_partial``, ring hops) or the input dtype.

bf16 inputs run all three on the tensor cores (``mma.sync``, with P and
dS entering the accumulating products as a bf16 hi + lo pair, so the
results keep the TPU kernels' f32 products). f32 inputs run K5 and K6 on
the tensor cores too, every operand as a TF32 hi + lo pair (3xTF32, each
8-deep step added to the accumulator by an f32 add), and K4 on the CUDA
cores. The route is an explicit choice by
dtype in the C entry points, with no fallback from one to another.

All keep the TPU kernels' semantics: f32 scores, f32 softmax statistics
whatever the input dtype, the finite ``NEG_INF`` and the guards for rows
whose keys are all masked (o = 0, lse = NEG_INF; the triple pv = 0,
m = NEG_INF, l = 0; p = 0 in the backward where lse <= NEG_INF / 2).
``mask_scores`` is the plain side of the one mask rule that
``csrc/flash_mask.cuh`` holds for the kernels.

Layout: ``[B, T, H, D]`` tensors (read through their strides, so head
splits of a fused projection need no copy), statistics ``[B, H, T]``. A
JAX-layout ``[BH, T, D]`` array is the ``H = 1`` case
(``x[:, :, None]``). Causal offsets ``q_off`` / ``k_off`` are ints or
int tensors ``[B]`` (one per batch row: the stacked shards of a ring
hop), read by the kernels from a device int32 table.

``flash_attention(q, k, v, causal, scale)`` is the drop-in for
``full_attention`` and takes gradients: K4 forward, K5 + K6 backward in
the input dtype (the custom VJP of flash_attention.py:415-437).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30

SUPPORTED_HEAD_DIMS = (32, 64, 128)

Offset = Union[int, torch.Tensor]


def _rows(off: Offset, b: int, device) -> torch.Tensor:
    """An offset as one int64 value per batch row, ``[B]``."""
    if isinstance(off, torch.Tensor):
        return off.to(device=device, dtype=torch.int64).reshape(-1).expand(b)
    return torch.full((b,), int(off), dtype=torch.int64, device=device)


def mask_scores(s: torch.Tensor, causal: bool, k_len: Optional[int] = None,
                q_off: Offset = 0, k_off: Offset = 0) -> torch.Tensor:
    """The plain mask (``_mask_scores``, flash_attention.py:40): scores
    ``[B, H, Tq, Tk]`` -> NEG_INF where the key is at or past ``k_len``
    (local position) or, under ``causal``, its global position
    ``k_off + k`` is past the query's ``q_off + q``."""
    b, _, tq, tk = s.shape
    kpos = torch.arange(tk, device=s.device)
    keep = (kpos < (tk if k_len is None else k_len))[None, None, None, :]
    if causal:
        qpos = torch.arange(tq, device=s.device)
        qo = _rows(q_off, b, s.device)[:, None, None, None]
        ko = _rows(k_off, b, s.device)[:, None, None, None]
        keep = keep & ((ko + kpos) <= (qo + qpos[:, None]))
    return torch.where(keep, s, torch.full((), NEG_INF, device=s.device))


def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> f32 [B, H, T, D]."""
    return x.float().permute(0, 2, 1, 3)


def _scores(q, k, scale, causal, k_len, q_off, k_off) -> torch.Tensor:
    s = torch.matmul(_heads(q), _heads(k).transpose(-1, -2)) * scale
    return mask_scores(s, causal, k_len, q_off, k_off)


def flash_partial_plain(q, k, v, causal: bool, scale: float, q_off: Offset = 0,
                        k_off: Offset = 0, k_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4 ``normalize=False``: ``[B, Tq, H, D]`` queries
    against ``[B, Tk, H, D]`` keys/values -> (pv f32 ``[B, Tq, H, D]``, m
    f32 ``[B, H, Tq]``, l f32 ``[B, H, Tq]``)."""
    s = _scores(q, k, scale, causal, k_len, q_off, k_off)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(m[..., None] > NEG_INF / 2, p, torch.zeros((), device=q.device))
    pv = torch.matmul(p, _heads(v)).permute(0, 2, 1, 3)
    return pv, m, p.sum(dim=-1)


def flash_fwd_plain(q, k, v, causal: bool, scale: float,
                    k_len: Optional[int] = None, q_off: Offset = 0,
                    k_off: Offset = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 normalized: -> (o ``[B, Tq, H, D]`` in q's
    dtype, lse f32 ``[B, H, Tq]``)."""
    pv, m, l = flash_partial_plain(q, k, v, causal, scale, q_off, k_off, k_len)
    l_safe = torch.where(l == 0.0, torch.ones((), device=q.device), l)
    o = pv / l_safe.transpose(1, 2)[..., None]
    return o.to(q.dtype), m + torch.log(l_safe)


def flash_bwd_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                    q_off: Offset = 0, k_off: Offset = 0,
                    k_len: Optional[int] = None, out_dtype=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5 + K6: (dq ``[B, Tq, H, D]``, dk, dv ``[B, Tk,
    H, D]``) from the final ``lse`` and ``delta`` (f32 ``[B, H, Tq]``), in
    ``out_dtype`` (default: the input dtype)."""
    s = _scores(q, k, scale, causal, k_len, q_off, k_off)
    p = torch.exp(s - lse[..., None])
    p = torch.where(lse[..., None] > NEG_INF / 2, p, torch.zeros((), device=q.device))
    dof = _heads(do)
    dp = torch.matmul(dof, _heads(v).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, _heads(k)).permute(0, 2, 1, 3)
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q)).permute(0, 2, 1, 3)
    dv = torch.matmul(p.transpose(-1, -2), dof).permute(0, 2, 1, 3)
    return tuple(x.to(out_dtype or y.dtype) for x, y in ((dq, q), (dk, k), (dv, v)))


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, T, H, D] tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v must share one dtype")


def _check_cuda(what: str, *xs: torch.Tensor) -> None:
    from . import _build

    q = xs[0]
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {q.dtype}")
    if any(x.device != q.device for x in xs):
        raise ValueError(f"{what}: operands must be on one device")


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the tensor-core kernels (bf16 K4, bf16 and f32 K5/K6)
    read it: unit last stride and every ``[D]`` row on a 16-byte boundary
    (base address and batch, time, head strides), since their ``cp.async``
    copies move 16 bytes. Head splits of a fused projection pass as they
    are; any other view is copied here, explicitly."""
    x = _unit_last(x)
    step = 16 // x.element_size()
    if x.data_ptr() % 16 == 0 and all(x.stride(i) % step == 0 for i in range(3)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as K4's route reads it: bf16 goes to the tensor-core kernel
    (``_rows16``), f32 to the scalar one (unit last stride)."""
    return _rows16(x) if x.dtype == torch.bfloat16 else _unit_last(x)


def _stats(x: torch.Tensor, b: int, h: int, t: int) -> torch.Tensor:
    """A ``[B, H, T]`` statistic as the contiguous f32 the kernels read."""
    if x.shape != (b, h, t):
        raise ValueError(f"expected statistics [{b}, {h}, {t}], got {tuple(x.shape)}")
    return x.to(torch.float32).contiguous()


def _strides(*xs: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(xs)))(*(
        int(x.stride(i)) for x in xs for i in (0, 1, 2)))


def _offsets(q_off: Offset, k_off: Offset, b: int, device):
    """(table pointer or None, scalar q_off, scalar k_off, table to keep
    alive): int offsets ride as scalars; tensor offsets become one device
    int32 ``[B, 2]`` table."""
    if not isinstance(q_off, torch.Tensor) and not isinstance(k_off, torch.Tensor):
        return None, int(q_off), int(k_off), None
    table = torch.stack([_rows(q_off, b, device), _rows(k_off, b, device)], dim=1)
    table = table.to(torch.int32).contiguous()
    return ctypes.c_void_p(table.data_ptr()), 0, 0, table


def _k_len(k_len: Optional[int]) -> int:
    return -1 if k_len is None else int(k_len)


def _launch_fwd(q, k, v, causal, scale, k_len, q_off, k_off, normalize: bool):
    from . import _build

    _check_cuda("flash_fwd", q, k, v)
    q, k, v = (_kernel_view(x) for x in (q, k, v))
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o = torch.empty((b, tq, h, d), dtype=q.dtype if normalize else torch.float32,
                    device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = None if normalize else torch.empty_like(lse)
    if o.numel() == 0:
        return o, lse, l
    off, qo, ko, _table = _offsets(q_off, k_off, b, q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        code = lib.ps_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if l is None else l.data_ptr(), _build.DTYPE_CODES[q.dtype],
            int(normalize), b, h, tq, tk, d, _strides(q, k, v, o), float(scale),
            int(bool(causal)), _k_len(k_len), off, qo, ko, _build.stream_of(q),
        )
    if normalize:
        flash_fwd.launches += 1
    else:
        flash_partial.launches += 1
    _build.check(code, "flash_fwd" if normalize else "flash_partial")
    return o, lse, l


def flash_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None,
              k_len: Optional[int] = None, q_off: Offset = 0, k_off: Offset = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: normalized flash attention forward -> (o ``[B, Tq, H, D]``,
    lse f32 ``[B, H, Tq]``).

    Replaces ps_pytorch_tpu/ops/flash_attention.py:_make_fwd_kernel
    (normalize=True, launched by _flash_fwd at :199). Bound on the H100:
    bytes (q/k/v/o read and written once); one block per (batch*head,
    64-row q tile) loops over 64-key tiles staged in shared memory,
    reading ``[B, T, H, D]`` through strides (no fold copies) and masking
    ragged tiles itself. bf16 inputs take the tensor-core kernel (rows
    16-byte aligned: ``_rows16``), f32 the scalar one. A CPU tensor runs
    ``flash_fwd_plain``; a CUDA tensor launches the kernel or raises."""
    _check_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal, scale, k_len, q_off, k_off)
    o, lse, _ = _launch_fwd(q, k, v, causal, scale, k_len, q_off, k_off, True)
    return o, lse


flash_fwd.launches = 0


def flash_partial(q, k, v, causal: bool, scale: float, q_off: Offset = 0,
                  k_off: Offset = 0, k_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 ``normalize=False``: one ring hop's UNNORMALIZED contribution,
    ``[B, Tq, H, D]`` queries against a visiting ``[B, Tk, H, D]`` K/V
    shard -> (pv f32 ``[B, Tq, H, D]``, m f32 ``[B, H, Tq]``, l f32
    ``[B, H, Tq]``), merged across hops by the caller (flash_partial,
    flash_attention.py:483). ``q_off`` / ``k_off`` are the shards' global
    offsets, per batch row when tensors: one launch serves every stacked
    shard of a hop. Bound on the H100: bytes (q/k/v in, the f32 triple
    out). bf16 inputs take the tensor-core kernel, f32 the scalar one.
    Any shard lengths: ragged tiles are masked in the kernel (the JAX
    wrapper pads to the block grid instead, with the same result)."""
    _check_inputs(q, k, v)
    if not q.is_cuda:
        return flash_partial_plain(q, k, v, causal, scale, q_off, k_off, k_len)
    return _launch_fwd(q, k, v, causal, scale, k_len, q_off, k_off, False)


flash_partial.launches = 0


def _launch_bwd(q, k, v, do, lse, delta, causal, scale, q_off, k_off, k_len,
                out_dtype, dq_pass: bool):
    from . import _build

    _check_cuda("flash_bwd", q, k, v, do, lse, delta)
    if do.dtype != q.dtype:
        raise TypeError(f"flash_bwd: do in {do.dtype} for {q.dtype} inputs")
    q, k, v, do = (_rows16(x) for x in (q, k, v, do))  # both routes: tensor cores
    b, tq, h, d = q.shape
    tk = k.shape[1]
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (torch.float32, q.dtype):
        raise TypeError(f"flash_bwd: gradients in {out_dtype} for {q.dtype} inputs")
    lse, delta = _stats(lse, b, h, tq), _stats(delta, b, h, tq)
    off, qo, ko, _table = _offsets(q_off, k_off, b, q.device)
    lib = _build.load()
    args = (_build.DTYPE_CODES[q.dtype], int(out_dtype == torch.float32))
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    tail = (float(scale), int(bool(causal)), _k_len(k_len), off, qo, ko,
            _build.stream_of(q))
    with torch.cuda.device(q.device):
        if dq_pass:
            dq = torch.empty((b, tq, h, d), dtype=out_dtype, device=q.device)
            code = lib.ps_flash_bwd_dq(*common, dq.data_ptr(), *args, b, h, tq, tk, d,
                                       _strides(q, k, v, do, dq), *tail)
            flash_bwd_dq.launches += 1
            _build.check(code, "flash_bwd_dq")
            return dq
        dk = torch.empty((b, tk, h, d), dtype=out_dtype, device=q.device)
        dv = torch.empty_like(dk)
        code = lib.ps_flash_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(), *args, b, h,
                                    tq, tk, d, _strides(q, k, v, do, dk, dv), *tail)
        flash_bwd_dkv.launches += 1
        _build.check(code, "flash_bwd_dkv")
        return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 q_off: Offset = 0, k_off: Offset = 0, k_len: Optional[int] = None,
                 out_dtype=None) -> torch.Tensor:
    """K5: dq = sum over keys of ds * k, with p recomputed from the final
    lse and ds = p * (do . v - delta) * scale.

    Replaces ps_pytorch_tpu/ops/flash_attention.py:_make_dq_kernel
    (launched by _flash_bwd at :319). One block per (batch*head, 64-row q
    tile) loops over the key tiles its rows can see; no atomics. Bound on
    the H100: bytes at LM-1 in bf16, else operations (6 D flops a kept
    pair). Both routes run on the tensor cores, with rows 16-byte aligned
    (``_rows16``): bf16 inputs ``flash_dq_mma_kernel``, f32 inputs
    ``flash_dq_tf32_kernel`` (3xTF32), whose gradients are f32. A CPU
    tensor runs ``flash_bwd_plain``."""
    _check_inputs(q, k, v)
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, q_off, k_off,
                               k_len, out_dtype)[0]
    return _launch_bwd(q, k, v, do, lse, delta, causal, scale, q_off, k_off, k_len,
                       out_dtype, True)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  q_off: Offset = 0, k_off: Offset = 0, k_len: Optional[int] = None,
                  out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: dv = sum over queries of p * do, dk = sum over queries of
    ds * q.

    Replaces ps_pytorch_tpu/ops/flash_attention.py:_make_dkv_kernel
    (launched by _flash_bwd at :337). One block per (batch*head, 64-key
    tile) loops over the query tiles that can see it; no atomics, so the
    result is the same from run to run. Bound on the H100: bytes at LM-1
    in bf16, else operations (8 D flops a kept pair). bf16 inputs run
    ``flash_dkv_mma_kernel``, f32 inputs ``flash_dkv_tf32_kernel``
    (3xTF32). A CPU tensor runs ``flash_bwd_plain``."""
    _check_inputs(q, k, v)
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, q_off, k_off,
                               k_len, out_dtype)[1:]
    return _launch_bwd(q, k, v, do, lse, delta, causal, scale, q_off, k_off, k_len,
                       out_dtype, False)


flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, do, lse, delta, causal: bool, scale: float,
              q_off: Offset = 0, k_off: Offset = 0, k_len: Optional[int] = None,
              out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the FINAL lse and delta (``_flash_bwd``,
    flash_attention.py:299): K5 then K6 on a CUDA tensor,
    ``flash_bwd_plain`` on a CPU one. ``out_dtype`` overrides the
    gradients' dtype (f32 on ring hops, so per-hop pieces sum without
    rounding)."""
    _check_inputs(q, k, v)
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, q_off, k_off,
                               k_len, out_dtype)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, q_off, k_off, k_len,
                      out_dtype)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, q_off, k_off,
                           k_len, out_dtype)
    return dq, dk, dv


def flash_grads_partial(q, k, v, do, lse, delta, scale: float, causal: bool,
                        q_off: Offset = 0, k_off: Offset = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One hop's gradient pieces (dq ``[B, Tq, H, D]``, dk, dv ``[B, Tk,
    H, D]``, all f32) given the FINAL merged lse / delta: per-hop pieces
    sum to the exact flash backward (flash_grads_partial,
    flash_attention.py:509)."""
    return flash_bwd(q, k, v, do, lse, delta, causal, scale, q_off, k_off,
                     out_dtype=torch.float32)


class _Flash(torch.autograd.Function):
    """flash_attention's custom VJP (flash_attention.py:415-437): K4
    forward; K5 + K6 backward in the input dtype, with delta = rowsum(do *
    o) over the output cast back to its dtype (:432)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        dq, dk, dv = flash_bwd(q, k, v, do.to(q.dtype), lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Drop-in for ``full_attention`` (``[B, T, H, D]`` in and out) on the
    K4 kernel, differentiable through K5 and K6; any T (ragged tiles are
    masked in the kernels)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _Flash.apply(q, k, v, bool(causal), float(scale))
