"""Flash attention forward (the port of ops/flash_attention.py).

``flash_fwd`` is the wrapper of kernel K4 (``csrc/flash_fwd.cu``): CUDA
tensors launch the kernel, CPU tensors take ``flash_fwd_plain`` beside
it. Both compute the TPU kernel's normalized forward
(flash_attention.py:83-142): f32 scores, p kept in f32 for the PV
product, the finite ``NEG_INF`` and the fully-masked-row guards, so such
rows give o = 0 and lse = NEG_INF.

``flash_attention(q, k, v, causal, scale)`` is the drop-in for
``full_attention``: ``[B, T, H, D]`` in and out.

Forward only in this slice: the backward kernels (K5 dq, K6 dk/dv), the
``normalize=False`` partial triple and ``flash_partial`` for ring hops
come with the training and ring slices (ROADMAP.md). Asking for a
gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

SUPPORTED_HEAD_DIMS = (32, 64, 128)


def _mask(tq: int, tk: int, causal: bool, k_len: Optional[int], q_off: int,
          k_off: int, device) -> torch.Tensor:
    """[Tq, Tk] keep-mask: key positions < k_len, and (causal) global key
    position <= global query position."""
    kpos = torch.arange(tk, device=device)
    keep = (kpos < (tk if k_len is None else k_len))[None, :].expand(tq, tk)
    if causal:
        qpos = torch.arange(tq, device=device)
        keep = keep & ((k_off + kpos)[None, :] <= (q_off + qpos)[:, None])
    return keep


def flash_fwd_plain(q, k, v, causal: bool, scale: float,
                    k_len: Optional[int] = None, q_off: int = 0,
                    k_off: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: ``[B, Tq, H, D]`` queries against
    ``[B, Tk, H, D]`` keys/values -> (o ``[B, Tq, H, D]`` in q's dtype,
    lse f32 ``[B, H, Tq]``). The online softmax over one whole key tile."""
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B, H, Tq, Tk]
    keep = _mask(q.shape[1], k.shape[1], causal, k_len, q_off, k_off, q.device)
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m > NEG_INF / 2, p, torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones((), device=q.device), l)
    o = torch.matmul(p, vf) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, T, H, D] tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v must share one dtype")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash attention is forward-only in this port: the backward "
            "kernels (K5 dq, K6 dk/dv) are still to port (ROADMAP.md)"
        )


def flash_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None,
              k_len: Optional[int] = None, q_off: int = 0, k_off: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: normalized flash attention forward -> (o ``[B, Tq, H, D]``,
    lse f32 ``[B, H, Tq]``).

    Replaces ps_pytorch_tpu/ops/flash_attention.py:_make_fwd_kernel
    (normalize=True, launched by _flash_fwd at :199). Bound on the H100 at
    the serving prefill shape: bytes (q/k/v/o read and written once); one
    block per (batch*head, 64-row q tile) loops over 64-key tiles staged
    in shared memory, reading ``[B, T, H, D]`` through strides (no fold
    copies) and masking ragged tiles itself. A CPU tensor runs
    ``flash_fwd_plain``; a CUDA tensor launches the kernel or raises."""
    _check_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal, scale, k_len, q_off, k_off)
    from . import _build

    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_fwd: unsupported dtype {q.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = (ctypes.c_longlong * 12)(*(
        int(x.stride(i)) for x in (q, k, v, o) for i in (0, 1, 2)
    ))
    lib = _build.load()
    with torch.cuda.device(q.device):
        code = lib.ps_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _build.DTYPE_CODES[q.dtype], b, h, tq, tk, d,
            strides, float(scale), int(bool(causal)),
            -1 if k_len is None else int(k_len), int(q_off), int(k_off),
            _build.stream_of(q),
        )
    flash_fwd.launches += 1
    _build.check(code, "flash_fwd")
    return o, lse


flash_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Drop-in for ``full_attention`` (``[B, T, H, D]`` in and out) on the
    K4 kernel; any T (ragged tiles are masked in the kernel)."""
    o, _ = flash_fwd(q, k, v, causal=causal, scale=scale)
    return o
