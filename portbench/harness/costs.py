"""Operations and bytes from shapes, and the card's peaks.

Every count is what the algorithm needs at the given shapes, computed
here and never read from the program: each input byte read once, each
output byte written once, no recomputation. A roofline share is the
least time the card could take (the larger of operations over the peak
and bytes over the memory's rate) over the measured time.
"""

from __future__ import annotations

import os
from typing import Optional

from .spec import PORTBENCH, load_json

F32, BF16, I8 = 4, 2, 1
DTYPE_BYTES = {"float32": F32, "bfloat16": BF16}


def peaks(device_kind: str) -> Optional[dict]:
    """The card's published peaks, or None for a card the table lacks (a
    share against another card's peak would be no reading)."""
    return load_json(os.path.join(PORTBENCH, "peaks.json"))["devices"].get(device_kind)


def bound_s(ops: float, nbytes: float, peak_flops: float, peak: dict) -> float:
    return max(ops / peak_flops, nbytes / peak["hbm_bytes_per_s"])


# --- the PS wire: K2 over the step's stacked gradient


def k2_bytes(workers: int, params: int, leaves: int) -> float:
    """K2's per-tensor shared-scale quantize of every leaf of the
    worker-stacked f32 gradient: the f32 gradient read once, the int8
    payload written once, one f32 scale a leaf."""
    return workers * params * (F32 + I8) + leaves * F32


# --- a transformer LM (the port's dp x sp block at sp 1)


def lm_matmul_params(vocab: int, dim: int, depth: int, mlp_ratio: int) -> int:
    """Parameters that enter a matrix product a token: per block qkv, the
    output projection and the two MLP matrices, and the tied head."""
    m = dim * mlp_ratio
    return depth * (dim * 3 * dim + dim * dim + 2 * dim * m) + vocab * dim


def lm_train_flops_per_token(vocab: int, dim: int, depth: int, mlp_ratio: int,
                             seq: int, causal: bool = True) -> float:
    """6 N for the matrix products (forward 2 N, backward 4 N) plus the
    attention's QK^T and PV: 4 T D a token a layer forward at full
    attention, half of it causal, times 3 for forward and backward."""
    attn = 4.0 * seq * dim * depth * (0.5 if causal else 1.0)
    return 6.0 * lm_matmul_params(vocab, dim, depth, mlp_ratio) + 3.0 * attn


def flash_fwd_cost(b: int, h: int, t: int, d: int, in_bytes: int, causal: bool = True):
    """One launch of K4's partial forward at ``[b, t, h, d]``: (ops,
    bytes). QK^T and PV, 2 t^2 d each a (batch, head), half of it causal;
    q, k, v read, the f32 unnormalized output and its two f32 row
    statistics written."""
    frac = 0.5 if causal else 1.0
    ops = 4.0 * b * h * t * t * d * frac
    nbytes = 3.0 * b * t * h * d * in_bytes + b * t * h * d * F32 + 2.0 * b * h * t * F32
    return ops, nbytes


def flash_bwd_cost(b: int, h: int, t: int, d: int, in_bytes: int, causal: bool = True):
    """K5 + K6 of one layer at ``[b, t, h, d]``: (ops, bytes). The
    backward needs dP = dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q,
    2 t^2 d each a (batch, head), half of it causal; recomputing S and P
    inside the kernels is left out. q, k, v, dO and the f32 row
    statistics and deltas read once; dq, dk, dv written in f32."""
    frac = 0.5 if causal else 1.0
    ops = 8.0 * b * h * t * t * d * frac
    nbytes = 4.0 * b * t * h * d * in_bytes + 2.0 * b * h * t * F32 + 3.0 * b * t * h * d * F32
    return ops, nbytes


def flash_peak(dtype: str, peak: dict) -> float:
    """bf16 on the tensor cores; f32 as 3xTF32 (three TF32 products an
    f32 one)."""
    return peak["bf16_flops"] if dtype == "bfloat16" else peak["f32_3xtf32_flops"]


def lm_peak(dtype: str, peak: dict) -> float:
    """The step's peak by its compute dtype: bf16, or plain f32 (PyTorch's
    default keeps f32 matrix products off TF32)."""
    return peak["bf16_flops"] if dtype == "bfloat16" else peak["f32_flops"]


def conv_peak(tf32: bool, peak: dict) -> float:
    """The f32 convolutions' peak: TF32's where cuDNN may use it."""
    return peak["tf32_flops"] if tf32 else peak["f32_flops"]
