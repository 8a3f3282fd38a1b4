"""Plain PyTorch reference of GPT-2 small (openai/gpt-2, 124M) as the
port runs it: learned positions, pre-norm blocks of causal multi-head
attention and a tanh-GELU MLP of 4 x the width, a final norm and the
token embedding as the output head; RMSNorm for LayerNorm and no biases
(the port's departures). torch operations only; nothing of the program.

Leaves are named by ``/``-joined paths of the port's tree
(``blocks/3/wqkv``), matrices ``[in, out]`` as the port stores them.
The next-token loss is the mean over every position but the last.

``precision``: ``"f32"`` (the caller turns TF32 off), ``"tf32"`` (every
matrix product's operands rounded to TF32's 10-bit mantissa, then
multiplied in f32, as TF32 tensor cores take them: the f32 control) or
``"fp8"`` (the bf16 control, the usual fp8 training recipe: each
product's operands rounded to float8 e4m3 and its incoming gradient to
e5m2, each on one scale a tensor, the products taken in f32).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def leaf_specs(config: dict):
    d, v, l = config["n_embd"], config["n_vocab"], config["n_ctx"]
    m = d * config["mlp_ratio"]
    specs = [("embed", (v, d), ("normal", 0.02)), ("pos_embed", (l, d), ("normal", 0.02))]
    for i in range(config["n_layer"]):
        specs += [
            (f"blocks/{i}/ln1", (d,), ("ones",)),
            (f"blocks/{i}/wqkv", (d, 3 * d), ("normal", 1.0 / math.sqrt(d))),
            (f"blocks/{i}/wo", (d, d), ("normal", 1.0 / math.sqrt(d))),
            (f"blocks/{i}/ln2", (d,), ("ones",)),
            (f"blocks/{i}/w_up", (d, m), ("normal", 1.0 / math.sqrt(d))),
            (f"blocks/{i}/w_down", (m, d), ("normal", 1.0 / math.sqrt(m))),
        ]
    specs.append(("out_norm", (d,), ("ones",)))
    return specs


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = E4M3_MAX) -> torch.Tensor:
    """``x`` rounded to an fp8 format on one scale."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8MatMul(torch.autograd.Function):
    """``a @ b`` on e4m3 operands; the backward's products take the
    incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _fp8(a), _fp8(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2, E5M2_MAX)
        return gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to 10 mantissa bits (nearest, ties to even), the
    gradient passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    keep = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (keep.view(torch.float32) - x.detach())


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        if b.dim() == 2:  # a weight: the product over every leading row at once
            out = _Fp8MatMul.apply(a.reshape(-1, a.shape[-1]), b)
            return out.reshape(tuple(a.shape[:-1]) + (b.shape[-1],))
        return _Fp8MatMul.apply(a, b)
    if precision == "tf32":
        a, b = _tf32(a), _tf32(b)
    return a @ b


def _rms(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6) * g


def forward(config: dict, p: Dict[str, torch.Tensor], tokens: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """int tokens ``[B, T]`` -> f32 logits ``[B, T, vocab]``."""
    b, t = tokens.shape
    h, d = config["n_head"], config["n_embd"]
    hd = d // h
    tok = tokens.long()
    x = p["embed"][tok] + p["pos_embed"][:t][None]
    mask = torch.ones((t, t), dtype=torch.bool, device=tokens.device).triu(1)
    for i in range(config["n_layer"]):
        blk = lambda n: p[f"blocks/{i}/{n}"]  # noqa: E731
        a = _rms(x, blk("ln1"))
        q, k, v = _mm(a, blk("wqkv"), precision).split(d, dim=-1)
        q, k, v = (z.reshape(b, t, h, hd).transpose(1, 2) for z in (q, k, v))
        s = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
        s = s.masked_fill(mask, float("-inf"))
        o = _mm(torch.softmax(s, dim=-1), v, precision)
        x = x + _mm(o.transpose(1, 2).reshape(b, t, d), blk("wo"), precision)
        a = _rms(x, blk("ln2"))
        x = x + _mm(F.gelu(_mm(a, blk("w_up"), precision), approximate="tanh"),
                    blk("w_down"), precision)
    x = _rms(x, p["out_norm"])
    return _mm(x, p["embed"].t(), precision)


def loss_and_grads(config: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   precision: str = "f32", chunk_tokens: int = 4096
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The mean next-token loss over ``tokens [B, T]`` and its gradient,
    a block of sequences at a time (the sum of each block's summed loss
    over the whole count), so that it fits beside nothing else."""
    b, t = tokens.shape
    count = b * (t - 1)
    rows = max(1, chunk_tokens // t)
    leaves = {k: v.detach().float().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total = 0.0
    for lo in range(0, b, rows):
        tok = tokens[lo:lo + rows]
        with torch.enable_grad():
            logits = forward(config, leaves, tok, precision)
            nll = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                  tok[:, 1:].reshape(-1).long(), reduction="sum")
            part = nll / count
            g = torch.autograd.grad(part, list(leaves.values()))
        for k, gi in zip(leaves, g):
            grads[k] += gi
        total += float(part.detach())
        del logits, nll, part, g
    return total, grads
