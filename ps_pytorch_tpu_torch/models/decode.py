"""Autoregressive decoding with a KV cache (the port of models/decode.py),
dense and MoE models.

The cache is a pair of ``[depth, B, max_len, H, hd]`` buffers, updated in
place (the JAX version threads immutable buffers through a scan; here a
write is a slice assignment and the loop is a Python loop). Attention
over the cache masks positions >= the current length.

``generate`` is the per-sequence oracle the serving engine is pinned
against: greedy, or temperature sampling driven by a ``torch.Generator``.
With ``moe`` (a ``parallel.moe.MoEConfig``) each block's MLP is the
all-experts-local mixture, at JAX's roomy capacity (``capacity_factor =
num_experts``), so no decode token is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import DeviceLike, on_device, resolve_device
from .transformer import (
    TransformerConfig,
    _rms_norm,
    select_attention,
    transformer_block,
)

NEG_INF = -1e30


def init_kv_cache(cfg: TransformerConfig, batch: int,
                  max_len: Optional[int] = None,
                  device: DeviceLike = None) -> Dict:
    """Zeroed ``[depth, B, L, H, hd]`` K/V buffers (compute dtype)."""
    dev = resolve_device(device)
    L = max_len or cfg.max_seq_len
    shape = (cfg.depth, batch, L, cfg.heads, cfg.head_dim)
    cd = cfg.effective_compute_dtype
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev)}


def _attend_cached(q, k_cache, v_cache, length, scale):
    """q ``[B, 1, H, hd]`` against cache ``[B, L, H, hd]``; positions >=
    length masked. ``length`` is an int (shared position) or an int
    tensor ``[B]`` (the serving pool's per-slot lengths).

    f32 scores and softmax whatever the cache dtype; p is cast to the
    cache dtype before the PV product (decode.py:55-70). Operands are
    upcast to f32 for the products: a product of two bf16 values is exact
    in f32, which is the JAX einsum's preferred_element_type=f32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    if isinstance(length, torch.Tensor):
        length = length.reshape(-1, 1, 1, 1)
    scores = torch.where(
        pos[None, None, None, :] < length, scores,
        torch.full((), NEG_INF, device=q.device),
    )
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v_cache.dtype).float(), v_cache.float()
    )
    return out.to(q.dtype)


def _moe_mlps(params: Dict, moe) -> list:
    """Each block's MLP for ``transformer_block``: None (dense), or the
    all-experts-local MoE mixture at JAX's roomy decode capacity
    (decode.py:94-118 there)."""
    if moe is None:
        return [None] * len(params["blocks"])
    from ..parallel.moe import moe_mlp_local

    roomy = dataclasses.replace(moe, capacity_factor=float(moe.num_experts))
    return [lambda h, _blk=blk: moe_mlp_local(h, _blk, roomy, None)[0]
            for blk in params["blocks"]]


def _attention_leaves(blk: Dict, moe) -> Dict:
    """The leaves ``transformer_block`` reads: all of a dense block's, the
    attention ones of a MoE block (its MLP casts the experts itself)."""
    if moe is None:
        return blk
    from ..parallel.moe import ATTENTION_LEAVES

    return {k: blk[k] for k in ATTENTION_LEAVES}


def _decode_one(cfg: TransformerConfig, params: Dict, cache: Dict,
                token: torch.Tensor, pos: int, moe=None) -> Tuple[torch.Tensor, Dict]:
    """One token ``[B]`` at position ``pos`` -> (f32 logits ``[B, V]``,
    the cache, written in place at ``pos``)."""
    cd = cfg.effective_compute_dtype
    x = (params["embed"][token] + params["pos_embed"][pos][None]).to(cd)
    x = x[:, None]  # [B, 1, D]
    scale = 1.0 / (cfg.head_dim ** 0.5)
    k_buf, v_buf = cache["k"], cache["v"]
    for i, (blk, mlp) in enumerate(zip(params["blocks"], _moe_mlps(params, moe))):

        def attend(q, k, v, _i=i):
            k_buf[_i, :, pos] = k[:, 0].to(k_buf.dtype)
            v_buf[_i, :, pos] = v[:, 0].to(v_buf.dtype)
            return _attend_cached(q, k_buf[_i], v_buf[_i], pos + 1, scale)

        x = transformer_block(cfg, x, _attention_leaves(blk, moe), attend, mlp=mlp)
    xf = _rms_norm(x[:, 0].to(cd), params["out_norm"].to(cd))
    logits = xf @ params["embed"].T.to(cd)
    return logits.float(), cache


def prefill(cfg: TransformerConfig, params: Dict, prompt: torch.Tensor,
            cache: Dict, moe=None) -> Dict:
    """Fill cache positions ``[0, T)`` for a ``[B, T]`` prompt in ONE
    batched causal forward; attention follows ``cfg.attention_impl`` (so
    a flash config prefills through kernel K4)."""
    t = prompt.shape[1]
    cd = cfg.effective_compute_dtype
    pos = torch.arange(t, device=prompt.device)
    x = (params["embed"][prompt] + params["pos_embed"][pos][None]).to(cd)
    base_attend = select_attention(cfg, None)
    k_buf, v_buf = cache["k"], cache["v"]
    for i, (blk, mlp) in enumerate(zip(params["blocks"], _moe_mlps(params, moe))):

        def attend(q, k, v, _i=i):
            k_buf[_i, :, :t] = k.to(k_buf.dtype)
            v_buf[_i, :, :t] = v.to(v_buf.dtype)
            return base_attend(q, k, v)

        x = transformer_block(cfg, x, _attention_leaves(blk, moe), attend, mlp=mlp)
    return cache


@torch.no_grad()
def generate(
    cfg: TransformerConfig,
    params: Dict,
    prompt: torch.Tensor,  # int [B, T_prompt]
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    device: DeviceLike = None,
    moe=None,
) -> torch.Tensor:
    """Greedy (temperature 0) or temperature-sampled continuation ->
    int32 ``[B, T_prompt + max_new_tokens]`` on ``device``. The prompt
    minus its last token is prefilled in one batched forward; the last
    prompt token goes through the decode step, which writes its K/V and
    yields the first new token. Sampling draws from ``generator`` (a
    generator on ``device``). ``moe`` decodes a MoE checkpoint (every
    expert local, no token dropped)."""
    if not cfg.causal:
        raise ValueError("generate() is autoregressive: cfg.causal must be True")
    dev = resolve_device(device)
    params = on_device(params, dev)
    prompt = torch.as_tensor(prompt).to(dev, torch.long)
    b, t_prompt = prompt.shape
    L = max_len or cfg.max_seq_len
    total = t_prompt + max_new_tokens
    if total > L:
        raise ValueError(f"prompt {t_prompt} + new {max_new_tokens} > {L}")
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")

    cache = init_kv_cache(cfg, b, L, device=dev)
    if t_prompt > 1:
        cache = prefill(cfg, params, prompt[:, : t_prompt - 1], cache, moe=moe)
    buf = torch.zeros((b, total), dtype=torch.long, device=dev)
    buf[:, :t_prompt] = prompt
    for pos in range(t_prompt - 1, total - 1):
        logits, cache = _decode_one(cfg, params, cache, buf[:, pos], pos, moe=moe)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)  # first maximum, as jnp
        buf[:, pos + 1] = nxt
    return buf.to(torch.int32)
