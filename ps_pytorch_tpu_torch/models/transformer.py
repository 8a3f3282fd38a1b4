"""Transformer LM (the port of models/transformer.py).

The JAX tree's names and ``[in, out]`` matrix layouts are kept
(``embed [V, D]``, ``pos_embed [L, D]``, per block ``ln1``, ``wqkv
[D, 3D]``, ``wo [D, D]``, ``ln2``, ``w_up [D, M]``, ``w_down [M, D]``,
then ``out_norm``), so carrying weights across (models/convert.py) is a
copy, not a transpose, and ``x @ w`` reads the same on both sides.

Functions take a params tree (nested dict/list of tensors), which is
what training differentiates (parallel/dp_sp.py); ``TransformerLM``
wraps one as an ``nn.Module`` for serving. With a sequence axis (a
``WorkerAxis``), ``apply_transformer`` runs on stacked sequence shards
``[n, B, T_loc]``: every op but attention is pointwise over the sequence
and runs on the local shards, positions index by the global offset, and
attention is the ring or Ulysses over the axis (``select_attention``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, on_device, resolve_device
from ..parallel.mesh import WorkerAxis
from ..parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_flash_attention,
    shard_sequence,
    unshard_sequence,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    dim: int = 128
    depth: int = 2
    heads: int = 4
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    causal: bool = True
    dtype: Any = torch.float32
    # recompute each block's activations in backward
    # (torch.utils.checkpoint): ~1/3 more work for O(1) activations in depth
    remat: bool = False
    # rotate K/V both ways on the sequence ring (parallel/ring_attention)
    bidirectional_ring: bool = False
    # sequence-parallel scheme: "ring" or "ulysses" (heads % n == 0)
    sp_attention: str = "ring"
    # within-device attention: "naive" (materializes [T, T]) or "flash"
    # (kernels K4-K6, ops/flash_attention.py); on an sp "ring" it selects
    # ring_flash_attention (the partial-triple kernel per hop), on
    # "ulysses" the attention over the gathered sequence
    attention_impl: str = "naive"
    # block math runs in compute_dtype (None = dtype); weights are cast
    # where they are used, never at init
    compute_dtype: Any = None

    @property
    def effective_compute_dtype(self):
        return self.compute_dtype if self.compute_dtype is not None else self.dtype

    @property
    def head_dim(self) -> int:
        if self.dim % self.heads:
            raise ValueError(f"dim {self.dim} is not divisible by heads {self.heads}")
        return self.dim // self.heads


def _normal(generator: torch.Generator, shape, scale: float, dtype):
    return (torch.randn(shape, generator=generator) * scale).to(dtype)


def init_transformer(cfg: TransformerConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Dict:
    """Random params with the JAX init's scales (embeddings N(0, 0.02),
    dense N(0, 1/fan_in), norms 1). ``generator`` is a CPU
    ``torch.Generator``; the values differ from ``jax.random``'s."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    mlp_dim = cfg.dim * cfg.mlp_ratio
    dense = lambda shape: _normal(g, shape, 1.0 / (shape[0] ** 0.5), cfg.dtype)
    params = {
        "embed": _normal(g, (cfg.vocab_size, cfg.dim), 0.02, cfg.dtype),
        "pos_embed": _normal(g, (cfg.max_seq_len, cfg.dim), 0.02, cfg.dtype),
        "blocks": [],
        "out_norm": torch.ones((cfg.dim,), dtype=cfg.dtype),
    }
    for _ in range(cfg.depth):
        params["blocks"].append({
            "ln1": torch.ones((cfg.dim,), dtype=cfg.dtype),
            "wqkv": dense((cfg.dim, 3 * cfg.dim)),
            "wo": dense((cfg.dim, cfg.dim)),
            "ln2": torch.ones((cfg.dim,), dtype=cfg.dtype),
            "w_up": dense((cfg.dim, mlp_dim)),
            "w_down": dense((mlp_dim, cfg.dim)),
        })
    return on_device(params, dev)


def _rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * gamma


def local_attention(cfg: TransformerConfig):
    """The within-device attention callable: kernel K4 or the naive
    reference."""
    if cfg.attention_impl == "flash":
        from ..ops.flash_attention import flash_attention

        return partial(flash_attention, causal=cfg.causal)
    if cfg.attention_impl == "naive":
        return partial(full_attention, causal=cfg.causal)
    raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


def select_attention(cfg: TransformerConfig, seq_axis: Optional[WorkerAxis] = None):
    """The attention callable for this config — the one selection point.

    ``seq_axis=None``: within-device (naive or flash). Otherwise the
    sequence-parallel scheme (``cfg.sp_attention``) over that axis: the
    ring (plain, or flash per hop under ``attention_impl="flash"``,
    one-way or bidirectional) or Ulysses. The callable takes the blocks'
    ``[n * B, T_loc, H, hd]`` (shard-major stacked batch) and views it as
    the ``[n, B, T_loc, H, hd]`` shards the scheme works on."""
    if seq_axis is None:
        return local_attention(cfg)
    if cfg.sp_attention == "ulysses":
        from ..parallel.ulysses import ulysses_attention

        scheme = partial(ulysses_attention, axis=seq_axis, causal=cfg.causal,
                         impl=cfg.attention_impl)
    elif cfg.sp_attention == "ring":
        if cfg.attention_impl not in ("naive", "flash"):
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
        ring = ring_flash_attention if cfg.attention_impl == "flash" else ring_attention
        scheme = partial(ring, axis=seq_axis, causal=cfg.causal,
                         bidirectional=cfg.bidirectional_ring)
    else:
        raise ValueError(f"unknown sp_attention {cfg.sp_attention!r}")
    n = seq_axis.size

    def attend(q, k, v):
        split = lambda x: x.reshape((n, -1) + tuple(x.shape[1:]))
        o = scheme(split(q), split(k), split(v))
        return o.reshape((-1,) + tuple(o.shape[2:]))

    return attend


def transformer_block(cfg: TransformerConfig, x, blk, attend, mlp=None):
    """One pre-norm block: attention + tanh-GELU MLP, both residual.
    ``attend`` maps ``([B,T,H,hd],)*3 -> [B,T,H,hd]``."""
    cd = cfg.effective_compute_dtype
    x = x.to(cd)
    blk = {k: v.to(cd) for k, v in blk.items()}
    b, t = x.shape[0], x.shape[1]
    h = _rms_norm(x, blk["ln1"])
    qkv = h @ blk["wqkv"]
    q, k, v = qkv.split(cfg.dim, dim=-1)
    split_heads = lambda a: a.reshape(b, t, cfg.heads, cfg.head_dim)
    o = attend(split_heads(q), split_heads(k), split_heads(v))
    x = x + o.reshape(b, t, cfg.dim) @ blk["wo"]
    h = _rms_norm(x, blk["ln2"])
    if mlp is not None:
        return x + mlp(h)
    # jax.nn.gelu defaults to the tanh approximation
    return x + F.gelu(h @ blk["w_up"], approximate="tanh") @ blk["w_down"]


def apply_transformer(cfg: TransformerConfig, params: Dict,
                      tokens: torch.Tensor,
                      seq_axis: Optional[WorkerAxis] = None,
                      pos_offset: Optional[int] = None) -> torch.Tensor:
    """Forward: int tokens ``[B, T]`` -> logits ``[B, T, vocab]``.

    With ``seq_axis``, tokens are the stacked sequence shards ``[n, B,
    T_loc]`` of that axis's n workers and the logits come back ``[n, B,
    T_loc, vocab]``: positional embeddings index by GLOBAL position
    (worker i's shard starts at ``i * T_loc``, transformer.py:207-215) and
    attention runs over the axis."""
    attend = select_attention(cfg, seq_axis)
    shard = 0 if pos_offset is None else int(pos_offset)
    if seq_axis is None:
        t = tokens.shape[1]
        pos = torch.arange(shard, shard + t, device=tokens.device)
        x = params["embed"][tokens] + params["pos_embed"][pos][None]
    else:
        seq_axis._check(tokens)
        n, b, t = tokens.shape
        pos = (seq_axis.axis_index(tokens.device)[:, None] * t + shard
               + torch.arange(t, device=tokens.device))  # [n, T_loc]
        x = params["embed"][tokens] + params["pos_embed"][pos][:, None]
        x = x.reshape(n * b, t, cfg.dim)

    def block(x, blk):
        return transformer_block(cfg, x, blk, attend)

    for blk in params["blocks"]:
        if cfg.remat:
            # the block's activations (the ring's forward included) are
            # recomputed in backward (jax.checkpoint, transformer.py:221)
            x = checkpoint(block, x, blk, use_reentrant=False)
        else:
            x = block(x, blk)
    cd = cfg.effective_compute_dtype
    xf = _rms_norm(x.to(cd), params["out_norm"].to(cd))
    logits = xf @ params["embed"].T.to(cd)
    if seq_axis is not None:
        logits = logits.reshape(n, b, t, -1)
    return logits


def make_sp_forward(cfg: TransformerConfig, axis: WorkerAxis):
    """Sequence-parallel forward (transformer.py:231): params replicated,
    global tokens ``[B, T]`` split into stacked shards over ``axis``,
    logits ``[B, T, vocab]`` gathered back."""

    def forward(params, tokens):
        shards = shard_sequence(tokens, axis)
        return unshard_sequence(apply_transformer(cfg, params, shards, seq_axis=axis),
                                axis)

    return forward


class _Block(nn.Module):
    def __init__(self, blk: Dict[str, torch.Tensor]):
        super().__init__()
        for name, value in blk.items():
            setattr(self, name, nn.Parameter(value, requires_grad=False))


class TransformerLM(nn.Module):
    """``nn.Module`` holding one params tree, forward = ``apply_transformer``.

    A serving wrapper: its parameters are frozen (``requires_grad=False``)
    and the engine reads them as one flat buffer. Training differentiates
    the functional params tree instead (``parallel/dp_sp.py``), as the JAX
    package's optax step does, so this module never needs gradients."""

    def __init__(self, cfg: TransformerConfig, params: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = init_transformer(cfg, generator, device=dev)
        params = on_device(params, dev)
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.pos_embed = nn.Parameter(params["pos_embed"], requires_grad=False)
        self.out_norm = nn.Parameter(params["out_norm"], requires_grad=False)
        self.blocks = nn.ModuleList(_Block(b) for b in params["blocks"])

    def params(self) -> Dict:
        """The params tree (the module's own tensors, no copies)."""
        return {
            "embed": self.embed,
            "pos_embed": self.pos_embed,
            "blocks": [
                {k: getattr(b, k) for k in ("ln1", "wqkv", "wo", "ln2",
                                             "w_up", "w_down")}
                for b in self.blocks
            ],
            "out_norm": self.out_norm,
        }

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply_transformer(self.cfg, self.params(), tokens)
