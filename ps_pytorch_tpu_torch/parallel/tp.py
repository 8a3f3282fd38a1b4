"""Tensor (model) parallelism for the transformer family (the port of
parallel/tp.py).

The Megatron split, on a stacked ``WorkerAxis(n)`` of shards on the one
device (ROADMAP "Workers"): a sharded leaf carries a leading ``[n, ...]``
shard dim, a replicated leaf is one tensor that every shard reads, and a
``psum`` over the shards is ``WorkerAxis.psum``.

- attention: heads sharded. ``wqkv`` is stored ``[D, 3, H, hd]`` and cut
  on H, so every shard computes full attention for its own heads;
  ``wo`` is stored ``[H, hd, D]`` (row-parallel) and the output
  projection ends in one psum.
- MLP: ``w_up`` column-cut ``[D, M/n]`` (independent GELUs), ``w_down``
  row-cut ``[M/n, D]``, one psum after the down-projection.
- embeddings: replicated, or with ``shard_vocab`` the embedding ``[V,
  D]`` cut over the shards (vocab-parallel): the lookup masks the ids a
  shard does not own and psums the partial embeddings, the logits stay
  LOCAL ``[n, .., V/n]`` and the loss is ``vocab_parallel_nll``. Norms
  stay replicated.

``tp_param_specs`` names the dim of the global TP-layout tensor that each
leaf is cut on (None: replicated); ``shard_params_tp`` /
``unshard_params_tp`` go between the global layout and the stacked one.

Gradient rule (tp.py:343-358 of the JAX package): JAX differentiates
``loss / n`` on every shard and then psums the replicated leaves'
gradients. Here all shards run in one program over stacked tensors, the
loss is one scalar, and one backward gives the same sums: a replicated
leaf is read by every shard, so its gradient collects every shard's
part. The two differ only in f32 summation order.

Attention runs once a block over all shards' local heads: the shard dim
folds into the batch (``[n * B, T, H / n, hd]``), so under
``attention_impl="flash"`` a step launches K4 once a block (twice with
remat, which recomputes the forward) and K5 and K6 once a block each.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, resolve_device
from ..ops.metrics import next_token_positions_nll
from .buckets import tree_flatten, tree_unflatten
from .mesh import WorkerAxis, place_on_mesh

# ..models.transformer imports this package (mesh, ring_attention), so it
# is imported inside the functions that use it, as the JAX module does

TP_AXIS = "model"


def make_tp_mesh(num_shards: int) -> WorkerAxis:
    """The tensor-parallel axis: ``num_shards`` stacked shards."""
    return WorkerAxis(num_shards)


def to_tp_layout(cfg, params: Dict) -> Dict:
    """Re-layout plain transformer params for head / column sharding:
    ``wqkv [D, 3D] -> [D, 3, H, hd]``, ``wo [D, D] -> [H, hd, D]``;
    ``w_up [D, M]`` and ``w_down [M, D]`` stay."""
    h, hd = cfg.heads, cfg.head_dim
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = []
    for blk in params["blocks"]:
        b = dict(blk)
        b["wqkv"] = blk["wqkv"].reshape(cfg.dim, 3, h, hd)
        b["wo"] = blk["wo"].reshape(h, hd, cfg.dim)
        out["blocks"].append(b)
    return out


def from_tp_layout(cfg, params_tp: Dict) -> Dict:
    """Inverse of ``to_tp_layout`` (checkpoint interchange)."""
    out = {k: v for k, v in params_tp.items() if k != "blocks"}
    out["blocks"] = []
    for blk in params_tp["blocks"]:
        b = dict(blk)
        b["wqkv"] = blk["wqkv"].reshape(cfg.dim, 3 * cfg.dim)
        b["wo"] = blk["wo"].reshape(cfg.dim, cfg.dim)
        out["blocks"].append(b)
    return out


def tp_param_specs(cfg, shard_vocab: bool = False) -> Dict:
    """The dim of each global TP-layout leaf that the shards cut (None:
    replicated), the tree of ``to_tp_layout``'s output."""
    blk = {"ln1": None, "wqkv": 2, "wo": 0, "ln2": None, "w_up": 1, "w_down": 0}
    return {
        "embed": 0 if shard_vocab else None,
        "pos_embed": None,
        "out_norm": None,
        "blocks": [dict(blk) for _ in range(cfg.depth)],
    }


def _map_specs(fn, params: Dict, specs: Dict) -> Dict:
    """``fn(leaf, dim)`` over a params tree and its spec tree."""
    out = {k: fn(v, specs[k]) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: fn(v, sb[k]) for k, v in b.items()}
                     for b, sb in zip(params["blocks"], specs["blocks"])]
    return out


def shard_params_tp(cfg, params_tp: Dict, mesh: WorkerAxis,
                    shard_vocab: bool = False) -> Dict:
    """A global TP-layout tree -> the stacked one: each cut leaf ``[n,
    ...]`` (shard i holds the i-th of n equal slices of its dim), the
    replicated leaves as they are."""
    n = mesh.size
    if cfg.heads % n:
        raise ValueError(f"heads {cfg.heads} not divisible by {n} model shards")
    if (cfg.dim * cfg.mlp_ratio) % n:
        raise ValueError(
            f"mlp dim {cfg.dim * cfg.mlp_ratio} not divisible by {n} model shards")
    if shard_vocab and cfg.vocab_size % n:
        raise ValueError(f"vocab {cfg.vocab_size} not divisible by {n} model shards")

    return place_on_mesh(params_tp, mesh, tp_param_specs(cfg, shard_vocab))


def unshard_params_tp(cfg, params: Dict, shard_vocab: bool = False) -> Dict:
    """Inverse of ``shard_params_tp``: the stacked tree -> the global
    TP layout (``from_tp_layout`` of it is the plain model)."""

    def join(x, dim):
        return x if dim is None else torch.cat(list(x.unbind(0)), dim=dim)

    return _map_specs(join, params, tp_param_specs(cfg, shard_vocab))


def _shard_psum(y: torch.Tensor, axis: WorkerAxis) -> torch.Tensor:
    """The psum over the shards of ``y [..., n, N T, D]`` (dim -3):
    ``axis.psum`` over the shard dim moved to the front, the same sum in
    the same order."""
    return axis.psum(y.movedim(-3, 0))


def tp_block(cfg, x: torch.Tensor, blk: Dict, attend, axis: WorkerAxis) -> torch.Tensor:
    """One Megatron block on every shard at once, over any leading dims
    (none for tp, the stages for dp_tp_pp): activations ``x [..., N, T,
    D]`` (one tensor that every shard reads), norms ``[..., D]``, each cut
    leaf ``[..., n, ...]`` (``shard_params_tp``'s slices). The shards'
    heads fold into the batch of one attention call, and each of the two
    psums is ``axis.psum`` over the shard dim (``axis`` the tp axis)."""
    from ..models.transformer import _rms_norm

    cd = cfg.effective_compute_dtype
    x = x.to(cd)
    blk = {k: v.to(cd) for k, v in blk.items()}  # cast at use
    *lead, b, t, d = x.shape
    n = blk["wqkv"].shape[len(lead)]
    hl, hd = cfg.heads // n, cfg.head_dim

    def norm(y, gamma):  # -> [..., 1, N T, D], read by every shard
        return _rms_norm(y, gamma.reshape(lead + [1, 1, d])).reshape(lead + [1, b * t, d])

    qkv = torch.matmul(norm(x, blk["ln1"]), blk["wqkv"].reshape(lead + [n, d, 3 * hl * hd]))
    q, k, v = qkv.reshape(-1, t, 3, hl, hd).unbind(2)  # shards fold into B
    o = attend(q, k, v).reshape(lead + [n, b * t, hl * hd])  # local heads only
    proj = torch.matmul(o, blk["wo"].reshape(lead + [n, hl * hd, d]))
    x = x + _shard_psum(proj, axis).reshape(x.shape)
    up = F.gelu(torch.matmul(norm(x, blk["ln2"]), blk["w_up"]), approximate="tanh")
    return x + _shard_psum(torch.matmul(up, blk["w_down"]), axis).reshape(x.shape)


def apply_transformer_tp(cfg, params: Dict, tokens: torch.Tensor, axis: WorkerAxis,
                         shard_vocab: bool = False) -> torch.Tensor:
    """Forward of every shard at once: stacked TP-layout params, int
    tokens ``[..., T]`` (read by every shard) -> logits ``[..., T, V]``,
    or with ``shard_vocab`` each shard's LOCAL logits ``[n, ..., T, V/n]``
    (feed them to ``vocab_parallel_nll``; the full logits never exist).

    ``models/transformer.apply_transformer`` with the Megatron split:
    every activation entering or leaving a block is one tensor, so the
    result is the plain model's up to summation order."""
    from ..models.transformer import _rms_norm, local_attention

    n = axis.size
    lead, t = tuple(tokens.shape[:-1]), tokens.shape[-1]
    tok = tokens.reshape(-1, t).long()
    b, d = tok.shape[0], cfg.dim
    pos = torch.arange(t, device=tok.device)
    if shard_vocab:
        # shard i owns ids [i * v_loc, (i + 1) * v_loc); the others'
        # rows add zero and the psum completes the embedding
        table = params["embed"]  # [n, V/n, D]
        v_loc = table.shape[1]
        off = axis.axis_index(tok.device)[:, None, None] * v_loc
        mine = (tok >= off) & (tok < off + v_loc)  # [n, B, T]
        rows = table[torch.arange(n, device=tok.device)[:, None, None],
                     (tok - off).clamp(0, v_loc - 1)]
        emb = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
        x = axis.psum(emb) + params["pos_embed"][pos][None]
    else:
        x = params["embed"][tok] + params["pos_embed"][pos][None]
    cd = cfg.effective_compute_dtype
    attend = local_attention(cfg)
    for blk in params["blocks"]:
        if cfg.remat:
            x = checkpoint(tp_block, cfg, x, blk, attend, axis, use_reentrant=False)
        else:
            x = tp_block(cfg, x, blk, attend, axis)
    xf = _rms_norm(x.to(cd), params["out_norm"].to(cd))
    # tied unembedding: each shard's vocab rows only when sharded
    emb = params["embed"].to(cd)
    if shard_vocab:
        logits = torch.matmul(xf.reshape(1, b * t, d), emb.transpose(1, 2))
        return logits.reshape((n,) + lead + (t, -1))
    return (xf @ emb.T).reshape(lead + (t, -1))


def vocab_parallel_positions_nll(logits_local: torch.Tensor, tokens: torch.Tensor,
                                 axis: WorkerAxis) -> torch.Tensor:
    """Each position's next-token NLL ``[..., T - 1]`` from vocab-cut
    logits ``[n, ..., T, V/n]``: the row max crosses the shards as a
    gathered max under stop-gradient (exact: its gradient cancels in m +
    log sum exp(lg - m)), the exp-sum and the owner shard's target logit
    as psums."""
    n = axis.size
    lg = logits_local[..., :-1, :].float()
    tgt = tokens[..., 1:].long()
    v_loc = lg.shape[-1]
    off = axis.axis_index(lg.device).reshape((n,) + (1,) * tgt.dim()) * v_loc
    m = lg.amax(-1).amax(0).detach()
    z = axis.psum(torch.exp(lg - m[..., None]).sum(-1))
    mine = (tgt >= off) & (tgt < off + v_loc)
    picked = lg.gather(-1, (tgt - off).clamp(0, v_loc - 1)[..., None])[..., 0]
    tgt_logit = axis.psum(torch.where(mine, picked, torch.zeros((), device=lg.device)))
    return m + torch.log(z) - tgt_logit


def vocab_parallel_nll(logits_local: torch.Tensor, tokens: torch.Tensor,
                       axis: WorkerAxis) -> torch.Tensor:
    """Mean next-token NLL over vocab-cut logits (Megatron-style): equals
    ``ops.metrics.next_token_nll`` on the gathered logits up to
    summation order."""
    return vocab_parallel_positions_nll(logits_local, tokens, axis).mean()


def lm_positions_nll(cfg, params: Dict, tokens: torch.Tensor, axis: WorkerAxis,
                     shard_vocab: bool = False) -> torch.Tensor:
    """The forward and each position's next-token NLL ``[..., T - 1]``."""
    logits = apply_transformer_tp(cfg, params, tokens, axis, shard_vocab)
    if shard_vocab:
        return vocab_parallel_positions_nll(logits, tokens, axis)
    return next_token_positions_nll(logits, tokens)


def make_tp_forward(cfg, mesh: WorkerAxis, shard_vocab: bool = False):
    """Tensor-parallel forward: (stacked params, tokens ``[B, T]``) ->
    logits ``[B, T, V]`` (with ``shard_vocab`` the shards' local logits
    joined on the vocab dim)."""

    def forward(params, tokens):
        logits = apply_transformer_tp(cfg, params, tokens, mesh, shard_vocab)
        return torch.cat(list(logits.unbind(0)), dim=-1) if shard_vocab else logits

    return forward


def init_tp_state(cfg, tx, generator: Optional[torch.Generator], mesh: WorkerAxis,
                  shard_vocab: bool = False, device: DeviceLike = None):
    """(stacked params, optimizer state): momentum buffers take their
    parameters' shapes, so they are cut exactly like them. The weights
    come from ``init_transformer`` (a ``torch.Generator``)."""
    from ..models.transformer import init_transformer

    params = shard_params_tp(cfg, to_tp_layout(
        cfg, init_transformer(cfg, generator, device=resolve_device(device))), mesh,
        shard_vocab)
    return params, tx.init(params)


def differentiate(loss_fn, tx, params, opt_state, tokens, has_aux: bool = False):
    """One optimizer step on the gradient of ``loss_fn(params, tokens)``
    (a scalar): one backward, then ``tx.update``. Returns (params,
    opt_state, loss); with ``has_aux`` ``loss_fn`` returns (scalar,
    extras) and the step returns (params, opt_state, extras), detached."""
    from ..optim import apply_updates

    leaves, skeleton = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(tree_unflatten(skeleton, leaves), tokens)
    loss, extras = loss if has_aux else (loss, None)
    grads = tree_unflatten(skeleton, list(torch.autograd.grad(loss, leaves)))
    updates, new_opt = tx.update(grads, opt_state, params)
    if has_aux:
        return apply_updates(params, updates), new_opt, tuple(x.detach() for x in extras)
    return apply_updates(params, updates), new_opt, loss.detach()


def make_tp_train_step(cfg, tx, mesh: WorkerAxis, shard_vocab: bool = False):
    """The TP LM train step: (stacked params, opt_state, tokens ``[B, T]``)
    -> (params, opt_state, loss). Sharded leaves' gradients are local, so
    the update is shard-wise; the in-block psums are the only collectives.
    With ``shard_vocab`` the embedding and loss run vocab-parallel."""

    def loss_fn(params, tokens):
        return lm_positions_nll(cfg, params, tokens, mesh, shard_vocab).mean()

    def step(params, opt_state, tokens):
        return differentiate(loss_fn, tx, params, opt_state, tokens)

    return step
