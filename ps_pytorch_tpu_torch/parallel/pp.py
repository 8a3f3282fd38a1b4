"""Pipeline (stage) parallelism for the transformer family (the port of
parallel/pp.py), GPipe on a stacked ``WorkerAxis(S)`` of stages on the
one device.

- The blocks are stacked into ``[depth, ...]`` leaves (``to_pp_layout``);
  stage s owns the contiguous ``depth / S`` blocks ``[s depth / S, (s +
  1) depth / S)``, so the stage grid ``[S, depth / S, ...]`` is a view.
- The batch is cut into M microbatches and the schedule runs M + S - 1
  ticks (``gpipe_fold``). Each tick ``ppermute``s every stage's last
  activation one stage on, stage 0 injects the next microbatch's
  embedding, every stage runs its blocks, and the last stage's output
  for a finished microbatch goes into the loss.
- Every stage's blocks run every tick, bubbles included (their outputs
  reach no loss), as JAX's uniform loop does (pp.py:1-25, 108-170
  there). In stacked form all S stages run a tick's j-th local block in
  one call: the stages fold into the batch of one attention call
  (``[S * B / M, T, H, hd]``). Under ``attention_impl="flash"`` a step
  launches K4 ``(M + S - 1) * depth / S`` times (twice that with remat,
  which recomputes the forward) and K5 and K6 that many times each.
- Embeddings, norms and the unembedding are replicated (one tensor).

Gradient rule: JAX differentiates ``loss / S`` on every stage and psums
the replicated leaves' gradients (the rule of parallel/tp.py). Here the
loss is one scalar and one backward gives the same sums, in another f32
order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, resolve_device
from ..ops.metrics import next_token_nll
from .mesh import WorkerAxis
from .tp import differentiate

PP_AXIS = "stage"


def make_pp_mesh(num_stages: int) -> WorkerAxis:
    """The pipeline axis: ``num_stages`` stacked stages."""
    return WorkerAxis(num_stages)


def to_pp_layout(cfg, params: Dict) -> Dict:
    """Stack the per-block param dicts into ``[depth, ...]`` leaves."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: torch.stack([blk[k] for blk in params["blocks"]])
                     for k in params["blocks"][0]}
    return out


def from_pp_layout(cfg, params_pp: Dict) -> Dict:
    """Inverse of ``to_pp_layout`` (checkpoint interchange)."""
    out = {k: v for k, v in params_pp.items() if k != "blocks"}
    out["blocks"] = [{k: v[i] for k, v in params_pp["blocks"].items()}
                     for i in range(cfg.depth)]
    return out


def shard_params_pp(cfg, params_pp: Dict, mesh: WorkerAxis) -> Dict:
    """The stage grid of a PP-layout tree: the stacked ``[depth, ...]``
    leaves already are it (stage s reads rows ``[s depth / S, (s + 1)
    depth / S)``), so this checks that the depth splits and returns the
    tree."""
    if cfg.depth % mesh.size:
        raise ValueError(f"depth {cfg.depth} not divisible by {mesh.size} stages")
    return params_pp


def _stage_block(cfg, x: torch.Tensor, blk: Dict, attend, mlp=None) -> torch.Tensor:
    """``models/transformer.transformer_block`` on every stage at once:
    activations ``[S, b, T, D]``, each leaf ``[S, ...]`` that stage's
    block; the stages' rows share one attention call. ``mlp`` (the MoE
    schemes') replaces the dense MLP: normed ``[S, b, T, D]`` -> the
    same."""
    from ..models.transformer import _rms_norm

    cd = cfg.effective_compute_dtype
    x = x.to(cd)
    blk = {k: v.to(cd) for k, v in blk.items()}
    s, b, t, d = x.shape
    h = _rms_norm(x, blk["ln1"][:, None, None]).reshape(s, b * t, d)
    qkv = torch.matmul(h, blk["wqkv"])  # [S, b T, 3 D]
    q, k, v = qkv.reshape(s * b, t, 3, cfg.heads, cfg.head_dim).unbind(2)
    o = attend(q, k, v).reshape(s, b * t, d)
    x = x + torch.matmul(o, blk["wo"]).reshape(s, b, t, d)
    h = _rms_norm(x, blk["ln2"][:, None, None])
    if mlp is not None:
        return x + mlp(h)
    h = h.reshape(s, b * t, d)
    up = F.gelu(torch.matmul(h, blk["w_up"]), approximate="tanh")
    return x + torch.matmul(up, blk["w_down"]).reshape(s, b, t, d)


def gpipe_fold(axis: WorkerAxis, tokens: torch.Tensor, dim: int, cd,
               embed: Callable, run_local: Callable, mb_loss: Callable):
    """THE GPipe tick schedule (pp.py:108-170 there), shared by pp, pp_moe
    and dp_tp_pp: tokens ``[M, ...]`` (one entry a microbatch, e.g. ``[M,
    b, T]``, or ``[M, cols, b, T]`` for independent columns);
    ``embed(i)`` -> microbatch i's activations ``[..., T, dim]``;
    ``run_local(x)`` -> (every stage's blocks over ``x [S, ..., T, dim]``,
    each stage's aux ``[S, ...]``: the MoE load-balance sum over its
    blocks for pp_moe, None for the dense schemes); ``mb_loss(y, tok)`` ->
    one microbatch's loss (a scalar, or one a column).

    M + S - 1 ticks: each tick the stages' last activations move one
    stage on (a ``ppermute``), stage 0 takes the next microbatch
    (``embed(min(tick, M - 1))``), every stage runs, and the last stage's
    output of a finished microbatch goes into the loss. Stage s holds
    microbatch ``tick - s``, so its aux counts only where ``0 <= tick - s
    < M``: warm-up and drain ticks run garbage activations whose router
    statistics must not leak. Returns (the mean of the M microbatch
    losses, the aux summed over each stage's valid ticks ``[S, ...]``, or
    None when ``run_local`` gives none)."""
    n = axis.size
    m = tokens.shape[0]
    dev = tokens.device
    perm = [(j, (j + 1) % n) for j in range(n)]
    y = torch.zeros((n,) + tuple(tokens.shape[1:]) + (dim,), dtype=cd, device=dev)
    loss_sum = torch.zeros((), device=dev)
    valid = aux_sum = None
    for tk in range(m + n - 1):
        inbound = axis.ppermute(y, perm)
        y, aux = run_local(torch.cat([embed(min(tk, m - 1))[None], inbound[1:]]))
        if aux is not None:
            if valid is None:  # [ticks, S]: the microbatch stage s holds is valid
                held = torch.arange(m + n - 1, device=dev)[:, None] - torch.arange(n, device=dev)
                valid = (held >= 0) & (held < m)
            mine = valid[tk].reshape((n,) + (1,) * (aux.dim() - 1))
            aux = torch.where(mine, aux, torch.zeros((), dtype=aux.dtype, device=dev))
            aux_sum = aux if aux_sum is None else aux_sum + aux
        done = tk - (n - 1)  # the microbatch the last stage finished
        if 0 <= done < m:
            loss_sum = loss_sum + mb_loss(y[n - 1], tokens[done])
    return loss_sum / m, aux_sum


def pipeline_loss(cfg, params: Dict, tokens: torch.Tensor, axis: WorkerAxis,
                  block: Callable, nll: Callable = next_token_nll):
    """The GPipe loss body of pp, pp_moe and dp_tp_pp: microbatched tokens
    ``[M, ..., T]`` (``[M, b, T]``, or ``[M, cols, b, T]`` for independent
    columns), block leaves ``[depth, ...]`` (stage s owns rows ``[s depth /
    S, (s + 1) depth / S)``); ``block(x, blk)`` runs one local block of
    every stage over ``x [S, rows, T, D]`` with leaves ``[S, ...]`` ->
    (x, its aux ``[S, ...]`` or None), recomputed under ``cfg.remat``;
    ``nll(logits, tok)`` is a microbatch's loss. Returns ``gpipe_fold``'s
    (task, aux summed over the valid ticks and each stage's blocks)."""
    from ..models.transformer import _rms_norm

    n = axis.size
    per_stage = cfg.depth // n
    t = tokens.shape[-1]
    pos = torch.arange(t, device=tokens.device)
    cd = cfg.effective_compute_dtype  # blocks emit compute-dtype activations
    blocks = {k: v.reshape((n, per_stage) + tuple(v.shape[1:]))
              for k, v in params["blocks"].items()}

    def local_blocks(x):  # [S, ..., T, D]
        shape = x.shape
        x = x.reshape(n, -1, t, cfg.dim)
        aux_sum = None
        for j in range(per_stage):
            blk = {k: v[:, j] for k, v in blocks.items()}
            if cfg.remat:
                x, aux = checkpoint(block, x, blk, use_reentrant=False)
            else:
                x, aux = block(x, blk)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        return x.reshape(shape), aux_sum

    def embed(i):
        return (params["embed"][tokens[i].long()] + params["pos_embed"][pos]).to(cd)

    def mb_loss(y, tok):
        xf = _rms_norm(y, params["out_norm"].to(cd))
        return nll(xf @ params["embed"].T.to(cd), tok)

    return gpipe_fold(axis, tokens, cfg.dim, cd, embed, local_blocks, mb_loss)


def make_pp_train_step(cfg, tx, mesh: WorkerAxis, num_microbatches: int):
    """The PP LM train step: (PP-layout params, opt_state, tokens ``[B,
    T]``) -> (params, opt_state, loss); the tokens are cut into
    ``num_microbatches`` equal microbatches inside the step."""
    from ..models.transformer import local_attention

    def loss_fn(params, tokens):
        attend = local_attention(cfg)
        bsz, t = tokens.shape
        if bsz % num_microbatches:
            raise ValueError(
                f"batch {bsz} not divisible by {num_microbatches} microbatches")
        mb = tokens.reshape(num_microbatches, bsz // num_microbatches, t)
        task, _ = pipeline_loss(cfg, params, mb, mesh,
                                lambda x, blk: (_stage_block(cfg, x, blk, attend), None))
        return task

    def step(params, opt_state, tokens):
        return differentiate(loss_fn, tx, params, opt_state, tokens)

    return step


def init_pp_state(cfg, tx, generator: Optional[torch.Generator], mesh: WorkerAxis,
                  device: DeviceLike = None):
    """(PP-layout params, opt_state); the weights from ``init_transformer``
    (a ``torch.Generator``)."""
    from ..models.transformer import init_transformer

    params = shard_params_pp(cfg, to_pp_layout(
        cfg, init_transformer(cfg, generator, device=resolve_device(device))), mesh)
    return params, tx.init(params)
