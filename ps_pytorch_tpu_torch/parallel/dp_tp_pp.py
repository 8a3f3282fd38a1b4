"""3-D parallelism: data x pipeline stage x tensor (the port of
parallel/dp_tp_pp.py), on a (dp x stage x tp) grid of virtual workers
stacked on the one device. A library: ``cli.train_lm`` reaches it in
neither package.

- the batch is cut over dp, and each dp column runs the GPipe schedule
  (``pp.pipeline_loss``) on its own microbatches: the schedule's tokens are
  ``[M, n_dp, b, T]``;
- block params are Megatron-split over tp per block (``tp.to_tp_layout``)
  and stacked ``[depth, ...]`` over the stages (``to_3d_layout``, JAX's
  global layout); ``shard_params_3d`` stacks each cut leaf's tp slices
  on dim 1, ``[depth, n_tp, ...]``, and stage s owns blocks ``[s depth /
  S, (s + 1) depth / S)`` (a view);
- a tick runs every stage's block on every tp shard's heads and columns
  at once: the (stage, tp shard, dp column) rows fold into the batch of
  one attention call, and the two psums over tp a block are sums over
  the tp dim. Under ``attention_impl="flash"`` a step launches K4 ``(M +
  S - 1) depth / S`` times (twice that with remat) and K5 and K6 that
  many times each.

Gradient rule (dp_tp_pp.py:17-23 there): the tick-folded loss is
replicated across stage x tp within a dp column, each JAX shard
differentiates ``loss / (n_dp n_pp n_tp)`` and psums over the axes its
leaf is not cut on; summed over the shards that is the gradient of the
mean over dp of each column's loss, which the port takes with one
backward: the same sums in another f32 order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import DeviceLike, resolve_device
from ..ops.metrics import shard_next_token_nll
from .dp_tp import shard_tokens_dp
from .mesh import WORKER_AXIS, WorkerAxis
from .pp import pipeline_loss
from .tp import differentiate, from_tp_layout, to_tp_layout, tp_block

# the data axis of the grid (dp_tp_pp.py:46): the PS engine's worker axis
DP_AXIS = WORKER_AXIS


@dataclasses.dataclass(frozen=True)
class Mesh3D:
    """A (dp x stage x tp) grid of virtual workers on the one device; tp
    innermost, as ``make_mesh_3d`` lays out its devices."""

    dp: WorkerAxis
    pp: WorkerAxis
    tp: WorkerAxis


def make_mesh_3d(num_dp: int, num_pp: int, num_tp: int) -> Mesh3D:
    return Mesh3D(dp=WorkerAxis(num_dp), pp=WorkerAxis(num_pp), tp=WorkerAxis(num_tp))


def to_3d_layout(cfg, params: Dict) -> Dict:
    """Plain params -> the TP layout per block, then stacked ``[depth,
    ...]``: ``wqkv [depth, D, 3, H, hd]``, ``wo [depth, H, hd, D]``, ``w_up
    [depth, D, M]``, ``w_down [depth, M, D]``, norms ``[depth, D]``."""
    tp_params = to_tp_layout(cfg, params)
    out = {k: v for k, v in tp_params.items() if k != "blocks"}
    out["blocks"] = {k: torch.stack([blk[k] for blk in tp_params["blocks"]])
                     for k in tp_params["blocks"][0]}
    return out


def from_3d_layout(cfg, params_3d: Dict) -> Dict:
    """Inverse of ``to_3d_layout`` (checkpoint interchange)."""
    tp_params = {k: v for k, v in params_3d.items() if k != "blocks"}
    tp_params["blocks"] = [{k: v[i] for k, v in params_3d["blocks"].items()}
                           for i in range(cfg.depth)]
    return from_tp_layout(cfg, tp_params)


def param_specs_3d(cfg) -> Dict:
    """The dim of each ``to_3d_layout`` leaf that the tp shards cut (None:
    replicated over tp); every block leaf's dim 0 (depth) is cut over the
    stages. JAX's ``P(stage, ..., model, ...)``."""
    blk = {"ln1": None, "wqkv": 3, "wo": 1, "ln2": None, "w_up": 2, "w_down": 1}
    return {"embed": None, "pos_embed": None, "out_norm": None, "blocks": blk}


def _check_3d(cfg, mesh: Mesh3D) -> None:
    if cfg.depth % mesh.pp.size:
        raise ValueError(f"depth {cfg.depth} not divisible by {mesh.pp.size} stages")
    n_tp = mesh.tp.size
    if cfg.heads % n_tp or (cfg.dim * cfg.mlp_ratio) % n_tp:
        raise ValueError(f"heads/mlp not divisible by {n_tp} model shards")


def shard_params_3d(cfg, params_3d: Dict, mesh: Mesh3D) -> Dict:
    """The global 3-D layout -> the stacked one: each tp-cut block leaf
    ``[depth, n_tp, ...]`` (shard i holds the i-th of n_tp equal slices of
    its dim), the rest as they are."""
    _check_3d(cfg, mesh)
    specs = param_specs_3d(cfg)["blocks"]
    out = {k: v for k, v in params_3d.items() if k != "blocks"}
    out["blocks"] = {
        k: v if specs[k] is None
        else torch.stack(v.chunk(mesh.tp.size, dim=specs[k]), dim=1).contiguous()
        for k, v in params_3d["blocks"].items()}
    return out


def unshard_params_3d(cfg, params: Dict) -> Dict:
    """Inverse of ``shard_params_3d``."""
    specs = param_specs_3d(cfg)["blocks"]
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: v if specs[k] is None else torch.cat(v.unbind(1), dim=specs[k])
                     for k, v in params["blocks"].items()}
    return out


# ``[B, T]`` -> ``[n_dp, B / n_dp, T]``: B over dp, read by every stage and
# tp shard of a column
shard_tokens_3d = shard_tokens_dp


def _3d_loss(cfg, params: Dict, tokens: torch.Tensor, mesh: Mesh3D) -> torch.Tensor:
    """The tick-folded pipeline loss with TP blocks (``tp.tp_block`` over
    the stage dim: JAX's ``_tp_block`` on each device) over each dp
    column's microbatches ``tokens [M, n_dp, b, T]``: each column's loss
    ``[n_dp]``."""
    from ..models.transformer import local_attention

    attend = local_attention(cfg)
    task, _ = pipeline_loss(cfg, params, tokens, mesh.pp,
                            lambda x, blk: (tp_block(cfg, x, blk, attend, mesh.tp), None),
                            shard_next_token_nll)
    return task


def make_3d_train_step(cfg, tx, mesh: Mesh3D, num_microbatches: int):
    """The dp x pp x tp train step: (stacked 3-D params, opt_state, tokens
    ``[n_dp, B / n_dp, T]``) -> (params, opt_state, loss), the loss the
    mean over dp of each column's."""

    def loss_fn(params, tokens):
        n_dp, bsz, t = tokens.shape
        if bsz % num_microbatches:
            raise ValueError(f"per-dp batch {bsz} not divisible by "
                             f"{num_microbatches} microbatches")
        mb = tokens.reshape(n_dp, num_microbatches, bsz // num_microbatches, t)
        return mesh.dp.pmean(_3d_loss(cfg, params, mb.transpose(0, 1), mesh))

    def step(params, opt_state, tokens):
        return differentiate(loss_fn, tx, params, opt_state, tokens)

    return step


def init_3d_state(cfg, tx, generator: Optional[torch.Generator], mesh: Mesh3D,
                  device: DeviceLike = None):
    """(stacked 3-D params, opt_state); the weights from
    ``init_transformer`` (a ``torch.Generator``)."""
    from ..models.transformer import init_transformer

    _check_3d(cfg, mesh)
    params = init_transformer(cfg, generator, device=resolve_device(device))
    params = shard_params_3d(cfg, to_3d_layout(cfg, params), mesh)
    return params, tx.init(params)
