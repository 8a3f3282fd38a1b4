"""2-D parallelism: pipeline stages x expert parallelism (the port of
parallel/pp_moe.py), on a (stage x expert) grid of virtual workers
stacked on the one device.

- block params are stacked ``[depth, ...]`` (``pp.to_pp_layout``) and cut
  over the stages as in parallel/pp.py (stage s owns blocks ``[s depth /
  S, (s + 1) depth / S)``, a view); the expert leaves ``[depth, E, ...]``
  are cut over both axes, stacked ``[depth, n_ep, E / n_ep, ...]``
  (``shard_params_pp_moe``);
- the batch is cut over the expert axis (its columns), and each column
  runs the GPipe schedule on its own microbatches: the schedule's tokens
  are ``[M, n_ep, b, T]`` and every tick all S stages and n_ep columns
  run in one call a block (the (stage, column) rows fold into the batch
  of one attention call). Within a tick each block's MoE MLP all_to_alls
  over the expert axis, per stage;
- capacity and rank are per (stage, column) shard and microbatch;
- the loss is ``pp.pipeline_loss``'s tick-folded mean a column, and the aux
  is summed over each stage's VALID ticks only (warm-up and drain ticks
  route garbage activations), then over the stages, over ``M depth``.

Under ``attention_impl="flash"`` a step launches K4 ``(M + S - 1) depth /
S`` times (twice that with remat) and K5 and K6 that many times each, as
pp does.

Gradient rule (pp_moe.py:17-20 there): each JAX shard differentiates its
``(task + w aux) / (n_pp n_ep)`` with the task and aux stage-replicated
(a psum over the stages), so the sum over shards counts each column
``n_pp`` times; replicated leaves then psum over both axes,
stage-sharded ones over the expert axis, and the (stage, expert) leaves
need no psum. That is the gradient of the mean over the columns of
``task + w aux``, which the port takes with one backward: the same sums
in another f32 order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import DeviceLike
from ..ops.metrics import shard_next_token_nll
from .mesh import WorkerAxis
from .moe import (
    ATTENTION_LEAVES,
    MoEConfig,
    _check_experts,
    _cut_experts,
    _join_experts,
    init_moe_params,
    moe_mlp_local,
    shard_moe_batch,
)
from .pp import _stage_block, pipeline_loss, to_pp_layout
from .tp import differentiate


@dataclasses.dataclass(frozen=True)
class PPMoEMesh:
    """A (stage x expert) grid of virtual workers on the one device; stage
    outer, expert inner, as ``make_mesh_pp_moe`` lays out its devices."""

    pp: WorkerAxis
    ep: WorkerAxis


def make_mesh_pp_moe(num_stages: int, num_ep: int) -> PPMoEMesh:
    return PPMoEMesh(pp=WorkerAxis(num_stages), ep=WorkerAxis(num_ep))


def shard_params_pp_moe(cfg, params_pp: Dict, mesh: PPMoEMesh) -> Dict:
    """A PP-layout MoE tree -> the stacked one: the expert leaves ``[depth,
    n_ep, E / n_ep, ...]`` (views); the stage cut is the depth dim itself.
    Raises JAX's errors when depth or the experts do not split."""
    n = mesh.pp.size
    if cfg.depth % n:
        raise ValueError(f"depth {cfg.depth} not divisible by {n} stages")
    _check_experts(params_pp["blocks"]["w_up_e"].shape[1], mesh.ep.size)
    out = {k: v for k, v in params_pp.items() if k != "blocks"}
    out["blocks"] = _cut_experts(params_pp["blocks"], mesh.ep.size, 1)
    return out


def unshard_params_pp_moe(cfg, params: Dict) -> Dict:
    """Inverse of ``shard_params_pp_moe``: the PP-layout tree
    (``from_pp_layout`` of it is the plain MoE model)."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = _join_experts(params["blocks"], 1)
    return out


def shard_tokens_pp_moe(tokens: torch.Tensor, mesh: PPMoEMesh) -> torch.Tensor:
    """``[B, T]`` -> ``[n_ep, B / n_ep, T]``: B over the expert axis, read by
    every stage of a column."""
    return shard_moe_batch(tokens, mesh.ep)


def _pp_moe_loss(cfg, moe: MoEConfig, params: Dict, tokens: torch.Tensor,
                 mesh: PPMoEMesh):
    """The tick-folded pipeline loss of the MoE transformer over each
    column's microbatches ``tokens [M, n_ep, b, T]``: (task ``[n_ep]``,
    aux ``[n_ep]``), the aux the mean a valid tick and block."""
    from ..models.transformer import local_attention

    n, n_ep = mesh.pp.size, mesh.ep.size
    m, _, b, t = tokens.shape
    attend = local_attention(cfg)

    def one_block(x, blk):  # x [S, n_ep b, T, D]; each leaf [S, ...]
        aux_cell = []
        # the gate [S, D, E] broadcasts over the columns
        experts = {"wg": blk["wg"][:, None], "w_up_e": blk["w_up_e"],
                   "w_down_e": blk["w_down_e"]}

        def mlp(h):  # h [S, n_ep b, T, D]: each (stage, column) one shard
            out, aux = moe_mlp_local(h.reshape(n, n_ep, b, t, cfg.dim), experts, moe,
                                     mesh.ep)
            aux_cell.append(aux)
            return out.reshape(h.shape)

        x = _stage_block(cfg, x, {k: blk[k] for k in ATTENTION_LEAVES}, attend, mlp=mlp)
        return x, aux_cell[0]

    task, aux_sum = pipeline_loss(cfg, params, tokens, mesh.pp, one_block,
                                  shard_next_token_nll)
    # aux_sum [S, n_ep] over (valid ticks x local blocks); the stage sum
    # over M depth is the mean a block and microbatch (apply_moe_transformer
    # divides by depth the same way)
    return task, aux_sum.sum(0) / (m * cfg.depth)


def make_pp_moe_train_step(cfg, moe: MoEConfig, tx, mesh: PPMoEMesh,
                           num_microbatches: int):
    """The 2-D (stage x expert) MoE train step: (stacked PP-layout params,
    opt_state, tokens ``[n_ep, B / n_ep, T]``) -> (params, opt_state,
    task_loss, aux), each loss the mean over the columns."""

    def loss_fn(params, tokens):
        n_ep, bsz, t = tokens.shape
        if bsz % num_microbatches:
            raise ValueError(
                f"batch {bsz} not divisible by {num_microbatches} microbatches")
        mb = tokens.reshape(n_ep, num_microbatches, bsz // num_microbatches, t)
        task, aux = _pp_moe_loss(cfg, moe, params, mb.transpose(0, 1), mesh)
        return (task + moe.aux_loss_weight * aux).mean(), (task.mean(), aux.mean())

    def step(params, opt_state, tokens):
        params, opt_state, (task, aux) = differentiate(loss_fn, tx, params, opt_state,
                                                       tokens, has_aux=True)
        return params, opt_state, task, aux

    return step


def init_pp_moe_state(cfg, moe: MoEConfig, tx, generator: Optional[torch.Generator],
                      mesh: PPMoEMesh, device: DeviceLike = None):
    """(stacked PP-layout params, opt_state)."""
    if cfg.depth % mesh.pp.size:
        raise ValueError(f"depth {cfg.depth} not divisible by {mesh.pp.size} stages")
    _check_experts(moe.num_experts, mesh.ep.size)
    params = shard_params_pp_moe(
        cfg, to_pp_layout(cfg, init_moe_params(cfg, moe, generator, device)), mesh)
    return params, tx.init(params)
