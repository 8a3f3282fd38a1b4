"""2-D parallelism: expert parallelism x ring-attention sequence
parallelism (the port of parallel/ep_sp.py), on an (ep x sp) grid of
virtual workers stacked on the one device.

- the batch is cut over the expert axis (it doubles as data parallelism,
  as in parallel/moe.py), the sequence over the sequence axis; the grid's
  tensors are stacked ``[sp, ep, ...]``, the sequence axis leading as
  ``Mesh2D`` stacks ``[sp, dp]`` (parallel/mesh.py);
- attention: the ring (flash per hop under ``attention_impl="flash"``,
  K4's partial triple forward, K5 + K6 backward) or Ulysses over the
  sequence axis, every expert row in one call;
- the MoE MLP: the two tiled all_to_alls over the expert axis, within
  each sequence column. The two collectives touch orthogonal axes.

Gradient rule (ep_sp.py:16-23 there): each (ep, sp) shard differentiates
its local slice ``lm_local + w aux_local / n_sp`` (``lm_local`` its NLL sum
over the global count, ``dp_sp.local_loss_slices``); replicated leaves
take ``pmean_ep(psum_sp(g))``, expert leaves ``psum_sp(g) / n_ep`` (the
all_to_all's transpose already routed every ep shard's part home). Both
are the gradient of ``(1 / n_ep) sum over shards`` of the slices, which
the port takes with one backward of that sum: the same sums in another
f32 order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import DeviceLike
from .dp_sp import local_loss_slices, shard_tokens_2d
from .mesh import Mesh2D, WorkerAxis
from .moe import MoEConfig, apply_moe_transformer, init_moe_params, shard_params_moe
from .tp import differentiate


@dataclasses.dataclass(frozen=True)
class EPSPMesh:
    """An (ep x sp) grid of virtual workers on the one device; expert
    outer, sequence inner, as ``make_mesh_ep_sp`` lays out its devices."""

    ep: WorkerAxis
    sp: WorkerAxis

    @property
    def grid(self) -> Mesh2D:
        """The grid as dp_sp's (dp x sp) one: the expert axis is the data
        axis outside the MoE region."""
        return Mesh2D(dp=self.ep, sp=self.sp)


def make_mesh_ep_sp(num_ep: int, num_sp: int) -> EPSPMesh:
    return EPSPMesh(ep=WorkerAxis(num_ep), sp=WorkerAxis(num_sp))


def shard_tokens_ep_sp(tokens: torch.Tensor, mesh: EPSPMesh) -> torch.Tensor:
    """``[B, T]`` -> ``[sp, ep, B / ep, T / sp]``: B over the expert axis,
    T over the sequence axis."""
    return shard_tokens_2d(tokens, mesh.grid)


def moe_lm_loss_local(cfg, moe: MoEConfig, params, tokens: torch.Tensor,
                      mesh: EPSPMesh):
    """Every (ep, sp) shard's LOCAL slice of the global-mean next-token
    loss and its aux, each ``[sp, ep]`` (ep_sp.py:71-100 there): dp_sp's
    boundary targets and global count on the MoE forward."""
    sp, ep, b, t = tokens.shape
    logits, aux = apply_moe_transformer(cfg, moe, params, tokens, axis=mesh.ep,
                                        seq_axis=mesh.sp)
    lm_local = local_loss_slices(logits.reshape((sp, ep * b) + tuple(logits.shape[3:])),
                                 tokens, mesh.grid)
    return lm_local, aux


def make_ep_sp_train_step(cfg, moe: MoEConfig, tx, mesh: EPSPMesh):
    """The 2-D MoE train step: (stacked params, opt_state, tokens ``[sp,
    ep, b, t]``) -> (params, opt_state, task_loss, aux): the task the
    pmean over ep of the psum over sp of the slices, the aux the mean over
    every shard."""
    n_ep, n_sp = mesh.ep.size, mesh.sp.size

    def loss_fn(params, tokens):
        lm_local, aux = moe_lm_loss_local(cfg, moe, params, tokens, mesh)
        # aux_local / n_sp: the sp-sum and ep-mean of the slices is the mean aux
        obj = (lm_local + moe.aux_loss_weight * aux / n_sp).sum() / n_ep
        return obj, (mesh.ep.pmean(mesh.sp.psum(lm_local)), aux.mean())

    def step(params, opt_state, tokens):
        params, opt_state, (task, aux) = differentiate(loss_fn, tx, params, opt_state,
                                                       tokens, has_aux=True)
        return params, opt_state, task, aux

    return step


def init_ep_sp_state(cfg, moe: MoEConfig, tx, generator: Optional[torch.Generator],
                     mesh: EPSPMesh, device: DeviceLike = None):
    """(params with the expert leaves cut over ep and read by every sp
    shard, opt_state)."""
    params = shard_params_moe(cfg, init_moe_params(cfg, moe, generator, device), mesh.ep)
    return params, tx.init(params)
