"""2-D parallelism: PS data parallelism x ring-attention sequence
parallelism (the port of parallel/dp_sp.py).

Params stay replicated (one copy, read by every virtual worker), batch
shards ride the dp axis and sequence shards the sp axis of a ``Mesh2D``;
per-worker tensors are stacked ``[sp, dp, ...]`` (parallel/mesh.py).

Gradient math, as in the JAX step (dp_sp.py:10-17): each (dp, sp) worker
owns only its LOCAL slice of the objective, loss_sum_local /
count_global with the global count a constant; the gradients are summed
over sp exactly once and averaged over dp (the PS aggregation). JAX
differentiates each device's local loss and psums the grads; here one
backward over the sum of the stacked local losses gives the same sum
over every worker (the ring's backward routes each shard's K/V gradient
home), in another order: f32 sums that agree to about 1e-6 relative.

Next-token targets cross sequence-shard boundaries: the target of a
shard's last token is the next shard's first token, fetched by the ring
shift; the final global position is masked out of the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.transformer import TransformerConfig, apply_transformer
from ..optim import apply_updates
from .buckets import tree_flatten, tree_unflatten
from .mesh import Mesh2D, WorkerAxis


def make_mesh_2d(num_dp: int, num_sp: int) -> Mesh2D:
    """(num_dp x num_sp) grid of virtual workers on the one device; dp
    outer, sp inner, as ``dp_sp.make_mesh_2d`` lays out its devices."""
    return Mesh2D(dp=WorkerAxis(num_dp), sp=WorkerAxis(num_sp))


def shard_tokens_2d(tokens: torch.Tensor, mesh: Mesh2D) -> torch.Tensor:
    """Global tokens ``[B, T]`` -> stacked ``[sp, dp, B / dp, T / sp]``:
    B over dp, T over sp (worker (i, j) holds rows ``i * B/dp ...`` and
    positions ``j * T/sp ...``)."""
    b, t = tokens.shape
    dp, sp = mesh.dp.size, mesh.sp.size
    if b % dp or t % sp:
        raise ValueError(f"tokens [{b}, {t}] do not split over dp {dp} x sp {sp}")
    return tokens.reshape(dp, b // dp, sp, t // sp).permute(2, 0, 1, 3).contiguous()


def lm_loss_local(cfg: TransformerConfig, params, tokens: torch.Tensor,
                  mesh: Mesh2D) -> torch.Tensor:
    """Every worker's LOCAL slice of the global-mean next-token loss
    (dp_sp.py:64), ``[sp, dp]``: worker (i, j)'s loss_sum_local /
    count_global. The global loss is its sum over sp; the step
    differentiates the local slices, never that sum's psum."""
    sp, dp, b, t = tokens.shape
    logits = apply_transformer(cfg, params, tokens.reshape(sp, dp * b, t), seq_axis=mesh.sp)
    return local_loss_slices(logits, tokens, mesh)


def local_loss_slices(logits: torch.Tensor, tokens: torch.Tensor,
                      mesh: Mesh2D) -> torch.Tensor:
    """The loss slices of ``lm_loss_local`` from every worker's logits
    ``[sp, dp * b, t, V]`` (parallel/ep_sp.py reuses them on the MoE
    forward): boundary targets by the ring shift, the final global
    position masked, each slice over the global count."""
    sp, dp, b, t = tokens.shape
    toks = tokens.reshape(sp, dp * b, t)
    # target of my last token = next shard's first token (ring shift left)
    nxt_first = mesh.sp.ppermute(toks[:, :, :1], [(j, (j - 1) % sp) for j in range(sp)])
    tgt = torch.cat([toks[:, :, 1:], nxt_first], dim=2).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]  # [sp, dp * b, t]
    pos = mesh.sp.axis_index(tokens.device)[:, None] * t + torch.arange(
        t, device=tokens.device)
    valid = (pos < sp * t - 1).float()  # drop the final global position
    loss_sum = (nll * valid[:, None, :]).reshape(sp, dp, b * t).sum(dim=-1)
    count = float(b) * valid.sum(dim=1)  # [sp]: each sp worker's count
    return loss_sum / mesh.sp.psum(count)


def make_lm_train_step(cfg: TransformerConfig, tx, mesh: Mesh2D):
    """The 2-D train step (dp_sp.py:94): (params, opt_state, tokens
    ``[sp, dp, b, t]``) -> (params, opt_state, loss). Grads are summed
    over sp once and averaged over dp, then ``tx.update``; the reported
    loss is pmean over dp of the psum over sp of the local losses."""

    def step(params, opt_state, tokens):
        leaves, skeleton = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss_local = lm_loss_local(cfg, tree_unflatten(skeleton, leaves), tokens, mesh)
        grads = torch.autograd.grad(loss_local.sum(), leaves)
        grads = tree_unflatten(skeleton, [g / mesh.dp.size for g in grads])
        loss = mesh.dp.pmean(mesh.sp.psum(loss_local.detach()))
        updates, new_opt = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), new_opt, loss

    return step
