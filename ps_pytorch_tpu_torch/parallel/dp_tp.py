"""2-D parallelism: data parallelism x Megatron tensor parallelism (the
port of parallel/dp_tp.py).

Batch shards ride the dp axis; each data shard's model is split over the
tp axis (parallel/tp.py). Params are cut over tp and replicated over dp:
the stacked params hold one ``[n_tp, ...]`` copy that every dp row
reads. Tokens are stacked ``[dp, B / dp, T]``; inside the blocks the
activations are stacked ``[tp, dp, B / dp, ...]``: the inner axis leads,
as ``Mesh2D`` stacks ``[sp, dp, ...]``, and one attention call takes all
``tp * B`` rows.

Gradient math (dp_tp.py:10-20 there): JAX psums each device's gradient of
``loss / (n_tp * n_dp)`` over dp for the cut leaves and over dp x tp for
the replicated ones, and reports ``psum(loss, dp) * n_tp``: the gradient
and value of the mean over dp rows of each row's loss. The port computes
that mean (``mesh.dp.pmean`` of the per-row losses) and runs one
backward: the same f32 sums in another order. The PS compressed wire is
not on this path, in JAX either.
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import WorkerAxis
from .tp import differentiate, init_tp_state, lm_positions_nll


@dataclasses.dataclass(frozen=True)
class DPTPMesh:
    """A (dp x tp) grid of virtual workers on the one device, tp inner."""

    dp: WorkerAxis
    tp: WorkerAxis


def make_mesh_dp_tp(num_dp: int, num_tp: int) -> DPTPMesh:
    return DPTPMesh(dp=WorkerAxis(num_dp), tp=WorkerAxis(num_tp))


def init_dp_tp_state(cfg, tx, generator, mesh: DPTPMesh, shard_vocab: bool = False,
                     device=None):
    """(params cut over tp, opt_state): ``init_tp_state`` on the tp axis
    (dp replication is the one copy every dp row reads)."""
    return init_tp_state(cfg, tx, generator, mesh.tp, shard_vocab, device)


def shard_tokens_dp(tokens: torch.Tensor, mesh: DPTPMesh) -> torch.Tensor:
    """``[B, T]`` -> ``[dp, B / dp, T]``: B over dp, read by every tp shard."""
    return mesh.dp.split_batch(tokens, f"dp {mesh.dp.size}")


def make_dp_tp_train_step(cfg, tx, mesh: DPTPMesh, shard_vocab: bool = False):
    """The 2-D train step: (params, opt_state, tokens ``[dp, B / dp, T]``)
    -> (params, opt_state, loss), the loss the global batch mean (the
    mean over dp of each dp row's loss). ``shard_vocab`` runs the
    embedding and loss vocab-parallel over tp."""

    def loss_fn(params, tokens):
        nll = lm_positions_nll(cfg, params, tokens, mesh.tp, shard_vocab)
        return mesh.dp.pmean(nll.reshape(mesh.dp.size, -1).mean(1))

    def step(params, opt_state, tokens):
        return differentiate(loss_fn, tx, params, opt_state, tokens)

    return step
