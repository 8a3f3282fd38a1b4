"""Mixture-of-Experts with expert parallelism (the port of parallel/moe.py),
on a stacked ``WorkerAxis(n)`` of expert shards on the one device.

The Switch-Transformer formulation, as the JAX module writes it:

- every block's dense MLP is replaced by E experts (``w_up_e [E, D, M]``,
  ``w_down_e [E, M, D]``) and a gate ``wg [D, E]``; the expert weights are
  cut over the expert axis (``shard_params_moe``: shard i holds experts
  ``[i E / n, (i + 1) E / n)``, stacked ``[n, E / n, ...]``, a view of the
  plain tensor), everything else is one replicated tensor;
- the batch is cut over the same axis (it doubles as data parallelism
  outside the MoE region): tokens stacked ``[n, B / n, T]``;
- top-1 (Switch) or top-2 (GShard) gating with a capacity of
  ``ceil(b t top_k capacity_factor / E)`` slots an expert, counted on each
  shard's own tokens; a token's slot is its one-hot cumsum rank within
  its shard, and a token past the capacity is dropped (it rides the
  residual only);
- dispatch: the dense one-hot einsum to ``[E, C, D]``, the tiled
  all_to_all to the owners (``WorkerAxis.all_to_all_tiled``: ``[n, E / n,
  n C, D]``), the experts' products, the all_to_all back, the
  combine-weighted sum;
- a Switch load-balance aux loss (``E sum_e f_e p_e``) beside the task
  loss.

The expert products and the dispatch / combine einsums are plain
``torch.matmul`` / ``torch.einsum``, as JAX computes them outside Pallas;
attention is the one selection point of models/transformer.py (K4-K6
under ``attention_impl="flash"``). Every shard's rows fold into the batch
of one attention call: a step launches K4 once a block (twice with remat)
and K5 and K6 once a block each.

Gradient rule (moe.py:21-26 there): each JAX shard differentiates its
local ``(task + w aux) / n`` and psums the replicated leaves' gradients;
the expert leaves get every shard's part through the all_to_all's
transpose. That is the gradient of ``(1 / n) sum_shards (task + w aux)``,
which the port takes with one backward of the mean over the stacked
shards: the same sums in another f32 order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, on_device, resolve_device
from ..ops.metrics import shard_next_token_nll
from .mesh import WorkerAxis
from .tp import differentiate

# ..models.transformer imports this package (mesh, ring_attention), so it
# is imported inside the functions that use it, as the JAX module does

EP_AXIS = "expert"
EXPERT_LEAVES = ("w_up_e", "w_down_e")
# the leaves transformer_block reads when the MLP is passed in: handing it
# only these keeps it from casting the expert weights it never uses
ATTENTION_LEAVES = ("ln1", "wqkv", "wo", "ln2")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """MoE knobs layered on top of a TransformerConfig."""

    num_experts: int = 8
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # 1 = Switch routing; 2 = GShard-style top-2 (renormalized gates,
    # second choices queue behind first choices for capacity slots)
    top_k: int = 1

    def __post_init__(self):
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {self.top_k}")


def make_ep_mesh(num_shards: int) -> WorkerAxis:
    """The expert-parallel axis: ``num_shards`` stacked shards."""
    return WorkerAxis(num_shards)


def init_moe_params(cfg, moe: MoEConfig, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> Dict:
    """Transformer params with every block's dense MLP replaced by a gate
    and stacked expert weights, with JAX's scales (``wg``, ``w_up_e``
    N(0, 1/D), ``w_down_e`` N(0, 1/M)). ``generator`` is a CPU
    ``torch.Generator``; the values differ from ``jax.random``'s."""
    from ..models.transformer import _normal, init_transformer

    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    params = init_transformer(cfg, g, device="cpu")
    mlp_dim, e = cfg.dim * cfg.mlp_ratio, moe.num_experts
    scale = 1.0 / (cfg.dim ** 0.5)
    for blk in params["blocks"]:
        del blk["w_up"], blk["w_down"]
        blk["wg"] = _normal(g, (cfg.dim, e), scale, cfg.dtype)
        blk["w_up_e"] = _normal(g, (e, cfg.dim, mlp_dim), scale, cfg.dtype)
        blk["w_down_e"] = _normal(g, (e, mlp_dim, cfg.dim), 1.0 / mlp_dim ** 0.5, cfg.dtype)
    return on_device(params, dev)


def moe_param_specs(cfg) -> Dict:
    """The dim of each plain MoE leaf that the expert shards cut (moe.py:102):
    the expert leaves' E (dim 0, ``shard_params_moe``'s ``[n, E / n, ...]``),
    None for the replicated rest (``parallel.mesh.place_on_mesh``)."""
    blk = {"ln1": None, "wqkv": None, "wo": None, "ln2": None, "wg": None,
           "w_up_e": 0, "w_down_e": 0}
    return {"embed": None, "pos_embed": None, "out_norm": None,
            "blocks": [dict(blk) for _ in range(cfg.depth)]}


def _check_experts(e: int, n: int) -> None:
    if e % n:
        raise ValueError(f"{e} experts not divisible by {n} expert shards")


def _cut_experts(blk: Dict, n: int, at: int) -> Dict:
    """``blk`` with its expert leaves' dim ``at`` (E) viewed ``[n, E / n]``."""
    return {k: v.unflatten(at, (n, -1)) if k in EXPERT_LEAVES else v
            for k, v in blk.items()}


def _join_experts(blk: Dict, at: int) -> Dict:
    return {k: v.flatten(at, at + 1) if k in EXPERT_LEAVES else v for k, v in blk.items()}


def shard_params_moe(cfg, params: Dict, mesh: WorkerAxis) -> Dict:
    """Plain MoE params -> the stacked tree: the expert leaves ``[n, E / n,
    ...]`` (views; JAX's ``moe_param_specs`` cuts them over the expert
    axis), the rest as they are."""
    _check_experts(params["blocks"][0]["w_up_e"].shape[0], mesh.size)
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = [_cut_experts(b, mesh.size, 0) for b in params["blocks"]]
    return out


def unshard_params_moe(cfg, params: Dict) -> Dict:
    """Inverse of ``shard_params_moe``: the plain MoE tree (checkpoints)."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = [_join_experts(b, 0) for b in params["blocks"]]
    return out


def _choice_dispatch(onehot: torch.Tensor, capacity: int,
                     offset: torch.Tensor) -> torch.Tensor:
    """Queue one routing choice into capacity slots, per shard.

    onehot ``[..., N, E]`` (N tokens of one shard); offset ``[..., E]`` =
    slots already taken per expert by earlier (higher-priority) choices.
    Returns the ``[..., N, E, C]`` dispatch tensor (1.0 where a token owns
    a slot). A rank at or past C gives an all-zero row, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise)."""
    rank = torch.cumsum(onehot, dim=-2) * onehot - onehot  # within-choice
    rank = rank + offset[..., None, :] * onehot
    kept = (rank < capacity).to(onehot.dtype) * onehot
    slot = torch.sum(rank * onehot, dim=-1)  # [..., N]
    pos = (slot[..., None] == torch.arange(capacity, dtype=slot.dtype,
                                           device=slot.device)).to(onehot.dtype)
    return kept[..., :, :, None] * pos[..., :, None, :]


def _gate_and_dispatch(x2d: torch.Tensor, wg: torch.Tensor, capacity: int,
                       top_k: int = 1):
    """Top-1 (Switch) or top-2 (GShard) gating over each shard's flat
    tokens ``x2d [..., N, D]``.

    Returns (dispatch ``[..., N, E, C]`` float {0, 1}, combine ``[..., N,
    E, C]``, aux ``[...]``). For top-2 the gates are renormalized over the
    two choices and second choices queue behind ALL first choices for an
    expert's slots. Both argmaxes take the first maximum, as jnp's."""
    logits = x2d @ wg  # [..., N, E]
    probs = torch.softmax(logits.float(), dim=-1)
    e = wg.shape[-1]

    expert1 = torch.argmax(probs, dim=-1)
    gate1 = probs.gather(-1, expert1[..., None])[..., 0]
    onehot1 = F.one_hot(expert1, e).float()
    dispatch = _choice_dispatch(onehot1, capacity, torch.zeros(e, device=probs.device))

    if top_k == 2:
        probs2 = probs * (1.0 - onehot1)  # mask the first choice
        expert2 = torch.argmax(probs2, dim=-1)
        gate2 = probs.gather(-1, expert2[..., None])[..., 0]
        onehot2 = F.one_hot(expert2, e).float()
        # second choices queue behind every first choice (capped at C)
        taken = torch.clamp(torch.sum(onehot1, dim=-2), max=capacity)
        dispatch2 = _choice_dispatch(onehot2, capacity, taken)
        denom = gate1 + gate2 + 1e-9  # dropped choices contribute 0
        combine = (dispatch * (gate1 / denom)[..., None, None]
                   + dispatch2 * (gate2 / denom)[..., None, None])
        dispatch = dispatch + dispatch2
    else:
        combine = dispatch * gate1[..., None, None]

    # Switch aux on the first choice: E * sum_e (fraction to e) (mean prob of e)
    f = torch.mean(onehot1, dim=-2)
    p = torch.mean(probs, dim=-2)
    aux = e * torch.sum(f * p, dim=-1)
    return dispatch, combine, aux


def moe_mlp_local(h: torch.Tensor, blk: Dict, moe: MoEConfig,
                  axis: Optional[WorkerAxis]):
    """The MoE MLP on every shard's local tokens ``h [..., b, t, D]`` (each
    leading index one shard); returns (``[..., b, t, D]``, aux ``[...]``).

    With ``axis=None`` every expert is local (the single-device oracle;
    plain ``[E, ...]`` expert leaves). With the expert axis, the last
    leading dim of ``h`` is its worker dim, the expert leaves are stacked
    ``[..., n, E / n, ...]`` and the two tiled all_to_alls route each
    shard's slots to the experts' owners and back."""
    lead, (b, t, d) = tuple(h.shape[:-3]), tuple(h.shape[-3:])
    x2d = h.reshape(lead + (b * t, d))
    e = moe.num_experts
    capacity = int(math.ceil(b * t * moe.top_k * moe.capacity_factor / e))
    # cast at use: params may be stored f32 while activations run bf16
    dispatch, combine, aux = _gate_and_dispatch(x2d, blk["wg"].to(h.dtype), capacity,
                                                top_k=moe.top_k)
    # gating runs in f32; the one-hots drop back to the activation dtype
    # so the expert products stay on the compute-dtype path
    dispatch = dispatch.to(h.dtype)
    combine = combine.to(h.dtype)
    expert_in = torch.einsum("...nec,...nd->...ecd", dispatch, x2d)  # [..., E, C, D]
    if axis is not None:
        w = len(lead) - 1  # the expert axis' dim
        if w < 0 or lead[w] != axis.size:
            raise ValueError(f"expected [..., {axis.size}, b, t, D] shards, got "
                             f"{tuple(h.shape)}")
        # to the owners: split E, concat the senders' slots -> [..., n, E/n, n C, D]
        expert_in = axis.all_to_all_tiled(expert_in.movedim(w, 0), w, w + 1).movedim(0, w)
    w_up = blk["w_up_e"].to(h.dtype)  # local experts, compute dtype
    w_down = blk["w_down_e"].to(h.dtype)
    expert_out = torch.matmul(F.gelu(torch.matmul(expert_in, w_up), approximate="tanh"),
                              w_down)
    if axis is not None:
        # back to the tokens' shards -> [..., n, E, C, D]
        expert_out = axis.all_to_all_tiled(expert_out.movedim(w, 0), w + 1, w).movedim(0, w)
    out = torch.einsum("...nec,...ecd->...nd", combine, expert_out)
    return out.reshape(h.shape).to(h.dtype), aux


def _moe_block(cfg, moe: MoEConfig, x: torch.Tensor, blk: Dict, attend,
              shards: tuple, axis: Optional[WorkerAxis]):
    """``transformer_block`` with the MoE MLP: ``x [prod(shards) b, t,
    D]`` (the shards fold into the batch of the attention call), the MLP
    over ``[*shards, b, t, D]``. Returns (x, aux ``shards``)."""
    from ..models.transformer import transformer_block

    aux_cell = []

    def mlp(h):
        out, aux = moe_mlp_local(h.reshape(shards + (-1,) + tuple(h.shape[1:])), blk, moe,
                                 axis)
        aux_cell.append(aux)
        return out.reshape(h.shape)

    x = transformer_block(cfg, x, {k: blk[k] for k in ATTENTION_LEAVES}, attend, mlp=mlp)
    return x, aux_cell[0]


def apply_moe_transformer(cfg, moe: MoEConfig, params: Dict, tokens: torch.Tensor,
                          axis: Optional[WorkerAxis] = None,
                          seq_axis: Optional[WorkerAxis] = None):
    """Forward -> (logits ``[..., b, t, V]``, mean aux ``[...]``).

    ``tokens [..., b, t]``: ``[b, t]`` alone (one shard, every expert
    local), ``[n, b, t]`` over the expert axis, ``[n_sp, b, t]`` over a
    sequence axis, or ``[n_sp, n, b, t]`` over both (parallel/ep_sp.py:
    the sequence axis leads, as ``Mesh2D`` stacks ``[sp, dp]``). With
    ``seq_axis`` attention runs on the ring / Ulysses over it and
    positions index globally; the dispatch all_to_alls stay on the expert
    axis."""
    from ..models.transformer import _rms_norm, select_attention

    lead, (b, t) = tuple(tokens.shape[:-2]), tuple(tokens.shape[-2:])
    if len(lead) != (axis is not None) + (seq_axis is not None):
        raise ValueError(f"tokens {tuple(tokens.shape)} do not match the axes given")
    dev, d = tokens.device, cfg.dim
    tok = tokens.long()
    if seq_axis is not None:
        pos = seq_axis.axis_index(dev)[:, None] * t + torch.arange(t, device=dev)
        pe = params["pos_embed"][pos].reshape((seq_axis.size,) + (1,) * len(lead) + (t, d))
    else:
        pe = params["pos_embed"][torch.arange(t, device=dev)]
    x = (params["embed"][tok] + pe).reshape(-1, t, d)
    attend = select_attention(cfg, seq_axis)
    block = lambda x, blk: _moe_block(cfg, moe, x, blk, attend, lead, axis)

    aux_total = 0.0
    for blk in params["blocks"]:
        if cfg.remat:
            x, aux = checkpoint(block, x, blk, use_reentrant=False)
        else:
            x, aux = block(x, blk)
        aux_total = aux_total + aux

    cd = cfg.effective_compute_dtype
    xf = _rms_norm(x.to(cd), params["out_norm"].to(cd))
    logits = xf @ params["embed"].T.to(cd)
    return logits.reshape(lead + (b, t, -1)), aux_total / cfg.depth


def make_moe_train_step(cfg, moe: MoEConfig, tx, mesh: WorkerAxis):
    """The MoE LM train step: (stacked params, opt_state, tokens ``[n, B /
    n, T]``) -> (params, opt_state, task_loss, aux), the losses the means
    over the shards (JAX's pmeans)."""

    def loss_fn(params, tokens):
        logits, aux = apply_moe_transformer(cfg, moe, params, tokens, mesh)
        task = shard_next_token_nll(logits, tokens)
        # the means over the shards are the axis's pmeans
        return (mesh.pmean(task + moe.aux_loss_weight * aux),
                (mesh.pmean(task), mesh.pmean(aux)))

    def step(params, opt_state, tokens):
        params, opt_state, (task, aux) = differentiate(loss_fn, tx, params, opt_state,
                                                       tokens, has_aux=True)
        return params, opt_state, task, aux

    return step


def init_moe_state(cfg, moe: MoEConfig, tx, generator: Optional[torch.Generator],
                   mesh: WorkerAxis, device: DeviceLike = None):
    """(stacked params, opt_state): the momentum buffers take their
    parameters' stacked shapes."""
    params = shard_params_moe(cfg, init_moe_params(cfg, moe, generator, device), mesh)
    return params, tx.init(params)


def shard_moe_batch(tokens: torch.Tensor, mesh: WorkerAxis) -> torch.Tensor:
    """``[B, T]`` -> ``[n, B / n, T]``: B over the expert axis."""
    return mesh.split_batch(tokens, f"{mesh.size} expert shards")
