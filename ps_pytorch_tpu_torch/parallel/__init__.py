"""Parallel building blocks of the port: the stacked worker backend
(mesh.py), the flat state geometry and the piece stream of the per-leaf
and bucketed wires (buckets.py), the gradient aggregation wires
(collectives.py), the PS train step (ps.py), sequence parallelism
(ring_attention.py, ulysses.py), the dp x sp LM train step
(dp_sp.py), the LM's tensor (tp.py, dp_tp.py) and pipeline (pp.py)
parallelisms, its Mixture-of-Experts schemes (moe.py, ep_sp.py,
pp_moe.py) and the data x stage x tensor grid (dp_tp_pp.py). dp_sp and
ep_sp import the transformer model, which imports this package: import
them as modules."""

from .dp_tp import (
    init_dp_tp_state,
    make_dp_tp_train_step,
    make_mesh_dp_tp,
    shard_tokens_dp,
)
from .dp_tp_pp import (
    from_3d_layout,
    init_3d_state,
    make_3d_train_step,
    make_mesh_3d,
    shard_params_3d,
    shard_tokens_3d,
    to_3d_layout,
    unshard_params_3d,
)
from .moe import (
    EP_AXIS,
    MoEConfig,
    apply_moe_transformer,
    init_moe_params,
    init_moe_state,
    make_ep_mesh,
    make_moe_train_step,
    moe_mlp_local,
    shard_moe_batch,
    shard_params_moe,
    unshard_params_moe,
)
from .pp import (
    PP_AXIS,
    from_pp_layout,
    init_pp_state,
    make_pp_mesh,
    make_pp_train_step,
    shard_params_pp,
    to_pp_layout,
)
from .pp_moe import (
    init_pp_moe_state,
    make_mesh_pp_moe,
    make_pp_moe_train_step,
    shard_params_pp_moe,
    shard_tokens_pp_moe,
    unshard_params_pp_moe,
)
from .tp import (
    TP_AXIS,
    apply_transformer_tp,
    from_tp_layout,
    init_tp_state,
    make_tp_forward,
    make_tp_mesh,
    make_tp_train_step,
    shard_params_tp,
    to_tp_layout,
    tp_param_specs,
    vocab_parallel_nll,
)
