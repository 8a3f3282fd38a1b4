"""Parallel building blocks of the port: the stacked worker backend
(mesh.py), the flat state geometry and the piece stream of the per-leaf
and bucketed wires (buckets.py), the gradient aggregation wires
(collectives.py), the PS train step (ps.py), sequence parallelism
(ring_attention.py, ulysses.py), the dp x sp LM train step
(dp_sp.py), the LM's tensor (tp.py, dp_tp.py) and pipeline (pp.py)
parallelisms, its Mixture-of-Experts schemes (moe.py, ep_sp.py,
pp_moe.py) and the data x stage x tensor grid (dp_tp_pp.py). dp_sp and
ep_sp import the transformer model, which imports this package: import
them as modules. The PS engine's names (``PSConfig``, ``make_ps_train_step``
and the rest of ``ps.py``'s public names that JAX's package exports) load
on first use, for the same reason."""

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
from .buckets import (
    FlatVector,
    assemble_bucket,
    bucket_leaf_segments,
    leaves_from_buckets,
    readiness_bucket_order,
    tree_view,
)
from .collectives import aggregate_gradients, aggregation_mask, psum_mean, quantized_psum
from .mesh import (
    DCN_AXIS,
    WORKER_AXIS,
    initialize_multihost,
    make_hybrid_mesh,
    make_mesh,
    place_on_mesh,
)
from .overlap import grad_leaf_readiness
# the module ring_attention keeps its name here (JAX's package puts the
# function of that name in its place): callers import the module by it
from .ring_attention import (
    SEQ_AXIS,
    full_attention,
    make_ring_attention,
    make_seq_mesh,
    ring_flash_attention,
    shard_sequence,
)
from .ulysses import make_ulysses_attention, ulysses_attention

# the PS engine imports the models, which import this package: its names
# load on first use
_PS_NAMES = ("PSConfig", "PSTrainState", "init_ps_state", "make_ps_eval_step",
             "make_ps_train_step", "state_plan")


def __getattr__(name):
    if name in _PS_NAMES:
        from . import ps

        return getattr(ps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
