"""Parallel building blocks of the port: the stacked worker backend
(mesh.py), the flat state geometry and the piece stream of the per-leaf
and bucketed wires (buckets.py), the gradient aggregation wires
(collectives.py), the PS train step (ps.py), sequence parallelism
(ring_attention.py, ulysses.py), the dp x sp LM train step
(dp_sp.py), and the LM's tensor (tp.py, dp_tp.py) and pipeline (pp.py)
parallelisms."""

from .dp_tp import (
    init_dp_tp_state,
    make_dp_tp_train_step,
    make_mesh_dp_tp,
    shard_tokens_dp,
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
