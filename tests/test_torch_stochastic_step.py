"""The PS train step under stochastic rounding (ps_pytorch_tpu_torch
.parallel.ps, ``quant_rounding="stochastic"``) against the JAX package's
``make_ps_train_step`` on the 8-device CPU mesh: LeNet, N=8, 2 steps, on
the fused int8 wire with error feedback, the fused two-round dequant
wire at block 128 and ZeRO-1's int8 wire in 64 KiB buckets (a bucket's
draws fold its start offset; the per-leaf and bucketed wires' draws are
held bit for bit in tests/test_torch_adaptive_wire.py). The port is fed JAX's draws through
``StepDraws.rounding``: the key ``fold_in(fold_in(key, step), 0x5E)``,
then the worker, the piece's key id (a leaf's index, a bucket's start
offset) and, for round 2, 1 (tests/test_torch_adaptive_wire.py's
``jax_draws``). Held to tests/test_torch_adaptive_step.py's int8 rule.
"""

import pytest

from tests.test_torch_adaptive_step import _run


@pytest.mark.parametrize("kw", [
    dict(compress="int8", num_aggregate=5, error_feedback=True, bucket_bytes=0),
    dict(compress="int8_2round", quant_block_size=128, bucket_bytes=0),
    dict(compress="int8", opt_placement="sharded", bucket_bytes=65536, error_feedback=True),
], ids=["int8_ef", "2round_block128", "zero1_ef"])
def test_torch_stochastic_step_matches_jax_with_its_draws(mesh, kw):
    _run(mesh, dict(kw, quant_rounding="stochastic"), stochastic=True)
