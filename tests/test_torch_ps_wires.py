"""The slice as a whole: the PS train step on the bucketed, two-round and
homomorphic wires (ps_pytorch_tpu_torch.parallel.ps through
collectives / buckets / K3's plain version) against the JAX package's
``make_ps_train_step`` on the 8-device CPU mesh, and ``cli.train`` on
the autotune-best flags.

LeNet, N=8, same weights, batches and random_k permutations as
tests/test_torch_ps.py, 3 steps, held to its stated int8 tolerance
(1e-2 of the largest update; on the first step at most 1% of the params
beyond 1e-6): the wires are bit-exact on equal gradients
(tests/test_torch_wires.py, tests/test_torch_homomorphic.py), the
gradients differ in their last bits.
"""

import math

import jax
import numpy as np
import pytest

from ps_pytorch_tpu.parallel import shard_batch
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
from ps_pytorch_tpu_torch.parallel.ps import StepDraws
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_ps import KEY, _batches, _check, _jax_perm, _pair
from tests.test_torch_trainer import _run

CONFIGS = {
    # runs/autotune_resnet18.json "best"
    "autotune_best": dict(compress="int8_2round", bucket_bytes=0, wire_domain="homomorphic",
                          num_aggregate=5),
    "int8_homomorphic_64k_ef": dict(compress="int8", bucket_bytes=65536,
                                    wire_domain="homomorphic", error_feedback=True,
                                    num_aggregate=5),
    "2round_dequant_block128": dict(compress="int8_2round", quant_block_size=128),
    "autotune_best_ef": dict(compress="int8_2round", bucket_bytes=0,
                             wire_domain="homomorphic", num_aggregate=5,
                             error_feedback=True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_ps_wire_trajectory_matches_jax(mesh, name):
    kw = CONFIGS[name]
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, kw)
    for i, batch in enumerate(_batches(3, seed=1)):
        js, jm = jstep(js, shard_batch(batch, mesh, jcfg), KEY)
        ts, tm = tstep(ts, batch, StepDraws(perm=_jax_perm(i)))
        _check(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, "int8", i == 0)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
        assert float(tm["skipped_steps"]) == 0.0
    if kw.get("error_feedback"):
        for a, b in zip(tree_leaves(ts.comm_state), jax.tree_util.tree_leaves(js.comm_state)):
            assert tuple(a.shape) == np.shape(b)
    assert int(ts.opt_state.count) == int(js.opt_state.count) == 3


@pytest.mark.parametrize("extra", [
    ["--compress-grad", "2round", "--bucket-bytes", "0", "--wire-domain", "homomorphic",
     "--num-aggregate", "5"],
    ["--opt-placement", "sharded", "--compress-grad", "compress", "--wire-domain",
     "homomorphic", "--error-feedback", "--bucket-bytes", "65536"],
])
def test_torch_cli_train_runs_the_new_wires(extra):
    out = _run("--max-steps", "3", *extra)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert out["train"]["skipped_steps"] == 0.0
