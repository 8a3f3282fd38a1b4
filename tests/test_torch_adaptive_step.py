"""The slice as a whole: the PS train step (ps_pytorch_tpu_torch.parallel
.ps) on the adaptive wire against the JAX package's
``make_ps_train_step`` on the 8-device CPU mesh: LeNet, N=8, the weights,
batches and permutations of tests/test_torch_ps.py, 2 steps.

- the adaptive count (JAX's traced ``agg_count``, the port's device
  int32) on the int8, the two-round dequant and homomorphic wires and
  ZeRO-1;
- mixed precision tags (JAX's ``prec_tags``) on the bucketed int8 and
  two-round homomorphic wires, with and without the count;

each within the int8 tolerance the PS parity tests state (1e-2 of the
largest update; on the first step at most 1% of the params beyond
1e-6), times the count K on the homomorphic two-round wire (chip_smoke
phase 13's rule: K3 rounds ``acc / K`` onto the round-1 lattice, so a
flip there is worth K of the dequant wire's), and with
``bucket_sqnorm`` within 1e-5 of JAX's. Against the
port's own static step: the full count is bit for bit; all-int8 tags
move each lattice scale by at most one ulp (a quotient by the tag's
peak where the static wire multiplies by f32(1/127), as in JAX), which
stays within 1e-6 of the largest update over the two steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.parallel import shard_batch
from ps_pytorch_tpu_torch.parallel.ps import StepDraws, state_plan
from tests.test_torch_adaptive_wire import jax_draws
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_ps import KEY, _batches, _jax_perm, _pair


STEPS = 2


def _check_scaled(jflat, tflat, flat0, first, factor):
    """tests/test_torch_ps.py's int8 rule, its bound times ``factor``."""
    moved = max(np.abs(jflat - flat0).max(), 1e-12)
    d = np.abs(jflat - tflat)
    assert jflat.shape == tflat.shape
    assert d.max() <= 1e-2 * factor * moved, (d.max(), moved)
    if first:
        assert (d > 1e-6).mean() <= 0.01, (d > 1e-6).sum()


def _run(mesh, kw, count=None, tags=None, stochastic=False, steps=STEPS):
    """Both steps over ``steps`` batches (``stochastic``: the port fed
    JAX's rounding draws); returns the final states."""
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, kw)
    extras_j, extras_t = [], {}
    if count is not None:
        extras_j.append(jnp.int32(count))
        extras_t["agg_count"] = torch.tensor(count, dtype=torch.int32)
    if tags is not None:
        extras_j.append(jnp.asarray(tags, jnp.int32))
        extras_t["prec_tags"] = torch.tensor(tags, dtype=torch.int32)
    two_round_hom = kw.get("compress") == "int8_2round" and kw.get("wire_domain") == "homomorphic"
    factor = (count or 8) if two_round_hom else 1
    for i, batch in enumerate(_batches(steps, seed=2)):
        js, jm = jstep(js, shard_batch(batch, mesh, jcfg), KEY, *extras_j)
        draws = StepDraws(perm=_jax_perm(i))
        if stochastic:
            draws.rounding = jax_draws(jax.random.fold_in(jax.random.fold_in(KEY, i), 0x5E))
        ts, tm = tstep(ts, batch, draws, **extras_t)
        _check_scaled(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, i == 0,
                      factor)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
        assert float(tm["skipped_steps"]) == 0.0
        if tags is not None:
            sq_j, sq_t = np.asarray(jm["bucket_sqnorm"]), tm["bucket_sqnorm"].numpy()
            assert sq_t.shape == sq_j.shape == (len(tags),)
            np.testing.assert_allclose(sq_t, sq_j, rtol=1e-5)
    return js, ts, flat0


ADAPTIVE = dict(num_aggregate_min=3, num_aggregate_max=8)


@pytest.mark.parametrize("kw,count", [
    (dict(compress="int8"), 5),
    (dict(compress="int8_2round", bucket_bytes=0), 4),
    (dict(compress="int8_2round", bucket_bytes=0, wire_domain="homomorphic"), 6),
    (dict(compress="int8", opt_placement="sharded", error_feedback=True), 5),
], ids=["int8", "2round_dequant", "2round_homomorphic", "zero1_ef"])
def test_torch_traced_count_step_matches_jax(mesh, kw, count):
    _run(mesh, dict(kw, **ADAPTIVE), count=count)


@pytest.mark.parametrize("kw,count", [
    (dict(compress="int8", wire_domain="homomorphic", bucket_bytes=65536), None),
    (dict(compress="int8_2round", wire_domain="homomorphic", bucket_bytes=65536,
          **ADAPTIVE), 7),
], ids=["int8_homomorphic", "2round_homomorphic_count"])
def test_torch_mixed_tags_step_matches_jax(mesh, kw, count):
    kw = dict(kw, precision_adapt=True)
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig

    n_buckets = state_plan(PSConfig(num_workers=8, **kw), 431080).n_buckets
    assert n_buckets >= 4
    tags = (np.arange(n_buckets) + 1) % 4  # 4-bit, int8, hi, skip, ...
    _run(mesh, kw, count=count, tags=tags)


def _port(kw, seed=0):
    """The port's state and step alone (no JAX side), LeNet from
    ``seed``: the same params for every config of one seed."""
    from ps_pytorch_tpu_torch.data import make_preprocessor
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step

    cfg = PSConfig(num_workers=8, **kw)
    model, tx = build_model("LeNet"), build_optimizer("sgd", 0.02, momentum=0.9)
    state = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(seed), device="cpu")
    return state, make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("MNIST", True),
                                     device="cpu")


def test_torch_full_count_and_int8_tags_against_the_static_step():
    """The adaptive step at the full count is the static step bit for
    bit (the mask multiplies by 1.0, the quotient by 8 is exact); all
    tags int8 differ only through the lattice scale's division."""
    kw = dict(compress="int8_2round", bucket_bytes=65536, wire_domain="homomorphic",
              error_feedback=True)
    batches = _batches(STEPS, seed=3)
    s_static, step_static = _port(kw)
    s_count, step_count = _port(dict(kw, **ADAPTIVE))
    s_tags, step_tags = _port(dict(kw, precision_adapt=True))
    flat0 = s_static.params.flat.clone()
    int8 = torch.full((s_tags.params.plan.n_buckets,), 2, dtype=torch.int32)
    for i, batch in enumerate(batches):
        s_static, _ = step_static(s_static, batch, StepDraws(perm=_jax_perm(i)))
        s_count, _ = step_count(s_count, batch, StepDraws(perm=_jax_perm(i)),
                                agg_count=torch.tensor(8, dtype=torch.int32))
        s_tags, _ = step_tags(s_tags, batch, StepDraws(perm=_jax_perm(i)), prec_tags=int8)
    assert torch.equal(s_count.params.flat, s_static.params.flat)
    for a, b in zip(jax.tree_util.tree_leaves(s_count.comm_state),
                    jax.tree_util.tree_leaves(s_static.comm_state)):
        assert torch.equal(a, b)
    moved = float((s_static.params.flat - flat0).abs().max())
    assert float((s_tags.params.flat - s_static.params.flat).abs().max()) <= 1e-6 * moved


def test_torch_adaptive_step_clamps_its_arguments_on_the_device():
    """A count above the max bound runs as the max, tags outside [0, 3]
    run clamped: the same params as the in-range values."""
    kw = dict(compress="int8", bucket_bytes=65536, precision_adapt=True, **ADAPTIVE)
    batch = _batches(1, seed=4)[0]
    s1, step1 = _port(kw)
    s2, step2 = _port(kw)
    nb = s1.params.plan.n_buckets
    s1, _ = step1(s1, batch, StepDraws(perm=_jax_perm(0)),
                  agg_count=torch.tensor(99, dtype=torch.int32),
                  prec_tags=torch.tensor([9] * nb, dtype=torch.int32))
    s2, _ = step2(s2, batch, StepDraws(perm=_jax_perm(0)),
                  agg_count=torch.tensor(8, dtype=torch.int32),
                  prec_tags=torch.tensor([3] * nb, dtype=torch.int32))
    assert torch.equal(s1.params.flat, s2.params.flat)
    with pytest.raises(ValueError, match="agg_count"):
        step1(s1, batch, StepDraws(perm=_jax_perm(1)), prec_tags=torch.zeros(nb))
