"""Port parity: the PS train step on the stacked worker backend
(ps_pytorch_tpu_torch.parallel.ps, optim, resilience.guard) against the
JAX package's ``make_ps_train_step`` on the 8-device CPU mesh.

Both sides start from the same LeNet weights (JAX's init, carried across
as numpy), see the same batches (synthetic MNIST, 4 images per worker)
and, where random_k masks, the same permutation: the port is handed the
one JAX draws from ``fold_in(fold_in(key, step), 0xA66)``.

Tolerances, on the flat master params after each step, relative to the
largest change of any param so far (``max|p_jax - p0|``):

- no compression: 1e-5. The two frameworks' f32 convolutions and
  reductions add in different orders.
- int8 wire: 1e-2. The wire itself is bit-exact on equal gradients
  (tests/test_torch_collectives.py), but the gradients differ in their
  last bits, and an element whose ``x * inv`` lies within that distance
  of a half rounds the other way: one quantization step (absmax/127 of
  its leaf, times lr/K) for that element. After the first step every
  later gradient differs slightly, so such flips accumulate; the bound
  keeps them below 1% of the update. On the first step at most 1% of
  the elements may differ by more than 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.data import make_preprocessor as jpreprocessor
from ps_pytorch_tpu.models import build_model as jbuild
from ps_pytorch_tpu.optim import sgd_flat as jsgd_flat
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.parallel import init_ps_state as jinit_state
from ps_pytorch_tpu.parallel import make_ps_train_step as jmake_step
from ps_pytorch_tpu.parallel import shard_batch, shard_state, tree_view
from ps_pytorch_tpu.resilience.faults import FaultPlan as JFaultPlan
from ps_pytorch_tpu_torch.data import make_preprocessor, make_synthetic
from ps_pytorch_tpu_torch.models import build_model, cnn_from_jax
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
from ps_pytorch_tpu_torch.parallel.ps import (
    PSConfig,
    StepDraws,
    init_ps_state,
    make_ps_train_step,
    state_plan,
    wire_align,
)
from ps_pytorch_tpu_torch.resilience.faults import FaultPlan
from tests.test_torch_one_thread import _one_thread  # noqa: F401


N = 8
B = 4  # images per worker
LR, MOMENTUM = 0.02, 0.9
KEY = jax.random.key(1)


def _batches(steps, seed=0, name="MNIST"):
    d = make_synthetic(name, train_size=N * B * steps, test_size=8, seed=seed)
    return [{"image": d.train_images[i * N * B:(i + 1) * N * B],
             "label": d.train_labels[i * N * B:(i + 1) * N * B]} for i in range(steps)]


def _jax_perm(step):
    k_mask = jax.random.fold_in(jax.random.fold_in(KEY, step), 0xA66)
    return torch.from_numpy(np.asarray(jax.random.permutation(k_mask, N)).astype(np.int64))


def _pair(mesh, cfg_kw, jmodel=None, tmodel=None, shape=(28, 28, 1), dataset="MNIST",
          jpre=None, tpre=None, faults=None):
    """(JAX state, JAX step, port state, port step, flat params0) on the
    same initial weights."""
    jmodel = jmodel or jbuild("LeNet")
    tmodel = tmodel or build_model("LeNet")
    jcfg, tcfg = JPSConfig(num_workers=N, **cfg_kw), PSConfig(num_workers=N, **cfg_kw)
    jtx = jsgd_flat(LR, momentum=MOMENTUM)
    ttx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    js = jinit_state(jmodel, jtx, jcfg, jax.random.key(0), shape)
    params0 = jax.tree.map(np.asarray, jax.device_get(tree_view(js.params)))
    bs0 = jax.tree.map(np.asarray, jax.device_get(js.batch_stats))
    flat0 = np.asarray(js.params.flat)
    js = shard_state(js, mesh, jcfg)
    jpre = jpre or jpreprocessor(dataset, train=True)
    tpre = tpre or make_preprocessor(dataset, train=True)
    jstep = jmake_step(jmodel, jtx, jcfg, mesh, preprocess=jpre, donate=False,
                       faults=JFaultPlan(**faults) if faults else None)
    tp, tbs = cnn_from_jax(params0, bs0, device="cpu")
    ts = init_ps_state(tmodel, ttx, tcfg, params=tp, batch_stats=tbs, device="cpu")
    tstep = make_ps_train_step(tmodel, ttx, tcfg, preprocess=tpre,
                               faults=FaultPlan(**faults) if faults else None,
                               device="cpu")
    return jcfg, js, jstep, ts, tstep, flat0


def _check(jflat, tflat, flat0, compress, first):
    moved = max(np.abs(jflat - flat0).max(), 1e-12)
    d = np.abs(jflat - tflat)
    assert jflat.shape == tflat.shape
    if compress is None:
        assert d.max() <= 1e-5 * moved, (d.max(), moved)
    else:
        assert d.max() <= 1e-2 * moved, (d.max(), moved)
        if first:
            assert (d > 1e-6).mean() <= 0.01, (d > 1e-6).sum()


WIRES = [(None, 0, False), ("int8", 0, False), ("int8", 128, False),
         ("int8", 0, True), ("int8", 128, True)]


@pytest.mark.parametrize("num_aggregate", [None, 5])
@pytest.mark.parametrize("compress,block,ef", WIRES)
def test_torch_ps_lenet_trajectory_matches_jax(mesh, compress, block, ef, num_aggregate):
    """One step, then a 3-step trajectory (momentum, EF residuals and
    masks carried), for every wire, with and without random_k masking."""
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, dict(
        compress=compress, quant_block_size=block, error_feedback=ef,
        num_aggregate=num_aggregate))
    for i, batch in enumerate(_batches(3)):
        js, jm = jstep(js, shard_batch(batch, mesh, jcfg), KEY)
        ts, tm = tstep(ts, batch, StepDraws(perm=_jax_perm(i)))
        _check(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, compress, i == 0)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
        assert float(tm["skipped_steps"]) == 0.0
        if ef:
            for a, b in zip(tree_leaves(ts.comm_state),
                            jax.tree_util.tree_leaves(js.comm_state)):
                assert tuple(a.shape) == np.shape(b)
    assert ts.step == 3
    assert int(ts.opt_state.count) == int(js.opt_state.count) == 3


def test_torch_ps_nan_step_is_the_identity_update(mesh):
    """A NaN injected into every gradient at step 2 (the fault plan):
    params, momentum and the optimizer count stay what they were, and the
    guard counts one skipped step, as JAX's does."""
    faults = {"nan_grads": [2]}
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, dict(compress="int8"), faults=faults)
    b1, b2 = _batches(2)
    js, _ = jstep(js, shard_batch(b1, mesh, jcfg), KEY)
    ts, _ = tstep(ts, b1, StepDraws())
    before = ts.params.flat.clone()
    buf = ts.opt_state.momentum_buffer.clone()
    js, jm = jstep(js, shard_batch(b2, mesh, jcfg), KEY)
    ts, tm = tstep(ts, b2, StepDraws())
    assert torch.equal(ts.params.flat, before)
    assert torch.equal(ts.opt_state.momentum_buffer, buf)
    assert int(ts.opt_state.count) == int(js.opt_state.count) == 1
    assert float(tm["skipped_steps"]) == float(jm["skipped_steps"]) == 1.0
    assert float(tm["skip_streak"]) == float(jm["skip_streak"]) == 1.0
    assert int(ts.guard_state.skipped) == 1


def _jax_poison_pre(key, images):
    """JAX side: normalize, and NaN for a shard whose pixels are all 255
    (no synthetic image is)."""
    x = jpreprocessor("MNIST", True)(key, images)
    return jnp.where(jnp.all(images == 255), jnp.nan, x)


class _PortPoisonPre:
    """The port's twin of ``_jax_poison_pre``."""

    augment = False

    def __call__(self, images, draws=None):
        x = make_preprocessor("MNIST", True)(images)
        return torch.where((images == 255).all(), torch.full_like(x, float("nan")), x)


def test_torch_ps_nan_in_a_masked_out_worker_still_skips(mesh):
    """The guard checks every worker's gradients before the mask
    (ps.py:1227-1242): a NaN from a worker the random_k mask drops still
    skips the step, on both sides."""
    jcfg, js, jstep, ts, tstep, flat0 = _pair(
        mesh, dict(compress="int8", num_aggregate=5),
        jpre=_jax_poison_pre, tpre=_PortPoisonPre())
    perm = _jax_perm(0)
    dropped = int(perm[5])  # perm[:5] enter the sum
    batch = _batches(1)[0]
    batch["image"] = batch["image"].copy()
    batch["image"][dropped * B:(dropped + 1) * B] = 255
    js, jm = jstep(js, shard_batch(batch, mesh, jcfg), KEY)
    ts, tm = tstep(ts, batch, StepDraws(perm=perm))
    assert float(jm["skipped_steps"]) == float(tm["skipped_steps"]) == 1.0
    np.testing.assert_array_equal(np.asarray(js.params.flat), flat0)
    np.testing.assert_array_equal(ts.params.flat.numpy(), flat0)


def test_torch_ps_state_geometry_matches_jax():
    """wire_align / state_plan: the flat state's padding is JAX's."""
    from ps_pytorch_tpu.parallel.ps import state_plan as jstate_plan
    from ps_pytorch_tpu.parallel.ps import wire_align as jwire_align

    for kw in (dict(), dict(compress="int8"), dict(compress="int8", quant_block_size=128),
               dict(quant_block_size=128)):
        j, t = JPSConfig(num_workers=N, **kw), PSConfig(num_workers=N, **kw)
        assert wire_align(t) == jwire_align(j)
        tp, jp = state_plan(t, 431080), jstate_plan(j, 431080)
        assert (tp.padded_total, tp.align, tp.starts, tp.sizes) == (
            jp.padded_total, jp.align, jp.starts, jp.sizes)


@pytest.mark.parametrize("kw", [
    dict(opt_placement="sharded", overlap="pipelined"),
    dict(overlap="pipelined", bucket_bytes=0),
    dict(dcn_hosts=2), dict(compress="int8_2round", dcn_hosts=2),
    dict(precision_adapt=True, compress="int8", bucket_bytes=0),
    dict(compress="int8", quant_rounding="stochastic"),
    dict(num_aggregate_min=2, num_aggregate_max=4),
])
def test_torch_ps_config_refuses_unported_paths(kw):
    """Every path here was refused before its port and builds as JAX's
    does now: the pipelined schedule and the hierarchical wire (the axis
    becomes JAX's tuple), adaptive precision, stochastic rounding and the
    adaptive count."""
    cfg, jcfg = PSConfig(num_workers=N, **kw), JPSConfig(num_workers=N, **kw)
    assert (cfg.adaptive_aggregate, cfg.initial_aggregate) == (
        jcfg.adaptive_aggregate, jcfg.initial_aggregate)
    assert (cfg.axis_name, cfg.overlap, cfg.dcn_hosts) == (
        jcfg.axis_name, jcfg.overlap, jcfg.dcn_hosts)


def test_torch_ps_synced_bn_step_runs():
    """Once refused: ``bn_mode="synced"`` with a synced-BN model (a small
    VGG-BN at 8 workers) takes a step, and its new running stats come from
    every worker's rows pooled (tests/test_torch_synced_bn.py holds the
    step against JAX's)."""
    from ps_pytorch_tpu_torch.models import VGG, init_model
    from ps_pytorch_tpu_torch.models.common import conv, nhwc_to_nchw
    from ps_pytorch_tpu_torch.parallel.mesh import WORKER_AXIS
    from ps_pytorch_tpu_torch.parallel.ps import draw_step

    model = VGG(cfg=(8, "M"), batch_norm=True, bn_axis_name=WORKER_AXIS)
    tx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    cfg = PSConfig(num_workers=N, bn_mode="synced", compress="int8")
    pre = make_preprocessor("Cifar10", True)
    params, bs = init_model(model, torch.Generator().manual_seed(1), device="cpu")
    st = init_ps_state(model, tx, cfg, params=params, batch_stats=bs, device="cpu")
    step = make_ps_train_step(model, tx, cfg, preprocess=pre, device="cpu")
    batch = _batches(1, name="Cifar10")[0]
    draws = draw_step(cfg, 0, 0, B, pre, model)
    st, m = step(st, batch, draws)
    assert np.isfinite(float(m["loss"])) and float(m["skipped_steps"]) == 0.0
    x = torch.cat([pre(torch.as_tensor(batch["image"][w * B:(w + 1) * B]), draws.aug[w])
                   for w in range(N)])
    var, mean = torch.var_mean(conv(nhwc_to_nchw(x.float()), params["Conv_0"], 1, 1),
                               dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(st.batch_stats["BatchNorm_0"]["mean"], 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(st.batch_stats["BatchNorm_0"]["var"], 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)


def test_torch_ps_step_leaves_no_reference_cycle():
    """A step's tensors are freed by reference counting: none waits in a
    reference cycle for the garbage collector, which on the card would
    keep a step's gradients allocated until a collection (a small VGG-BN
    with Dropout, the int8 wire, 5 of 8 workers aggregated)."""
    import gc

    from ps_pytorch_tpu_torch.models import VGG, init_model

    model = VGG(cfg=(8, "M"), batch_norm=True)
    tx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    cfg = PSConfig(num_workers=N, num_aggregate=5, compress="int8")
    params, bs = init_model(model, torch.Generator().manual_seed(1), device="cpu")
    st = init_ps_state(model, tx, cfg, params=params, batch_stats=bs, device="cpu")
    step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("Cifar10", True),
                              device="cpu")
    batch = _batches(1, name="Cifar10")[0]
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            st, m = step(st, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [tuple(o.shape) for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert np.isfinite(float(m["loss"]))
    assert cyclic == []


def test_torch_ps_config_keeps_jax_validation():
    with pytest.raises(ValueError, match="error_feedback needs a compress mode"):
        PSConfig(num_workers=N, error_feedback=True)
    with pytest.raises(ValueError):
        PSConfig(num_workers=N, grad_accum_steps=0)


def test_torch_ps_grad_accum_matches_jax(mesh):
    """grad_accum_steps=2: two microbatches per worker, grads averaged
    (`/ 2` as XLA runs it)."""
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, dict(grad_accum_steps=2))
    batch = _batches(1)[0]
    js, _ = jstep(js, shard_batch(batch, mesh, jcfg), KEY)
    ts, _ = tstep(ts, batch, StepDraws())
    _check(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, None, True)
