"""Port parity: synced (cross-worker) BatchNorm in the PS step
(``bn_mode="synced"`` with a model built with ``bn_axis_name``) against
the JAX package's ``make_ps_train_step`` on a 2-device slice of the
virtual CPU mesh.

JAX runs the workers under ``shard_map(..., check_vma=False)``: flax's
BatchNorm pmeans its batch statistics over the worker axis, and the
transpose of that pmean sends every worker's loss back into every
worker's copy of the params, so worker j's gradient is
``d(sum_i L_i) / d theta_j``. The port runs both workers' rows in one
layer-synchronous forward over worker-stacked copies of the leaves and
one backward of the summed losses. This test settles the semantics: one
step of the ``(1, 1, 1, 1)`` BasicBlock ResNet at N=2, 4 images each, on
JAX's weights, lands within 1e-3 of the update of JAX's params
(``max|p_jax - p0|``; the two frameworks' f32 convolutions and flax's
``E[x^2] - E[x]^2`` variance differ in their last bits, and the small
ResNet's gradients are ill-conditioned at init), with the same loss
(rtol 1e-5) and running stats (2e-5 of the largest). Two controls land
far outside the bound: the same step with local statistics
(``bn_mode="pmean"``), and the same synced forward with each worker's
gradient taken from its own loss alone (``d L_j / d theta_j``, the
cross-worker terms dropped), so the bound decides the gradient
semantics, not only the forward.

Synced BN under ``bn_mode="local"``: the running stats stay stacked
``[N, ...]`` per worker, each row updated from its own old row and the
batch statistics every worker shares (JAX's ps.py:548-551, 1134,
1324-1325). Two steps at N=4 of the same ResNet on the int8 wire, from
distinct per-worker rows, against JAX's jitted ``make_ps_train_step``:
the params within 1e-2 of the largest update (the int8 wire's bound of
tests/test_torch_ps.py: an element whose ``x * inv`` lies within the two
frameworks' last-bit difference of a half rounds the other way, one
quantization step of its leaf), at most 1% of them off by more than 1e-6
after the first step, the loss within rtol 1e-5 and every stats row
within 2e-5 of the largest (this file's bounds). One thread, so the
convolutions add in one order on every run.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import checkpoint as jckpt

from ps_pytorch_tpu.data import make_preprocessor as jpreprocessor
from ps_pytorch_tpu.models.resnet import BasicBlock as JBasic
from ps_pytorch_tpu.models.resnet import ResNet as JResNet
from ps_pytorch_tpu.optim import sgd_flat as jsgd_flat
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.parallel import init_ps_state as jinit_state
from ps_pytorch_tpu.parallel import make_ps_train_step as jmake_step
from ps_pytorch_tpu.parallel import shard_batch, shard_state, tree_view
from ps_pytorch_tpu.parallel.mesh import WORKER_AXIS, make_mesh
from ps_pytorch_tpu_torch import checkpoint as tckpt
from ps_pytorch_tpu_torch.data import make_preprocessor, make_synthetic
from ps_pytorch_tpu_torch.models import BasicBlock, ResNet, cnn_from_jax
from ps_pytorch_tpu_torch.models import common
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves, tree_map
from ps_pytorch_tpu_torch.parallel.ps import (
    PSConfig,
    StepDraws,
    init_ps_state,
    make_ps_train_step,
)
from ps_pytorch_tpu_torch.trainer import Trainer

N, B = 2, 4


@pytest.fixture(scope="module")
def jax_step():
    """JAX's synced step from its own init, and the weights it started at."""
    mesh = make_mesh(num_workers=N)
    jmodel = JResNet(block=JBasic, num_blocks=(1, 1, 1, 1), bn_axis_name=WORKER_AXIS)
    jcfg = JPSConfig(num_workers=N, bn_mode="synced")
    jtx = jsgd_flat(0.02, momentum=0.9)
    def init(key):
        return jinit_state(jmodel, jtx, jcfg, key, (32, 32, 3))

    js = jax.jit(init)(jax.random.key(0))
    p0 = jax.tree.map(np.asarray, jax.device_get(tree_view(js.params)))
    bs0 = jax.tree.map(np.asarray, jax.device_get(js.batch_stats))
    flat0 = np.asarray(js.params.flat)
    step = jmake_step(jmodel, jtx, jcfg, mesh, preprocess=jpreprocessor("Cifar10", train=False),
                      donate=False)
    d = make_synthetic("Cifar10", train_size=N * B, test_size=8, seed=0)
    batch = {"image": d.train_images, "label": d.train_labels}
    js, jm = step(shard_state(js, mesh, jcfg), shard_batch(batch, mesh, jcfg),
                  jax.random.key(1))
    return p0, bs0, flat0, batch, js, jm


def _port_step(p0, bs0, batch, bn_mode, synced):
    model = ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1),
                   bn_axis_name=WORKER_AXIS if synced else None)
    cfg = PSConfig(num_workers=N, bn_mode=bn_mode)
    tx = build_optimizer("sgd", 0.02, momentum=0.9)
    params, bs = cnn_from_jax(p0, bs0, device="cpu")
    st = init_ps_state(model, tx, cfg, params=params, batch_stats=bs, device="cpu")
    step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("Cifar10", False),
                              device="cpu")
    return step(st, batch, StepDraws())


def test_torch_synced_bn_step_matches_jax(jax_step):
    p0, bs0, flat0, batch, js, jm = jax_step
    ts, tm = _port_step(p0, bs0, batch, "synced", synced=True)
    jflat, tflat = np.asarray(js.params.flat), ts.params.flat.numpy()
    moved = np.abs(jflat - flat0).max()
    assert np.abs(jflat - tflat).max() <= 1e-3 * moved, (np.abs(jflat - tflat).max(), moved)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(ts.batch_stats), jax.tree_util.tree_leaves(js.batch_stats)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 2e-5 * max(np.abs(b).max(), 1e-6)


def test_torch_synced_bn_differs_from_local_statistics(jax_step):
    """The bound above discriminates: local per-worker statistics (the
    pmean mode, a model without ``bn_axis_name``) move the params far
    outside it."""
    p0, bs0, flat0, batch, js, _ = jax_step
    ts, _ = _port_step(p0, bs0, batch, "pmean", synced=False)
    jflat = np.asarray(js.params.flat)
    moved = np.abs(jflat - flat0).max()
    assert np.abs(jflat - ts.params.flat.numpy()).max() > 1e-2 * moved


def _own_loss_batch_norm(x, scale, bias, stats, train, new_stats, name):
    """Synced BatchNorm's forward, but worker i's rows see the other
    workers' rows detached in the shared statistics: the values are the
    same, and worker i's loss reaches only worker i's copy."""
    assert train
    n = scale.shape[0]
    new_stats[name] = common._running(stats, x)
    parts = x.float().chunk(n)
    out = []
    for i in range(n):
        pooled = torch.cat([p if j == i else p.detach() for j, p in enumerate(parts)])
        var, mean = torch.var_mean(pooled, dim=(0, 2, 3), unbiased=False)
        xhat = (parts[i] - mean[:, None, None]) * torch.rsqrt(var + common.BN_EPS)[:, None, None]
        out.append(xhat * scale[i][:, None, None] + bias[i][:, None, None])
    return torch.cat(out).to(x.dtype)


def test_torch_synced_bn_differs_without_cross_worker_terms(jax_step, monkeypatch):
    """The bound discriminates the gradient too: the synced forward with
    each worker's gradient from its own loss alone lands on JAX's loss
    (rtol 1e-5) but moves the params far outside the bound."""
    p0, bs0, flat0, batch, js, jm = jax_step
    monkeypatch.setattr(common, "_synced_batch_norm", _own_loss_batch_norm)
    ts, tm = _port_step(p0, bs0, batch, "synced", synced=True)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    jflat = np.asarray(js.params.flat)
    moved = np.abs(jflat - flat0).max()
    assert np.abs(jflat - ts.params.flat.numpy()).max() > 1e-2 * moved


# ------------------------------------------- synced BN under bn_mode="local"

NL = 4


def _distinct_rows(stacked):
    """Each worker's own running stats: JAX's stacked init rows moved
    apart (means shifted, variances scaled), from a seeded numpy draw."""
    rng = np.random.RandomState(3)

    def move(path, a):
        off = rng.uniform(-0.5, 0.5, size=a.shape).astype(np.float32)
        return a + off if "mean" in jax.tree_util.keystr(path) else (a * np.exp(off))
    return jax.tree_util.tree_map_with_path(move, stacked)


def _port_local(p0, rows, bn_mode, batches):
    """The port's synced model from JAX's weights, ``rows`` as its running
    stats (stacked under bn_mode local, their mean otherwise), stepped
    through ``batches`` on the int8 wire on one thread."""
    model = ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1), bn_axis_name=WORKER_AXIS)
    cfg = PSConfig(num_workers=NL, bn_mode=bn_mode, compress="int8")
    tx = build_optimizer("sgd", 0.02, momentum=0.9)
    params, stacked = cnn_from_jax(p0, rows, device="cpu")
    st = init_ps_state(model, tx, cfg, params=params,
                       batch_stats=tree_map(lambda r: r[0], stacked), device="cpu")
    st = dataclasses.replace(st, batch_stats=stacked if bn_mode == "local" else
                             tree_map(lambda r: r.mean(0), stacked))
    step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("Cifar10", False),
                              device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = []
        for batch in batches:
            st, m = step(st, batch, StepDraws())
            out.append((st.params.flat.clone(), float(m["loss"]),
                        [t.clone() for t in tree_leaves(st.batch_stats)]))
    finally:
        torch.set_num_threads(threads)
    return cfg, st, out


@pytest.fixture(scope="module")
def local_steps():
    """JAX's synced model under bn_mode local at N=4 on the int8 wire, two
    jitted steps from distinct per-worker rows; the port's from the same
    weights, rows and batches."""
    mesh = make_mesh(num_workers=NL)
    jmodel = JResNet(block=JBasic, num_blocks=(1, 1, 1, 1), bn_axis_name=WORKER_AXIS)
    jcfg = JPSConfig(num_workers=NL, bn_mode="local", compress="int8")
    jtx = jsgd_flat(0.02, momentum=0.9)
    def init(key):
        return jinit_state(jmodel, jtx, jcfg, key, (32, 32, 3))

    js = jax.jit(init)(jax.random.key(0))
    p0 = jax.tree.map(np.asarray, jax.device_get(tree_view(js.params)))
    rows = _distinct_rows(jax.tree.map(np.asarray, jax.device_get(js.batch_stats)))
    flat0 = np.asarray(js.params.flat)
    js = shard_state(js.replace(batch_stats=jax.tree.map(jax.numpy.asarray, rows)), mesh, jcfg)
    step = jmake_step(jmodel, jtx, jcfg, mesh, preprocess=jpreprocessor("Cifar10", train=False),
                      donate=False)
    d = make_synthetic("Cifar10", train_size=2 * NL * B, test_size=8, seed=0)
    batches = [{"image": d.train_images[i * NL * B:(i + 1) * NL * B],
                "label": d.train_labels[i * NL * B:(i + 1) * NL * B]} for i in range(2)]
    jout = []
    for batch in batches:
        js, jm = step(js, shard_batch(batch, mesh, jcfg), jax.random.key(1))
        jout.append((np.asarray(js.params.flat), float(jm["loss"]),
                     [np.asarray(b) for b in jax.tree_util.tree_leaves(js.batch_stats)]))
    cfg, ts, tout = _port_local(p0, rows, "local", batches)
    return dict(p0=p0, rows=rows, flat0=flat0, batches=batches, js=js, jout=jout, cfg=cfg,
                ts=ts, tout=tout)


def test_torch_synced_bn_local_two_int8_steps_match_jax(local_steps):
    """Two steps: params within 1e-2 of the largest update (at most 1% of
    them off by more than 1e-6 after the first), the loss within rtol
    1e-5, each worker's stats row within 2e-5 of the largest, stacked
    ``[4, C]`` as JAX's."""
    flat0 = local_steps["flat0"]
    for i, ((jflat, jloss, jbs), (tflat, tloss, tbs)) in enumerate(
            zip(local_steps["jout"], local_steps["tout"])):
        moved = np.abs(jflat - flat0).max()
        d = np.abs(jflat - tflat.numpy())
        assert d.max() <= 1e-2 * moved, (i, d.max(), moved)
        if i == 0:
            assert (d > 1e-6).mean() <= 0.01, (d > 1e-6).sum()
        assert tloss == pytest.approx(jloss, rel=1e-5)
        assert len(tbs) == len(jbs)
        for a, b in zip(tbs, jbs):
            assert tuple(a.shape) == b.shape and b.shape[0] == NL
            assert np.abs(a.numpy() - b).max() <= 2e-5 * max(np.abs(b).max(), 1e-6)


def test_torch_synced_bn_local_rows_differ_from_pmean_stats(local_steps):
    """The same synced steps with the stats averaged (bn_mode synced, from
    the rows' mean): the params are the local run's bit for bit (running
    stats never enter a training forward), the averaged stats are the
    mean of the local rows (the update is linear in the old row), and
    each local row stays apart from them by 0.9^2 of its start offset."""
    _, tp, tout = _port_local(local_steps["p0"], local_steps["rows"], "synced",
                              local_steps["batches"])
    lflat, _, lbs = local_steps["tout"][-1]
    pflat, _, pbs = tout[-1]
    assert torch.equal(lflat, pflat)
    start = jax.tree_util.tree_leaves(local_steps["rows"])
    for rows, avg, r0 in zip(lbs, pbs, start):
        assert rows.shape[0] == NL and tuple(avg.shape) == tuple(rows.shape[1:])
        scale = float(avg.abs().max())
        assert float((rows.mean(0) - avg).abs().max()) <= 2e-5 * max(scale, 1e-6)
        apart = (rows - avg).numpy()
        want = 0.81 * (r0 - r0.mean(0))
        assert np.abs(apart - want).max() <= 2e-5 * max(scale, 1e-6)
        assert np.abs(apart).max() > 0.1 * np.abs(want).max() > 0


def test_torch_synced_bn_local_checkpoint_in_jax_bytes(local_steps, tmp_path):
    """The trainer's checkpoint view of the synced-local state after two
    steps: JAX's reader restores its stacked rows bit for bit, JAX's
    writer gives the port's file byte for byte, and the port reads it
    back."""
    ts, cfg = local_steps["ts"], local_steps["cfg"]
    view = Trainer.checkpoint_state(SimpleNamespace(state=ts, multi=False, pcfg=cfg))
    tckpt.save_checkpoint(view, str(tmp_path / "port"), 2)
    jr = jckpt.load_checkpoint(jax.device_get(local_steps["js"]), str(tmp_path / "port"), 2)
    for a, b in zip(tree_leaves(ts.batch_stats), jax.tree_util.tree_leaves(jr.batch_stats)):
        assert a.shape[0] == NL and np.array_equal(a.numpy(), np.asarray(b))
    jckpt._write_host_state(jax.device_get(jr), str(tmp_path / "jax"), 2, compress=False)
    with open(os.path.join(tmp_path, "port", "model_step_2"), "rb") as f:
        port_bytes = f.read()
    with open(os.path.join(tmp_path, "jax", "model_step_2"), "rb") as f:
        assert f.read() == port_bytes
    back = tckpt.load_checkpoint(view, str(tmp_path / "jax"), 2)
    for a, b in zip(tree_leaves(ts.batch_stats), tree_leaves(back.batch_stats)):
        assert torch.equal(a, b)
