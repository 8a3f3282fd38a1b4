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
"""

import jax
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.data import make_preprocessor as jpreprocessor
from ps_pytorch_tpu.models.resnet import BasicBlock as JBasic
from ps_pytorch_tpu.models.resnet import ResNet as JResNet
from ps_pytorch_tpu.optim import sgd_flat as jsgd_flat
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.parallel import init_ps_state as jinit_state
from ps_pytorch_tpu.parallel import make_ps_train_step as jmake_step
from ps_pytorch_tpu.parallel import shard_batch, shard_state, tree_view
from ps_pytorch_tpu.parallel.mesh import WORKER_AXIS, make_mesh
from ps_pytorch_tpu_torch.data import make_preprocessor, make_synthetic
from ps_pytorch_tpu_torch.models import BasicBlock, ResNet, cnn_from_jax
from ps_pytorch_tpu_torch.models import common
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
from ps_pytorch_tpu_torch.parallel.ps import (
    PSConfig,
    StepDraws,
    init_ps_state,
    make_ps_train_step,
)

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
