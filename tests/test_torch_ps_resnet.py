"""Port parity: the PS train step on a ResNet (BatchNorm, the int8 wire)
against the JAX package's ``make_ps_train_step`` on the 8-device CPU mesh,
and the local BN mode. Helpers and tolerances: tests/test_torch_ps.py
(kept apart so each file stays well under a minute on the CPU).
"""

import jax
import numpy as np
import torch

from ps_pytorch_tpu.data import make_preprocessor as jpreprocessor
from ps_pytorch_tpu.models.resnet import BasicBlock as JBasic
from ps_pytorch_tpu.models.resnet import ResNet as JResNet
from ps_pytorch_tpu.parallel import shard_batch
from ps_pytorch_tpu_torch.data import make_preprocessor, make_synthetic
from ps_pytorch_tpu_torch.models import BasicBlock, ResNet
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
from ps_pytorch_tpu_torch.parallel.ps import (
    PSConfig,
    StepDraws,
    init_ps_state,
    make_ps_train_step,
)
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_ps import KEY, _batches, _check, _pair


def test_torch_ps_resnet_pmean_bn_step_matches_jax(mesh):
    """One step of a (1, 1, 1, 1) BasicBlock ResNet on synthetic CIFAR-10
    with bn_mode pmean (each worker's BN batch statistics, averaged) and
    the int8 wire, without augmentation so both sides see the same
    pixels."""
    jcfg, js, jstep, ts, tstep, flat0 = _pair(
        mesh, dict(compress="int8", bn_mode="pmean"),
        jmodel=JResNet(block=JBasic, num_blocks=(1, 1, 1, 1)),
        tmodel=ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1)), shape=(32, 32, 3),
        dataset="Cifar10", jpre=jpreprocessor("Cifar10", train=False),
        tpre=make_preprocessor("Cifar10", train=False))
    batch = _batches(1, name="Cifar10")[0]
    js, jm = jstep(js, shard_batch(batch, mesh, jcfg), KEY)
    ts, tm = tstep(ts, batch, StepDraws())
    _check(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, "int8", False)
    for a, b in zip(tree_leaves(ts.batch_stats), jax.tree_util.tree_leaves(js.batch_stats)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_torch_ps_local_bn_keeps_per_worker_stats():
    cfg = PSConfig(num_workers=4, bn_mode="local")
    model = ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1))
    tx = build_optimizer("sgd", 0.01, momentum=0.9)
    st = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tree_leaves(st.batch_stats)[0].shape[0] == 4
    step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("Cifar10", True),
                              device="cpu")
    d = make_synthetic("Cifar10", train_size=8, test_size=8)
    st, m = step(st, {"image": d.train_images, "label": d.train_labels})
    means = tree_leaves(st.batch_stats["BatchNorm_0"])[0]  # [4, 64]
    assert not torch.allclose(means[0], means[1])
    assert np.isfinite(float(m["loss"]))




def test_torch_ps_eval_step_matches_jax_after_a_step(mesh):
    """make_ps_eval_step after one pmean step: eval-mode BN reads the
    averaged running stats; loss and precision as JAX's."""
    from ps_pytorch_tpu.parallel import make_ps_eval_step as jmake_eval
    from ps_pytorch_tpu_torch.parallel.ps import make_ps_eval_step

    jcfg, js, jstep, ts, tstep, flat0 = _pair(
        mesh, dict(bn_mode="pmean"),
        jmodel=JResNet(block=JBasic, num_blocks=(1, 1, 1, 1)),
        tmodel=ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1)), shape=(32, 32, 3),
        dataset="Cifar10", jpre=jpreprocessor("Cifar10", train=False),
        tpre=make_preprocessor("Cifar10", train=False))
    batch = _batches(1, name="Cifar10")[0]
    js, _ = jstep(js, shard_batch(batch, mesh, jcfg), KEY)
    ts, _ = tstep(ts, batch, StepDraws())
    jeval = jmake_eval(JResNet(block=JBasic, num_blocks=(1, 1, 1, 1)), jcfg, mesh,
                       preprocess=jpreprocessor("Cifar10", train=False))
    teval = make_ps_eval_step(ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1)),
                              PSConfig(num_workers=8, bn_mode="pmean"),
                              preprocess=make_preprocessor("Cifar10", train=False),
                              device="cpu")
    test = _batches(1, seed=9, name="Cifar10")[0]
    jm = jeval(js, shard_batch(test, mesh, jcfg))
    tm = teval(ts, test)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-3)
    assert abs(float(tm["prec1"]) - float(jm["prec1"])) <= 100.0 / 32
