"""Port parity: the CNN zoo of ps_pytorch_tpu_torch.models (LeNet, the
ResNet family with BasicBlock and Bottleneck) and the flax -> port
converter, against the JAX package's flax models on the same weights.

JAX weights come from ``init_model`` and cross as numpy arrays through
``cnn_from_jax`` (a copy: the port keeps flax's names and HWIO /
``[in, out]`` layouts). Compared: logits in eval and train mode, per-leaf
gradients of the cross-entropy, and train-mode BatchNorm statistics.
ResNets run at ``num_blocks=(1, 1, 1, 1)``; full ResNet18 depth runs only
on the card (chip_smoke.py).

Tolerances, relative to the largest reference magnitude: 2e-5 for logits
and BN stats, 1e-4 for gradients. The two frameworks' f32 convolutions
and reductions sum in different orders, and flax computes the batch
variance as E[x^2] - E[x]^2 where the port takes it in two passes.

The gradient oracle is the JAX model run in float64, which agrees with
the port run in float64 to 5e-8. At random init some BatchNorm channels
of these small ResNets are nearly constant, which makes their f32
gradients ill-conditioned in both frameworks: on one batch of 16 the f32
gradients of both sit up to 3.7e-2 (relative) from the f64 ones. So the
port's f32 gradient is held to "no further from the oracle than twice
JAX's own f32 gradient, or 1e-4".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import apply_model as japply
from ps_pytorch_tpu.models import build_model as jbuild
from ps_pytorch_tpu.models import init_model as jinit
from ps_pytorch_tpu.models.resnet import BasicBlock as JBasic
from ps_pytorch_tpu.models.resnet import Bottleneck as JBottle
from ps_pytorch_tpu.models.resnet import ResNet as JResNet
from ps_pytorch_tpu.ops.metrics import cross_entropy_loss as jxent
from ps_pytorch_tpu_torch.models import (
    BasicBlock,
    Bottleneck,
    LeNet,
    ResNet,
    apply_model,
    build_model,
    cnn_from_jax,
    init_model,
    param_count,
)
from ps_pytorch_tpu_torch.models.common import flatten_nhwc
from ps_pytorch_tpu_torch.ops.metrics import cross_entropy_loss
from ps_pytorch_tpu_torch.parallel.buckets import tree_flatten, tree_leaves, tree_unflatten
from tests.test_torch_one_thread import _one_thread  # noqa: F401


CASES = {
    "LeNet": (lambda dt: jbuild("LeNet", dtype=dt), lambda: LeNet(), (28, 28, 1)),
    "ResNet_basic_1111": (
        lambda dt: JResNet(block=JBasic, num_blocks=(1, 1, 1, 1), dtype=dt),
        lambda: ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1)), (32, 32, 3)),
    "ResNet_bottleneck_1111": (
        lambda dt: JResNet(block=JBottle, num_blocks=(1, 1, 1, 1), dtype=dt),
        lambda: ResNet(block=Bottleneck, num_blocks=(1, 1, 1, 1)), (32, 32, 3)),
}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= tol * max(np.max(np.abs(want)), 1e-6), (err, np.max(np.abs(want)))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jmodel_fn, tmodel_fn, shape = CASES[request.param]
    jmodel = jmodel_fn(jnp.float32)
    def init(key):
        return jinit(jmodel, key, shape)

    jparams, jbs = jax.jit(init)(jax.random.key(3))
    np_params = jax.tree.map(np.asarray, jparams)
    np_bs = jax.tree.map(np.asarray, jbs)
    tparams, tbs = cnn_from_jax(np_params, np_bs, device="cpu")
    rng = np.random.RandomState(5)
    x = rng.randn(4, *shape).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)
    return jmodel, tmodel_fn(), jparams, jbs, tparams, tbs, x, y, jmodel_fn


def _paths(tree, prefix=()):
    """(key path, shape) of every leaf, in jax.tree_util's order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [(prefix, tuple(np.shape(tree)))]


def test_torch_cnn_tree_keeps_flax_names_and_layouts(case):
    _, tmodel, jparams, jbs, tparams, tbs = case[:6]
    want = [(tuple(k.key for k in path), tuple(np.shape(a))) for path, a in
            jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert _paths(tparams) == want
    # the port's own init builds the same tree: names, shapes, BN stats
    p2, bs2 = tmodel.init(torch.Generator().manual_seed(0))
    assert _paths(p2) == want
    assert _paths(bs2) == [(tuple(k.key for k in path), tuple(np.shape(a))) for path, a in
                           jax.tree_util.tree_flatten_with_path(jbs)[0]]


@pytest.mark.parametrize("train", [False, True])
def test_torch_cnn_logits_match_jax(case, train):
    jmodel, tmodel, jparams, jbs, tparams, tbs, x = case[:7]
    def apply(p, b, xx):
        return japply(jmodel, p, b, xx, train=train)

    jlog, jnew = jax.jit(apply)(jparams, jbs, jnp.asarray(x))
    tlog, tnew = apply_model(tmodel, tparams, tbs, torch.from_numpy(x), train=train)
    _close(tlog.numpy(), jlog, 2e-5)
    if train and jbs:
        # train-mode BN statistics: 0.9 * old + 0.1 * biased batch variance
        for a, b in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew)):
            _close(a.numpy(), b, 2e-5)


def test_torch_cnn_grads_match_jax(case):
    """Per-leaf gradients, against the float64 JAX oracle: the port's f32
    gradient must be as close to it as JAX's own f32 gradient is (within
    2x), or within 1e-4 of the leaf's largest value."""
    jmodel, tmodel, jparams, jbs, tparams, tbs, x, y, jmodel_fn = case

    def jgrads(model, params, bs, xx):
        def jloss(p):
            logits, _ = japply(model, p, bs, xx, train=True)
            return jxent(logits, jnp.asarray(y))

        return [np.asarray(g, np.float64)
                for g in jax.tree_util.tree_leaves(jax.jit(jax.grad(jloss))(params))]

    j32 = jgrads(jmodel, jparams, jbs, jnp.asarray(x))
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        j64 = jgrads(jmodel_fn(jnp.float64), f64(jparams), f64(jbs),
                     jnp.asarray(x, jnp.float64))
    leaves, skel = tree_flatten(tparams)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    logits, _ = apply_model(tmodel, tree_unflatten(skel, leaves), tbs,
                            torch.from_numpy(x), train=True)
    tg = torch.autograd.grad(cross_entropy_loss(logits, torch.from_numpy(y)), leaves)
    assert len(tg) == len(j64)
    for t, a32, a64 in zip(tg, j32, j64):
        assert tuple(t.shape) == a64.shape
        ref = max(np.max(np.abs(a64)), 1e-12)
        err_port = np.max(np.abs(t.numpy() - a64)) / ref
        err_jax = np.max(np.abs(a32 - a64)) / ref
        assert err_port <= max(1e-4, 2.0 * err_jax), (err_port, err_jax)


def test_torch_resnet18_has_62_leaves_and_the_jax_param_count():
    jmodel = jbuild("ResNet18")
    model = build_model("ResNet18")
    params, bs = init_model(model, torch.Generator().manual_seed(0), device="cpu")
    assert len(tree_leaves(params)) == 62
    jparams, _ = jax.eval_shape(lambda k: jinit(jmodel, k, (32, 32, 3)),
                                jax.random.key(0))
    assert param_count(params) == sum(int(np.size(a)) for a in
                                      jax.tree_util.tree_leaves(jparams))
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(jparams)]


def test_torch_lenet_flattens_nhwc():
    """Dense_0 reads its 800 inputs in flax's NHWC order: a weight that
    only touches the input feature (h=0, w=0, c=1) must see channel 1."""
    act = torch.arange(2 * 50 * 4 * 4, dtype=torch.float32).reshape(2, 50, 4, 4)
    flat = flatten_nhwc(act)
    assert flat[0, 1] == act[0, 1, 0, 0] and flat[0, 50] == act[0, 0, 0, 1]


@pytest.mark.parametrize("name,leaves", [("VGG16", 58), ("VGG11NoBN", 22)])
def test_torch_vgg_builds(name, leaves):
    """Once refused: the VGG names build, with flax's leaf count (conv
    kernel + bias, BN scale + bias, three dense layers)."""
    params, _ = init_model(build_model(name), torch.Generator().manual_seed(0), device="cpu")
    assert len(tree_leaves(params)) == leaves


def test_torch_cnn_init_follows_flax_scales():
    """he_normal (fan_out, truncated normal) for ResNet convs: the sample
    std matches sqrt(2 / fan_out) within sampling error."""
    model = build_model("ResNet18")
    params, _ = init_model(model, torch.Generator().manual_seed(2), device="cpu")
    w = params["BasicBlock_7"]["Conv_1"]["kernel"]  # [3, 3, 512, 512]
    want = np.sqrt(2.0 / (3 * 3 * 512))
    assert abs(float(w.std()) / want - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 * want / 0.87962566103423978 + 1e-6
