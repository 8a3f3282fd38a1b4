"""Port parity: the VGG family of ps_pytorch_tpu_torch.models.vgg against
the JAX package's flax VGG.

- The param and BatchNorm trees (key paths and shapes, hence leaf
  counts) of all eight registered names, against JAX's through
  ``jax.eval_shape`` (no compute): VGG16-BN is 58 leaves and 15,253,578
  params.
- A narrow table, ``cfg=(8, "M", 16, "M")``, on 2 images, with and
  without BatchNorm: logits in eval and train mode, train-mode BN stats
  and per-leaf gradients on JAX's weights (``cnn_from_jax``). In train
  mode JAX's Dropout masks are read off flax's ``Dropout.__call__``
  (``nn.intercept_methods``: a kept element is one whose output is
  non-zero; where the input is zero, after a ReLU, the mask changes
  neither the value nor, ReLU's gradient being zero there, any gradient)
  and handed to the port. Tolerances as tests/test_torch_cnn_models.py:
  logits and BN stats within 2e-5 of the largest reference magnitude; the
  gradients held to the float64 JAX oracle (run with the same masks), no
  further from it than twice JAX's own f32 gradient, or 1e-4.
- The port's own draws (a ``torch.Generator``, not flax's threefry): a
  step's keep-masks at VGG16's shapes keep 0.5 of the elements within
  0.005 (the standard error of 2**20 draws is 5e-4).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import apply_model as japply
from ps_pytorch_tpu.models import build_model as jbuild
from ps_pytorch_tpu.models import init_model as jinit
from ps_pytorch_tpu.models import param_count as jparam_count
from ps_pytorch_tpu.models.vgg import VGG as JVGG
from ps_pytorch_tpu.ops.metrics import cross_entropy_loss as jxent
from ps_pytorch_tpu_torch.models import (
    VGG,
    apply_model,
    build_model,
    cnn_from_jax,
    param_count,
    params_to_numpy,
)
from ps_pytorch_tpu_torch.ops.metrics import cross_entropy_loss
from ps_pytorch_tpu_torch.parallel.buckets import tree_flatten, tree_leaves, tree_unflatten
from ps_pytorch_tpu_torch.parallel.ps import PSConfig, draw_step

NAMES = ("VGG11", "VGG11NoBN", "VGG13", "VGG13NoBN", "VGG16", "VGG16NoBN", "VGG19",
         "VGG19NoBN")
NARROW = (8, "M", 16, "M")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [(prefix, tuple(np.shape(tree)))]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= tol * max(np.max(np.abs(want)), 1e-6), (err, np.max(np.abs(want)))


@pytest.mark.parametrize("name", NAMES)
def test_torch_vgg_tree_matches_jax(name):
    jparams, jbs = jax.eval_shape(lambda k: jinit(jbuild(name), k, (32, 32, 3)),
                                  jax.random.key(0))
    with torch.device("meta"):  # shapes only
        params, bs = build_model(name).init(torch.Generator().manual_seed(0))
    assert _paths(params) == _paths(jparams)
    assert _paths(bs) == _paths(jbs)
    assert param_count(params) == jparam_count(jparams)
    if name == "VGG16":
        assert (len(tree_leaves(params)), param_count(params)) == (58, 15253578)


class DropoutTap:
    """A flax method interceptor for ``nn.Dropout``: without ``inject`` it
    keeps each call's keep-mask (output non-zero); with it, each call's
    output becomes ``where(keep, x * 2, 0)`` for the given masks."""

    def __init__(self, inject=None):
        self.masks, self._inject = [], list(inject) if inject is not None else None

    def __call__(self, next_fun, args, kwargs, context):
        if not isinstance(context.module, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        if self._inject is not None:
            keep = jnp.asarray(self._inject.pop(0))
            return jnp.where(keep, x * jnp.asarray(2.0, x.dtype), jnp.zeros((), x.dtype))
        out = next_fun(*args, **kwargs)
        self.masks.append(out != 0)
        return out


def jax_train(model, params, bs, x, y, inject=None):
    """JAX's train-mode logits, new BN stats, per-leaf gradients of the
    cross-entropy and the Dropout keep-masks it drew (or was given:
    ``inject``), jitted."""
    def loss_fn(p):
        tap = DropoutTap(inject)
        with nn.intercept_methods(tap):
            logits, new_bs = japply(model, p, bs, x, train=True,
                                    dropout_rng=jax.random.key(7))
        return jxent(logits, y), (logits, new_bs, tap.masks)

    (_, (logits, new_bs, masks)), g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return (logits, new_bs, [np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(g)],
            [np.array(m) for m in masks])


def port_train(model, params, bs, x, y, masks):
    """The port's train-mode logits, new BN stats and per-leaf grads."""
    leaves, skel = tree_flatten(params)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    logits, new_bs = apply_model(model, tree_unflatten(skel, leaves), bs,
                                 torch.from_numpy(x), train=True,
                                 dropout=[torch.as_tensor(m) for m in masks])
    g = torch.autograd.grad(cross_entropy_loss(logits, torch.from_numpy(y).long()), leaves)
    return logits.detach(), new_bs, g


@pytest.fixture(scope="module", params=[True, False], ids=["bn", "nobn"])
def narrow(request):
    bn = request.param
    jmodel = JVGG(cfg=NARROW, batch_norm=bn)
    def init(key):
        return jinit(jmodel, key, (32, 32, 3))

    jparams, jbs = jax.jit(init)(jax.random.key(3))
    tparams, tbs = cnn_from_jax(jax.tree.map(np.asarray, jparams),
                                jax.tree.map(np.asarray, jbs), device="cpu")
    rng = np.random.RandomState(5)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 2).astype(np.int32)
    return bn, jmodel, jparams, jbs, VGG(cfg=NARROW, batch_norm=bn), tparams, tbs, x, y


def test_torch_vgg_converter_round_trips_the_jax_tree(narrow):
    _, _, jparams, jbs, _, tparams, tbs = narrow[:7]
    for ours, theirs in ((tparams, jparams), (tbs, jbs)):
        back = params_to_numpy(ours)
        assert _paths(back) == _paths(theirs)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(theirs)):
            assert np.array_equal(a, np.asarray(b))


def test_torch_vgg_eval_logits_match_jax(narrow):
    _, jmodel, jparams, jbs, tmodel, tparams, tbs, x, _ = narrow
    def apply(p, b, xx):
        return japply(jmodel, p, b, xx, train=False)

    jlog, _ = jax.jit(apply)(jparams, jbs, jnp.asarray(x))
    tlog, _ = apply_model(tmodel, tparams, tbs, torch.from_numpy(x), train=False)
    _close(tlog.numpy(), jlog, 2e-5)


def test_torch_vgg_train_logits_stats_and_grads_match_jax(narrow):
    bn, jmodel, jparams, jbs, tmodel, tparams, tbs, x, y = narrow
    jlog, jnew, j32, masks = jax_train(jmodel, jparams, jbs, jnp.asarray(x), jnp.asarray(y))
    assert [m.shape for m in masks] == tmodel.dropout_shapes(2)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        _, _, j64, _ = jax_train(JVGG(cfg=NARROW, batch_norm=bn, dtype=jnp.float64),
                                 f64(jparams), f64(jbs), jnp.asarray(x, jnp.float64),
                                 jnp.asarray(y), inject=masks)
    tlog, tnew, tg = port_train(tmodel, tparams, tbs, x, y, masks)
    _close(tlog.numpy(), jlog, 2e-5)
    for a, b in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew)):
        _close(a.numpy(), b, 2e-5)
    assert len(tg) == len(j64) == len(j32)
    for t, a32, a64 in zip(tg, j32, j64):
        ref = max(np.max(np.abs(a64)), 1e-12)
        err_port = np.max(np.abs(t.numpy() - a64)) / ref
        err_jax = np.max(np.abs(a32 - a64)) / ref
        assert err_port <= max(1e-4, 2.0 * err_jax), (err_port, err_jax)


def test_torch_vgg_dropout_draws_keep_half():
    """A step's draws at VGG16's shapes (8 workers x 128 images): keep
    rate 0.5 within 0.005, and no two workers' masks alike."""
    model = build_model("VGG16")
    draws = draw_step(PSConfig(num_workers=8), seed=1, step=3, batch_per_worker=128,
                      model=model)
    masks = [m for per_worker in draws.dropout for m in per_worker]
    assert [tuple(m.shape) for m in draws.dropout[0]] == [(128, 512), (128, 512)]
    kept = sum(int(m.sum()) for m in masks) / sum(m.numel() for m in masks)
    assert abs(kept - 0.5) <= 0.005, kept
    assert not torch.equal(draws.dropout[0][0], draws.dropout[1][0])
    again = draw_step(PSConfig(num_workers=8), seed=1, step=3, batch_per_worker=128,
                      model=model)
    assert all(torch.equal(a, b) for a, b in zip(masks, (m for w in again.dropout for m in w)))
