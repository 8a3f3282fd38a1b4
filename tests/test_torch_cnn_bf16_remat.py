"""Port parity: bf16 compute and remat in the CNN zoo
(ps_pytorch_tpu_torch.models: ``dtype``, ``remat``).

bf16: the port's models at ``dtype=torch.bfloat16`` against the JAX
package's at ``dtype=jnp.bfloat16`` (flax's ``dtype=``: input and kernel
cast to bf16 at each layer over f32 params, BatchNorm statistics and
normalize in f32 with a bf16 output, f32 logits), on the ``(1, 1, 1, 1)``
BasicBlock ResNet and a narrow VGG-BN (train mode with JAX's Dropout
masks, tests/test_torch_vgg.py), same weights. Two frameworks' bf16
convolutions round at different places (a fused bias, the accumulation
order), so they are not held to each other's bits but to the f32 result
of the same model: the port's bf16 logits no further from it than twice
JAX's bf16 logits are, or 2e-2 of the largest f32 logit (about five bf16
ulps); the port's bf16 gradient, all leaves as one vector, no further
from the f32 gradient in relative L2 norm than 1.5 times JAX's bf16
gradient is. The gradients are held as one vector because at random init
some BatchNorm channels of the small ResNet are nearly constant, which
leaves single leaves' bf16 gradients 10-55% from the f32 ones in both
frameworks (0.157 for JAX, 0.174 for the port as one vector).

remat: the tree keeps its keys, a step's gradients and BatchNorm stats
are bit-equal with and without it (the recompute writes no stats), and
a checkpoint trained with ``--remat`` is read by the evaluator, whose
model has none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import apply_model as japply
from ps_pytorch_tpu.models import init_model as jinit
from ps_pytorch_tpu.models.resnet import BasicBlock as JBasic
from ps_pytorch_tpu.models.resnet import ResNet as JResNet
from ps_pytorch_tpu.models.vgg import VGG as JVGG
from ps_pytorch_tpu.ops.metrics import cross_entropy_loss as jxent
from ps_pytorch_tpu_torch.cli.evaluate import Evaluator
from ps_pytorch_tpu_torch.data import make_synthetic
from ps_pytorch_tpu_torch.models import (
    VGG,
    BasicBlock,
    ResNet,
    apply_model,
    build_model,
    cnn_from_jax,
)
from ps_pytorch_tpu_torch.ops.metrics import cross_entropy_loss
from ps_pytorch_tpu_torch.parallel.buckets import tree_flatten, tree_unflatten
from ps_pytorch_tpu_torch.parallel.ps import PSConfig
from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_vgg import DropoutTap, _paths


BF16_FLOOR = 2e-2
NARROW = (8, "M", 16, "M")

CASES = {
    "resnet_1111": (lambda dt: JResNet(block=JBasic, num_blocks=(1, 1, 1, 1), dtype=dt),
                    lambda dt: ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1), dtype=dt)),
    "vgg_bn_narrow": (lambda dt: JVGG(cfg=NARROW, batch_norm=True, dtype=dt),
                      lambda dt: VGG(cfg=NARROW, batch_norm=True, dtype=dt)),
}


def _jax_run(model, params, bs, x, y, masks):
    """JAX train-mode logits and per-leaf grads, Dropout fed ``masks``."""
    def loss_fn(p):
        import flax.linen as nn

        with nn.intercept_methods(DropoutTap(inject=masks)):
            logits, _ = japply(model, p, bs, x, train=True, dropout_rng=jax.random.key(7))
        return jxent(logits, y), logits

    (_, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return np.asarray(logits, np.float64), [np.asarray(a, np.float64)
                                            for a in jax.tree_util.tree_leaves(g)]


def _port_run(model, params, bs, x, y, masks):
    leaves, skel = tree_flatten(params)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    logits, new_bs = apply_model(model, tree_unflatten(skel, leaves), bs,
                                 torch.from_numpy(x), train=True,
                                 dropout=[torch.from_numpy(m) for m in masks] or None)
    g = torch.autograd.grad(cross_entropy_loss(logits, torch.from_numpy(y).long()), leaves)
    return logits.detach().double().numpy(), [t.double().numpy() for t in g], new_bs


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_bf16_matches_jax_bf16(name):
    jfn, tfn = CASES[name]
    def init(key):
        return jinit(jfn(jnp.float32), key, (32, 32, 3))

    jparams, jbs = jax.jit(init)(jax.random.key(3))
    tparams, tbs = cnn_from_jax(jax.tree.map(np.asarray, jparams),
                                jax.tree.map(np.asarray, jbs), device="cpu")
    rng = np.random.RandomState(5)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)
    shapes = tfn(torch.float32).dropout_shapes(4) if name.startswith("vgg") else []
    masks = [rng.rand(*s) >= 0.5 for s in shapes]
    ref_logits, ref_g, _ = _port_run(tfn(torch.float32), tparams, tbs, x, y, masks)
    jlog, jg = _jax_run(jfn(jnp.bfloat16), jparams, jbs, jnp.asarray(x), jnp.asarray(y),
                        masks)
    tlog, tg, _ = _port_run(tfn(torch.bfloat16), tparams, tbs, x, y, masks)

    scale = max(np.max(np.abs(ref_logits)), 1e-12)
    err_port = np.max(np.abs(tlog - ref_logits)) / scale
    err_jax = np.max(np.abs(jlog - ref_logits)) / scale
    assert err_port <= max(BF16_FLOOR, 2.0 * err_jax), (err_port, err_jax)

    def rel_l2(gs):
        return np.sqrt(sum(np.sum((a - b) ** 2) for a, b in zip(gs, ref_g))
                       / sum(np.sum(b ** 2) for b in ref_g))

    assert len(tg) == len(jg) == len(ref_g)
    assert all(t.shape == r.shape for t, r in zip(tg, ref_g))
    assert rel_l2(tg) <= 1.5 * rel_l2(jg), (rel_l2(tg), rel_l2(jg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_torch_remat_is_bit_equal(dtype):
    plain = ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1), dtype=dtype)
    remat = ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1), dtype=dtype, remat=True)
    params, bs = plain.init(torch.Generator().manual_seed(4))
    assert _paths(remat.init(torch.Generator().manual_seed(4))[0]) == _paths(params)
    rng = np.random.RandomState(6)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)
    _, g0, s0 = _port_run(plain, params, bs, x, y, [])
    _, g1, s1 = _port_run(remat, params, bs, x, y, [])
    assert all(np.array_equal(a, b) for a, b in zip(g0, g1))
    assert _paths(s0) == _paths(s1)
    flat0, flat1 = tree_flatten(s0)[0], tree_flatten(s1)[0]
    assert all(torch.equal(a, b) for a, b in zip(flat0, flat1))


def test_torch_remat_checkpoint_is_read_without_remat(tmp_path):
    with torch.device("meta"):  # shapes only
        assert _paths(build_model("ResNet18", remat=True).init(torch.Generator())[0]) == \
            _paths(build_model("ResNet18").init(torch.Generator())[0])
    ds = make_synthetic("Cifar10", train_size=8, test_size=4, seed=0)
    tcfg = TrainConfig(network="ResNet18", dataset="Cifar10", batch_size=2, max_steps=1,
                       eval_freq=1, log_interval=1, train_dir=str(tmp_path), remat=True,
                       dtype="bfloat16")
    out = Trainer(tcfg, PSConfig(num_workers=2, compress="int8"), dataset=ds,
                  device="cpu").train()
    assert np.isfinite(out["loss"])
    ev = Evaluator("ResNet18", "Cifar10", str(tmp_path), eval_batch_size=4, device="cpu")
    ev.dataset = ds  # the 4-image split: the CLI's own is 1024 CPU forwards
    results = ev.run(once=True)
    assert list(results) == [1] and np.isfinite(results[1]["loss"])
