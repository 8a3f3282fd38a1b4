"""Port parity: ps_pytorch_tpu_torch.parallel.dp_tp_pp (data x stage x
tensor on a stacked grid, a library in both packages) against the JAX
package's parallel/dp_tp_pp.py on the 8-device CPU mesh, at 2 x 2 x 2.

- ``to_3d_layout`` is JAX's array for array, and ``from_3d_layout`` and
  the stacked tp cut round trip bit for bit;
- one SGD-momentum step at 2 microbatches a dp column, depth 2 and 4,
  remat on and off: loss and params within the JAX package's 3e-5
  (tests/test_dp_tp_pp.py:68); the loss is also the plain model's;
- the errors JAX raises; (M + S - 1) depth / S attention calls a step.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models.transformer import TransformerConfig as JConfig
from ps_pytorch_tpu.models.transformer import init_transformer as j_init
from ps_pytorch_tpu.optim import sgd as j_sgd
from ps_pytorch_tpu.parallel import dp_tp_pp as j3d
from ps_pytorch_tpu.parallel.mesh import place_on_mesh
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig as TConfig
from ps_pytorch_tpu_torch.models.transformer import apply_transformer
from ps_pytorch_tpu_torch.ops.metrics import next_token_nll
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import dp_tp_pp
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_tp import assert_trees

tfa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
SHAPE = dict(vocab_size=53, dim=32, heads=4, max_seq_len=12)
B, T, M = 8, 12, 2
LR, MOMENTUM = 0.2, 0.9
TOL = 3e-5  # tests/test_dp_tp_pp.py:68


@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(depth):
        if depth not in cache:
            cache[depth] = jax.tree.map(np.asarray, j_init(JConfig(**SHAPE, depth=depth),
                                                           jax.random.key(depth)))
        return cache[depth]

    return get


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], (B, T)).astype(np.int32)


def _port(params_np, cfg, mesh):
    plain = convert.params_from_jax(params_np, device="cpu")
    return dp_tp_pp.shard_params_3d(cfg, dp_tp_pp.to_3d_layout(cfg, plain), mesh)


def test_torch_3d_layout_round_trips_bit_exact(jax_params):
    params = jax_params(2)
    cfg = TConfig(**SHAPE, depth=2)
    mesh = dp_tp_pp.make_mesh_3d(2, 2, 2)
    lay = dp_tp_pp.to_3d_layout(cfg, convert.params_from_jax(params, device="cpu"))
    want = jax.tree.map(np.asarray, j3d.to_3d_layout(JConfig(**SHAPE, depth=2), params))
    got = convert.params_to_numpy(lay)
    assert got["blocks"]["wqkv"].shape == (2, 32, 3, 4, 8)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and np.array_equal(g, w)
    stacked = dp_tp_pp.shard_params_3d(cfg, lay, mesh)
    assert stacked["blocks"]["wqkv"].shape == (2, 2, 32, 3, 2, 8)
    back = dp_tp_pp.from_3d_layout(cfg, dp_tp_pp.unshard_params_3d(cfg, stacked))
    for g, w in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(back)),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(g, w)


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    cache = {}

    def get(depth):
        if depth not in cache:
            cfg = JConfig(**SHAPE, depth=depth)
            mesh = j3d.make_mesh_3d(2, 2, 2)
            tx = j_sgd(LR, momentum=MOMENTUM)
            p = place_on_mesh(j3d.to_3d_layout(cfg, jax_params(depth)), mesh,
                              j3d.param_specs_3d(cfg))
            step = j3d.make_3d_train_step(cfg, tx, mesh, num_microbatches=M, donate=False)
            p, _, loss = step(p, tx.init(p), j3d.shard_tokens_3d(jnp.asarray(_tokens(1)),
                                                                 mesh))
            cache[depth] = (float(loss), jax.tree.map(
                np.asarray, j3d.from_3d_layout(cfg, jax.device_get(p))))
        return cache[depth]

    return get


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("depth", [2, 4])
def test_torch_3d_step_matches_jax(jax_params, jax_steps, depth, remat):
    want_loss, want = jax_steps(depth)
    cfg = TConfig(**SHAPE, depth=depth, remat=remat)
    mesh = dp_tp_pp.make_mesh_3d(2, 2, 2)
    tx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    p = _port(jax_params(depth), cfg, mesh)
    tok = torch.from_numpy(_tokens(1))
    p, _, loss = dp_tp_pp.make_3d_train_step(cfg, tx, mesh, num_microbatches=M)(
        p, tx.init(p), dp_tp_pp.shard_tokens_3d(tok, mesh))
    assert abs(float(loss) - want_loss) < TOL, (float(loss), want_loss)
    # the loss is the plain model's batch mean
    plain = convert.params_from_jax(jax_params(depth), device="cpu")
    with torch.no_grad():
        oracle = next_token_nll(apply_transformer(cfg, plain, tok), tok)
    assert abs(float(loss) - float(oracle)) < 1e-5
    got = convert.params_to_numpy(dp_tp_pp.from_3d_layout(
        cfg, dp_tp_pp.unshard_params_3d(cfg, p)))
    assert_trees(got, want, rtol=TOL, atol=TOL)


def test_torch_3d_refuses_what_jax_refuses(jax_params):
    tx = build_optimizer("sgd", LR, momentum=0.0)
    for shape, mesh, match in ((dict(depth=3), (1, 2, 2), "depth 3 not divisible by 2 stages"),
                               (dict(depth=2, heads=2), (1, 1, 4),
                                "heads/mlp not divisible by 4 model shards")):
        cfg = {**SHAPE, **shape}
        with pytest.raises(ValueError, match=match) as want:
            j3d.init_3d_state(JConfig(**cfg), j_sgd(LR), jax.random.key(0),
                              j3d.make_mesh_3d(*mesh))
        with pytest.raises(ValueError, match=match) as got:
            dp_tp_pp.init_3d_state(TConfig(**cfg), tx, None, dp_tp_pp.make_mesh_3d(*mesh),
                                   device="cpu")
        assert str(got.value) == str(want.value)
    cfg = TConfig(**SHAPE, depth=2)
    mesh = dp_tp_pp.make_mesh_3d(2, 2, 2)
    p = _port(jax_params(2), cfg, mesh)
    step = dp_tp_pp.make_3d_train_step(cfg, tx, mesh, num_microbatches=3)
    with pytest.raises(ValueError, match="per-dp batch 4 not divisible by 3 microbatches"):
        step(p, tx.init(p), dp_tp_pp.shard_tokens_3d(torch.from_numpy(_tokens(0)), mesh))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_torch_3d_attention_calls_per_step(jax_params, monkeypatch, remat):
    """(M + S - 1) depth / S calls of K4 a forward (once more with remat)
    and of K5 + K6: every stage's, tp shard's and dp column's rows in one
    call."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_fwd, tfa.flash_bwd

    def count_fwd(q, *a, **kw):
        calls["fwd"] += 1
        assert q.shape == (2 * 2 * B // M, T, SHAPE["heads"] // 2, 8)
        return fwd(q, *a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", count_fwd)
    monkeypatch.setattr(tfa, "flash_bwd", count_bwd)
    cfg = TConfig(**SHAPE, depth=4, attention_impl="flash", remat=remat)
    mesh = dp_tp_pp.make_mesh_3d(2, 2, 2)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = _port(jax_params(4), cfg, mesh)
    dp_tp_pp.make_3d_train_step(cfg, tx, mesh, num_microbatches=M)(
        p, tx.init(p), dp_tp_pp.shard_tokens_3d(torch.from_numpy(_tokens(2)), mesh))
    blocks = (M + 2 - 1) * 4 // 2
    assert calls == {"fwd": blocks * (2 if remat else 1), "bwd": blocks}
