"""Port parity: ps_pytorch_tpu_torch.parallel.pp (GPipe on a stacked axis
of stages) against the JAX package's parallel/pp.py on the 8-device CPU
mesh.

The same JAX-initialised weights (through ``to_pp_layout`` and the
port's ``params_from_jax``) and numpy tokens:

- the layout round trip is bit-exact, and the port's PP layout is JAX's
  array for array; a depth that does not split over the stages raises
  JAX's error;
- one SGD step at M in {1, 2, 4} microbatches (2 stages of 2 blocks,
  and 4 stages of 1 at M = 2): the loss within 2e-5 of JAX's (the JAX
  package's own bound, tests/test_pp.py:77) and the params within rtol
  = atol = 4e-5 (tests/test_pp.py:92), with and without remat (JAX's
  remat gives its no-remat numbers, tests/test_pp.py:135);
- the schedule calls the within-device attention (M + S - 1) depth / S
  times a forward, once more with remat, and its backward as often: the
  launch counts of K4-K6 on the card;
- the CLI's ``pp`` branch runs and refuses what JAX refuses.
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
from ps_pytorch_tpu.parallel import pp as jpp
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig as TConfig
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import pp
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_tp import LM, assert_trees

# the module (the ops package re-exports its function under the same name)
tfa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
SHAPE = dict(vocab_size=53, dim=32, depth=4, heads=4, max_seq_len=16)
B, T = 8, 16
LR = 0.1


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, j_init(JConfig(**SHAPE), jax.random.key(2)))


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], (B, T)).astype(np.int32)


def _port_pp(params_np, cfg, stages):
    plain = convert.params_from_jax(params_np, device="cpu")
    return pp.shard_params_pp(cfg, pp.to_pp_layout(cfg, plain), pp.make_pp_mesh(stages))


def test_torch_pp_layout_round_trips_bit_exact(jax_params):
    cfg = TConfig(**SHAPE)
    lay = _port_pp(jax_params, cfg, 2)
    want = jax.tree.map(np.asarray, jpp.to_pp_layout(JConfig(**SHAPE), jax_params))
    got = convert.params_to_numpy(lay)
    assert got["blocks"]["wqkv"].shape == (4, 32, 96)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and np.array_equal(g, w)
    back = convert.params_to_numpy(pp.from_pp_layout(cfg, lay))
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax_params)):
        assert np.array_equal(g, w)


def test_torch_pp_depth_not_divisible_raises_as_jax(jax_params):
    shape = {**SHAPE, "depth": 6}
    jparams = j_init(JConfig(**shape), jax.random.key(0))
    with pytest.raises(ValueError, match="not divisible") as want:
        jpp.shard_params_pp(JConfig(**shape), jpp.to_pp_layout(JConfig(**shape), jparams),
                            jpp.make_pp_mesh(4))
    with pytest.raises(ValueError, match="not divisible") as got:
        _port_pp(jax.tree.map(np.asarray, jparams), TConfig(**shape), 4)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    """JAX's one-step (loss, plain params) at each (stages, microbatches),
    run once for the module."""
    cache = {}

    def get(stages, m):
        if (stages, m) not in cache:
            cfg = JConfig(**SHAPE)
            mesh = jpp.make_pp_mesh(stages)
            tx = j_sgd(LR)
            p = jpp.shard_params_pp(cfg, jpp.to_pp_layout(cfg, jax_params), mesh)
            step = jpp.make_pp_train_step(cfg, tx, mesh, num_microbatches=m, donate=False)
            p, _, loss = step(p, tx.init(p), jnp.asarray(_tokens(1)))
            cache[(stages, m)] = (float(loss), jax.tree.map(
                np.asarray, jpp.from_pp_layout(cfg, jax.device_get(p))))
        return cache[(stages, m)]

    return get


def _port_step(params_np, stages, m, remat):
    cfg = TConfig(**SHAPE, remat=remat)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = _port_pp(params_np, cfg, stages)
    step = pp.make_pp_train_step(cfg, tx, pp.make_pp_mesh(stages), num_microbatches=m)
    p, _, loss = step(p, tx.init(p), torch.from_numpy(_tokens(1)))
    return float(loss), convert.params_to_numpy(pp.from_pp_layout(cfg, p))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("stages,m", [(2, 1), (2, 2), (2, 4), (4, 2)])
def test_torch_pp_step_matches_jax(jax_params, jax_steps, stages, m, remat):
    want_loss, want = jax_steps(stages, m)
    loss, got = _port_step(jax_params, stages, m, remat)
    assert abs(loss - want_loss) < 2e-5, (loss, want_loss)
    assert_trees(got, want, rtol=4e-5, atol=4e-5)


def test_torch_pp_refuses_a_batch_that_does_not_split(jax_params):
    cfg = TConfig(**SHAPE)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = _port_pp(jax_params, cfg, 2)
    step = pp.make_pp_train_step(cfg, tx, pp.make_pp_mesh(2), num_microbatches=3)
    with pytest.raises(ValueError, match="batch 8 not divisible by 3 microbatches"):
        step(p, tx.init(p), torch.from_numpy(_tokens()))


@pytest.mark.parametrize("stages,m,remat", [(2, 4, True), (2, 1, False), (4, 2, False)])
def test_torch_pp_attention_calls_per_step(jax_params, monkeypatch, stages, m, remat):
    """K4 (flash_fwd), K5 and K6 (flash_bwd) wrapper calls a step on the
    flash path: (M + S - 1) depth / S ticks' local blocks, each forward
    once more under remat; all S stages in one call."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_fwd, tfa.flash_bwd

    def count_fwd(q, *a, **kw):
        calls["fwd"] += 1
        assert q.shape[0] == stages * (B // m)  # the stages fold into the batch
        return fwd(q, *a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", count_fwd)
    monkeypatch.setattr(tfa, "flash_bwd", count_bwd)
    cfg = TConfig(**SHAPE, attention_impl="flash", remat=remat)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = _port_pp(jax_params, cfg, stages)
    step = pp.make_pp_train_step(cfg, tx, pp.make_pp_mesh(stages), num_microbatches=m)
    step(p, tx.init(p), torch.from_numpy(_tokens()))
    blocks = (m + stages - 1) * SHAPE["depth"] // stages
    assert calls == {"fwd": blocks * (2 if remat else 1), "bwd": blocks}


def test_torch_cli_train_lm_pp_runs():
    out = train_lm.main(LM + ["--parallelism", "pp", "--num-shards", "2",
                              "--num-microbatches", "4", "--remat"])
    losses = [h["loss"] for h in out["history"]]
    assert out["layout"] == "pp 2 x 4 microbatches"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="divisible by num_microbatches=3"):
        train_lm.main(LM + ["--parallelism", "pp", "--num-microbatches", "3"])
    with pytest.raises(ValueError, match="depth 2 not divisible by 4 stages"):
        train_lm.main(LM + ["--parallelism", "pp", "--num-shards", "4"])
    with pytest.raises(ValueError, match="tp/dp_tp only"):
        train_lm.main(LM + ["--parallelism", "pp", "--shard-vocab"])
