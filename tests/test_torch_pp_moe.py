"""Port parity: ps_pytorch_tpu_torch.parallel.pp_moe (MoE in a GPipe
pipeline, on a stacked stage x expert grid) against the JAX package's
parallel/pp_moe.py on the 8-device CPU mesh, at 2 stages x 2 expert
shards x 2 microbatches.

- the layout: the port's PP layout is JAX's array for array, and the
  stacked cut of the expert leaves round trips bit for bit;
- one SGD step at capacity factor 1.25 (tokens drop), remat on and off:
  task loss, aux and params within the JAX package's 3e-5
  (tests/test_pp_moe.py:76), every gate call's expert choices equal to
  JAX's on its inputs;
- the aux counts valid ticks only: each column's aux is the mean, over
  its microbatches, of the plain MoE forward's aux on that microbatch (a
  warm-up or drain tick's router statistics would move it by ~1 / (M
  depth));
- the errors JAX raises; (M + S - 1) depth / S attention calls a step;
  the CLI's ``pp_moe`` branch.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models.transformer import TransformerConfig as JConfig
from ps_pytorch_tpu.optim import sgd as j_sgd
from ps_pytorch_tpu.parallel import moe as jmoe
from ps_pytorch_tpu.parallel import pp as jpp
from ps_pytorch_tpu.parallel import pp_moe as jpm
from ps_pytorch_tpu.parallel.mesh import place_on_mesh
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig as TConfig
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import moe, pp, pp_moe
from tests.test_torch_moe import check_choices, record_gates
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_tp import LM, assert_trees

tfa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
SHAPE = dict(vocab_size=53, dim=32, depth=4, heads=4, max_seq_len=16)
N_PP, N_EP, M = 2, 2, 2
B, T = 8, 16
LR = 0.2
TOL = 3e-5  # tests/test_pp_moe.py:76


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jmoe.init_moe_params(
        JConfig(**SHAPE), jmoe.MoEConfig(num_experts=8), jax.random.key(1)))


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], (B, T)).astype(np.int32)


def _port(params_np, cfg, mesh):
    plain = convert.params_from_jax(params_np, device="cpu")
    return pp_moe.shard_params_pp_moe(cfg, pp.to_pp_layout(cfg, plain), mesh)


def _plain(cfg, params):
    return convert.params_to_numpy(pp.from_pp_layout(cfg, pp_moe.unshard_params_pp_moe(cfg,
                                                                                       params)))


def test_torch_pp_moe_layout_round_trips_bit_exact(jax_params):
    cfg = TConfig(**SHAPE)
    mesh = pp_moe.make_mesh_pp_moe(N_PP, N_EP)
    lay = _port(jax_params, cfg, mesh)
    assert lay["blocks"]["w_up_e"].shape == (4, N_EP, 8 // N_EP, 32, 128)
    want = jax.tree.map(np.asarray, jpp.to_pp_layout(JConfig(**SHAPE), jax_params))
    got = convert.params_to_numpy(pp_moe.unshard_params_pp_moe(cfg, lay))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and np.array_equal(g, w)
    for g, w in zip(jax.tree_util.tree_leaves(_plain(cfg, lay)),
                    jax.tree_util.tree_leaves(jax_params)):
        assert np.array_equal(g, w)


@pytest.fixture(scope="module")
def jax_step(jax_params):
    cfg = JConfig(**SHAPE)
    mesh = jpm.make_mesh_pp_moe(N_PP, N_EP)
    tx = j_sgd(LR)
    p = place_on_mesh(jpp.to_pp_layout(cfg, jax_params), mesh, jpm.pp_moe_param_specs(cfg))
    step = jpm.make_pp_moe_train_step(cfg, jmoe.MoEConfig(num_experts=8), tx, mesh,
                                      num_microbatches=M, donate=False)
    p, _, task, aux = step(p, tx.init(p), jpm.shard_tokens_pp_moe(jnp.asarray(_tokens(1)),
                                                                  mesh))
    return float(task), float(aux), jax.tree.map(
        np.asarray, jpp.from_pp_layout(cfg, jax.device_get(p)))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_torch_pp_moe_step_matches_jax(jax_params, jax_step, monkeypatch, remat):
    want_task, want_aux, want = jax_step
    calls = record_gates(monkeypatch)
    cfg = TConfig(**SHAPE, remat=remat)
    mesh = pp_moe.make_mesh_pp_moe(N_PP, N_EP)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = _port(jax_params, cfg, mesh)
    p, _, task, aux = pp_moe.make_pp_moe_train_step(cfg, moe.MoEConfig(num_experts=8), tx,
                                                    mesh, num_microbatches=M)(
        p, tx.init(p), pp_moe.shard_tokens_pp_moe(torch.from_numpy(_tokens(1)), mesh))
    check_choices(calls, "pp_moe step")
    assert abs(float(task) - want_task) < TOL, (float(task), want_task)
    assert abs(float(aux) - want_aux) < TOL, (float(aux), want_aux)
    assert_trees(_plain(cfg, p), want, rtol=TOL, atol=TOL)


def test_torch_pp_moe_aux_counts_valid_ticks_only(jax_params):
    """Each column's aux equals the mean over its M microbatches of the
    plain 2-shard MoE forward's aux: the pipeline computes each valid
    (stage, microbatch) block on the same activations, and the 2 warm-up
    and drain ticks add nothing."""
    cfg = TConfig(**SHAPE)
    mcfg = moe.MoEConfig(num_experts=8)
    mesh = pp_moe.make_mesh_pp_moe(N_PP, N_EP)
    tok = pp_moe.shard_tokens_pp_moe(torch.from_numpy(_tokens(4)), mesh)  # [ep, B/ep, T]
    mb = tok.reshape(N_EP, M, -1, T).transpose(0, 1)  # [M, ep, b, T]
    with torch.no_grad():
        task, aux = pp_moe._pp_moe_loss(cfg, mcfg, _port(jax_params, cfg, mesh), mb, mesh)
        plain = moe.shard_params_moe(cfg, convert.params_from_jax(jax_params, device="cpu"),
                                     mesh.ep)
        want = torch.stack([moe.apply_moe_transformer(cfg, mcfg, plain, mb[i], mesh.ep)[1]
                            for i in range(M)]).mean(0)
    assert aux.shape == (N_EP,)
    np.testing.assert_allclose(aux.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_torch_pp_moe_refuses_what_jax_refuses(jax_params):
    tx = build_optimizer("sgd", LR, momentum=0.0)
    with pytest.raises(ValueError, match="depth 4 not divisible by 3 stages"):
        pp_moe.init_pp_moe_state(TConfig(**SHAPE), moe.MoEConfig(), tx, None,
                                 pp_moe.make_mesh_pp_moe(3, 1), device="cpu")
    with pytest.raises(ValueError, match="8 experts not divisible by 3 expert shards"):
        pp_moe.init_pp_moe_state(TConfig(**SHAPE), moe.MoEConfig(), tx, None,
                                 pp_moe.make_mesh_pp_moe(2, 3), device="cpu")
    cfg = TConfig(**SHAPE)
    mesh = pp_moe.make_mesh_pp_moe(N_PP, N_EP)
    p = _port(jax_params, cfg, mesh)
    step = pp_moe.make_pp_moe_train_step(cfg, moe.MoEConfig(), tx, mesh, num_microbatches=3)
    with pytest.raises(ValueError, match="batch 4 not divisible by 3 microbatches"):
        step(p, tx.init(p), pp_moe.shard_tokens_pp_moe(torch.from_numpy(_tokens(0)), mesh))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_torch_pp_moe_attention_calls_per_step(jax_params, monkeypatch, remat):
    """(M + S - 1) depth / S calls of K4 a forward (once more with remat)
    and of K5 + K6: every stage's and column's rows in one call."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_fwd, tfa.flash_bwd

    def count_fwd(q, *a, **kw):
        calls["fwd"] += 1
        assert q.shape[0] == N_PP * B // M
        return fwd(q, *a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", count_fwd)
    monkeypatch.setattr(tfa, "flash_bwd", count_bwd)
    cfg = TConfig(**SHAPE, attention_impl="flash", remat=remat)
    mesh = pp_moe.make_mesh_pp_moe(N_PP, N_EP)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = _port(jax_params, cfg, mesh)
    pp_moe.make_pp_moe_train_step(cfg, moe.MoEConfig(), tx, mesh, num_microbatches=M)(
        p, tx.init(p), pp_moe.shard_tokens_pp_moe(torch.from_numpy(_tokens(2)), mesh))
    blocks = (M + N_PP - 1) * SHAPE["depth"] // N_PP
    assert calls == {"fwd": blocks * (2 if remat else 1), "bwd": blocks}


def test_torch_cli_train_lm_pp_moe_runs():
    out = train_lm.main(LM + ["--parallelism", "pp_moe", "--num-shards", "2", "--num-ep",
                              "2", "--num-microbatches", "2", "--batch-size", "8"])
    losses = [h["loss"] for h in out["history"]]
    assert out["layout"] == "pp 2 x ep 2 (8 experts, 2 microbatches)"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(np.isfinite(h["aux_loss"]) for h in out["history"])
    with pytest.raises(ValueError, match="split over ep=2 then num_microbatches=3"):
        train_lm.main(LM + ["--parallelism", "pp_moe", "--num-ep", "2",
                            "--num-microbatches", "3"])
    with pytest.raises(ValueError, match="depth 2 not divisible by 4 stages"):
        train_lm.main(LM + ["--parallelism", "pp_moe", "--num-shards", "4",
                            "--num-microbatches", "1"])
