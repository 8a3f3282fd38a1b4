"""Port parity: ps_pytorch_tpu_torch.parallel.ep_sp (expert x sequence
parallelism on a stacked grid) against the JAX package's
parallel/ep_sp.py on the 8-device CPU mesh, at ep 2 x sp 2.

The same JAX-initialised MoE weights and numpy tokens:

- the forward (each (ep, sp) shard's logits, gathered), ring and
  Ulysses, within the JAX package's 2e-5 (tests/test_ep_sp.py:83);
- one SGD step at capacity factor 1.25 (tokens drop), ring, flash ring
  (JAX's interpret-mode kernels, the port's plain versions) and Ulysses:
  task loss, aux and params within 3e-5 (tests/test_ep_sp.py:113), every
  gate call's expert choices equal to JAX's on its inputs;
- the flash ring's kernel calls a step (K4's partial triple n_sp a
  block, twice with remat; K5 + K6 n_sp a block); the CLI's ``ep_sp``
  branch and its refusals.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.models.transformer import TransformerConfig as JConfig
from ps_pytorch_tpu.optim import sgd as j_sgd
from ps_pytorch_tpu.parallel import ep_sp as jes
from ps_pytorch_tpu.parallel import moe as jmoe
from ps_pytorch_tpu.parallel.ring_attention import SEQ_AXIS
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig as TConfig
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import ep_sp, moe
from tests.test_torch_moe import check_choices, record_gates
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_tp import LM, assert_trees

tfa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
SHAPE = dict(vocab_size=61, dim=32, depth=2, heads=4, max_seq_len=16)
N_EP, N_SP = 2, 2
B, T = 8, 16
LR = 0.2
TOL = 3e-5  # tests/test_ep_sp.py:113
VARIANTS = {"ring": dict(sp_attention="ring"),
            "ring_flash": dict(sp_attention="ring", attention_impl="flash"),
            "ulysses": dict(sp_attention="ulysses")}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jmoe.init_moe_params(
        JConfig(**SHAPE), jmoe.MoEConfig(num_experts=8), jax.random.key(0)))


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], (B, T)).astype(np.int32)


def _port(params_np, mesh):
    return moe.shard_params_moe(None, convert.params_from_jax(params_np, device="cpu"),
                                mesh.ep)


def _gathered(logits):
    """Stacked ``[sp, ep, b, t, V]`` -> global ``[B, T, V]``."""
    sp, ep, b, t, v = logits.shape
    return logits.permute(1, 2, 0, 3, 4).reshape(ep * b, sp * t, v)


@pytest.mark.parametrize("variant", ["ring", "ulysses"])
def test_torch_ep_sp_forward_matches_jax(jax_params, monkeypatch, variant):
    jcfg = JConfig(**SHAPE, **VARIANTS[variant])
    mcfg = jmoe.MoEConfig(num_experts=8)
    jmesh = jes.make_mesh_ep_sp(N_EP, N_SP)

    def local(p, tok):
        return jmoe.apply_moe_transformer(jcfg, mcfg, p, tok, axis_name=jmoe.EP_AXIS,
                                          seq_axis_name=SEQ_AXIS)[0]

    tok = _tokens(1)
    want = jax.jit(jax.shard_map(local, mesh=jmesh,
                                 in_specs=(jmoe.moe_param_specs(jcfg), P(jmoe.EP_AXIS, SEQ_AXIS)),
                                 out_specs=P(jmoe.EP_AXIS, SEQ_AXIS), check_vma=False))(
        jax_params, jes.shard_tokens_ep_sp(jnp.asarray(tok), jmesh))
    calls = record_gates(monkeypatch)
    cfg = TConfig(**SHAPE, **VARIANTS[variant])
    mesh = ep_sp.make_mesh_ep_sp(N_EP, N_SP)
    got, aux = moe.apply_moe_transformer(cfg, moe.MoEConfig(num_experts=8),
                                         _port(jax_params, mesh),
                                         ep_sp.shard_tokens_ep_sp(torch.from_numpy(tok), mesh),
                                         axis=mesh.ep, seq_axis=mesh.sp)
    check_choices(calls, f"ep_sp forward {variant}")
    assert aux.shape == (N_SP, N_EP)
    np.testing.assert_allclose(_gathered(got).numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    cache = {}

    def get(variant):
        if variant not in cache:
            cfg = JConfig(**SHAPE, **VARIANTS[variant])
            mcfg = jmoe.MoEConfig(num_experts=8)
            mesh = jes.make_mesh_ep_sp(N_EP, N_SP)
            tx = j_sgd(LR)
            p = jmoe.shard_params_moe(cfg, jax_params, mesh)
            step = jes.make_ep_sp_train_step(cfg, mcfg, tx, mesh, donate=False)
            p, _, task, aux = step(p, tx.init(p),
                                   jes.shard_tokens_ep_sp(jnp.asarray(_tokens(2)), mesh))
            cache[variant] = (float(task), float(aux),
                              jax.tree.map(np.asarray, jax.device_get(p)))
        return cache[variant]

    return get


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_torch_ep_sp_step_matches_jax(jax_params, jax_steps, monkeypatch, variant):
    want_task, want_aux, want = jax_steps(variant)
    calls = record_gates(monkeypatch)
    cfg = TConfig(**SHAPE, **VARIANTS[variant])
    mesh = ep_sp.make_mesh_ep_sp(N_EP, N_SP)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = _port(jax_params, mesh)
    p, _, task, aux = ep_sp.make_ep_sp_train_step(cfg, moe.MoEConfig(num_experts=8), tx, mesh)(
        p, tx.init(p), ep_sp.shard_tokens_ep_sp(torch.from_numpy(_tokens(2)), mesh))
    check_choices(calls, f"ep_sp step {variant}")
    assert abs(float(task) - want_task) < TOL, (float(task), want_task)
    assert abs(float(aux) - want_aux) < TOL, (float(aux), want_aux)
    assert_trees(convert.params_to_numpy(moe.unshard_params_moe(cfg, p)), want,
                 rtol=TOL, atol=TOL)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_torch_ep_sp_ring_flash_calls_per_step(jax_params, monkeypatch, remat):
    """K4's partial triple once a hop a block (n_sp hops; the remat
    recompute doubles it), K5 + K6 once a hop a block: every (ep, sp)
    shard's rows in one call."""
    calls = {"partial": 0, "bwd": 0}
    partial, bwd = tfa.flash_partial, tfa.flash_bwd

    def count_partial(q, *a, **kw):
        calls["partial"] += 1
        assert q.shape[0] == N_SP * B  # [sp, ep b] rows in one call
        return partial(q, *a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_partial", count_partial)
    monkeypatch.setattr(tfa, "flash_bwd", count_bwd)
    cfg = TConfig(**SHAPE, attention_impl="flash", remat=remat)
    mesh = ep_sp.make_mesh_ep_sp(N_EP, N_SP)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = _port(jax_params, mesh)
    ep_sp.make_ep_sp_train_step(cfg, moe.MoEConfig(), tx, mesh)(
        p, tx.init(p), ep_sp.shard_tokens_ep_sp(torch.from_numpy(_tokens(3)), mesh))
    hops = SHAPE["depth"] * N_SP
    assert calls == {"partial": hops * (2 if remat else 1), "bwd": hops}


def test_torch_cli_train_lm_ep_sp_runs():
    out = train_lm.main(LM + ["--parallelism", "ep_sp", "--num-shards", "2", "--num-sp", "2",
                              "--remat"])
    losses = [h["loss"] for h in out["history"]]
    assert out["layout"] == "ep 2 (8 experts) x sp 2 (ring)"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(np.isfinite(h["aux_loss"]) for h in out["history"])
    # --num-sp 0 means 2, --num-shards 0 every device over it: 1 on one card
    out = train_lm.main(LM + ["--parallelism", "ep_sp", "--max-steps", "1",
                              "--sp-attention", "ulysses"])
    assert out["layout"] == "ep 1 (8 experts) x sp 2 (ulysses)"
    with pytest.raises(ValueError, match="divisible by num_sp=3"):
        train_lm.main(LM + ["--parallelism", "ep_sp", "--num-sp", "3"])
    with pytest.raises(ValueError, match="divisible by expert shards=3"):
        train_lm.main(LM + ["--parallelism", "ep_sp", "--num-shards", "3"])
