"""Port parity: ps_pytorch_tpu_torch.parallel.tp (Megatron tensor
parallelism on a stacked axis of shards) against the JAX package's
parallel/tp.py on the 8-device CPU mesh.

The same JAX-initialised weights cross through ``to_tp_layout`` /
``shard_params_tp`` of the port's ``params_from_jax``, and the same numpy
tokens go through both.

- the layout round trips (plain -> TP layout -> stacked shards and back)
  are bit-exact, and the port's TP layout is JAX's array for array;
- forward logits match JAX's ``make_tp_forward`` within 2e-5 (the JAX
  package's own tolerance, tests/test_tp.py:62), naive and flash (JAX's
  interpret-mode kernels, the port's plain versions), with and without
  remat, with and without ``shard_vocab``;
- two SGD-momentum steps' params and losses match JAX's
  ``make_tp_train_step`` within rtol = atol = 3e-5 (tests/test_tp.py:134),
  with and without ``shard_vocab``;
- one attention call a block over all shards' heads (K4 once a block, twice
  with remat; K5 and K6 once), on tp and on dp_tp;
- ``vocab_parallel_nll`` equals the gathered loss, and the CLI's ``tp``
  branch runs, writes the plain layout and refuses what JAX refuses.
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
from ps_pytorch_tpu.parallel import tp as jtp
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig as TConfig
from ps_pytorch_tpu_torch.ops.metrics import next_token_nll
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import tp
from tests.test_torch_one_thread import _one_thread  # noqa: F401

# the module (the ops package re-exports its function under the same name)
tfa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
SHAPE = dict(vocab_size=64, dim=32, depth=2, heads=4, max_seq_len=16)
N = 4
B, T = 2, 16
LR, MOMENTUM = 0.1, 0.9
STEPS = 2


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, j_init(JConfig(**SHAPE), jax.random.key(0)))


def _tokens(seed=0, b=B):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], (b, T)).astype(np.int32)


def port_shards(params_np, shard_vocab=False, n=N):
    cfg = TConfig(**SHAPE)
    plain = convert.params_from_jax(params_np, device="cpu")
    return tp.shard_params_tp(cfg, tp.to_tp_layout(cfg, plain), tp.make_tp_mesh(n),
                              shard_vocab)


def port_plain(params, shard_vocab=False):
    """Stacked port params -> the plain tree as numpy."""
    cfg = TConfig(**SHAPE)
    return convert.params_to_numpy(
        tp.from_tp_layout(cfg, tp.unshard_params_tp(cfg, params, shard_vocab)))


def assert_trees(got, want, rtol, atol):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_torch_tp_layout_round_trips_bit_exact(jax_params):
    cfg, jcfg = TConfig(**SHAPE), JConfig(**SHAPE)
    plain = convert.params_from_jax(jax_params, device="cpu")
    lay = tp.to_tp_layout(cfg, plain)
    want = jax.tree.map(np.asarray, jtp.to_tp_layout(jcfg, jax_params))
    for g, w in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(lay)),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and np.array_equal(g, w)
    for sv in (False, True):
        shards = tp.shard_params_tp(cfg, lay, tp.make_tp_mesh(N), sv)
        assert shards["blocks"][0]["wqkv"].shape == (N, 32, 3, 1, 8)
        assert shards["blocks"][0]["w_down"].shape == (N, 32, 32)
        assert shards["embed"].shape == ((N, 16, 32) if sv else (64, 32))
        for g, w in zip(jax.tree_util.tree_leaves(port_plain(shards, sv)),
                        jax.tree_util.tree_leaves(jax_params)):
            assert np.array_equal(g, w)


def test_torch_tp_refuses_what_jax_refuses(jax_params):
    cfg = TConfig(**SHAPE)
    lay = tp.to_tp_layout(cfg, convert.params_from_jax(jax_params, device="cpu"))
    with pytest.raises(ValueError, match="heads 4 not divisible by 3"):
        tp.shard_params_tp(cfg, lay, tp.make_tp_mesh(3))
    cfg_v = TConfig(**{**SHAPE, "vocab_size": 62})
    with pytest.raises(ValueError, match="vocab 62 not divisible by 4"):
        tp.shard_params_tp(cfg_v, lay, tp.make_tp_mesh(4), shard_vocab=True)


def _jax_forward(params_np, kw, shard_vocab):
    cfg = JConfig(**SHAPE, **kw)
    mesh = jtp.make_tp_mesh(N)
    p = jtp.shard_params_tp(cfg, jtp.to_tp_layout(cfg, params_np), mesh,
                            shard_vocab=shard_vocab)
    fwd = jtp.make_tp_forward(cfg, mesh, shard_vocab=shard_vocab)
    return np.asarray(fwd(p, jnp.asarray(_tokens(1))))


@pytest.mark.parametrize("shard_vocab", [False, True], ids=["replicated", "vocab"])
@pytest.mark.parametrize("impl,remat", [("naive", False), ("naive", True),
                                        ("flash", False), ("flash", True)])
def test_torch_tp_forward_matches_jax(jax_params, impl, remat, shard_vocab):
    """JAX's remat gives its no-remat logits (tests/test_tp.py:67), so both
    remat settings of the port hold against JAX's forward without it."""
    want = _jax_forward(jax_params, dict(attention_impl=impl), shard_vocab)
    cfg = TConfig(**SHAPE, attention_impl=impl, remat=remat)
    fwd = tp.make_tp_forward(cfg, tp.make_tp_mesh(N), shard_vocab)
    got = fwd(port_shards(jax_params, shard_vocab), torch.from_numpy(_tokens(1)))
    assert got.shape == (B, T, SHAPE["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_torch_vocab_parallel_nll_is_the_gathered_loss(jax_params):
    cfg = TConfig(**SHAPE)
    mesh = tp.make_tp_mesh(N)
    tok = torch.from_numpy(_tokens(2))
    local = tp.apply_transformer_tp(cfg, port_shards(jax_params, True), tok, mesh, True)
    assert local.shape == (N, B, T, SHAPE["vocab_size"] // N)
    full = torch.cat(list(local.unbind(0)), dim=-1)
    torch.testing.assert_close(tp.vocab_parallel_nll(local, tok, mesh),
                               next_token_nll(full, tok), rtol=1e-6, atol=1e-6)


def _jax_steps(params_np, shard_vocab):
    cfg = JConfig(**SHAPE)
    mesh = jtp.make_tp_mesh(N)
    tx = j_sgd(LR, momentum=MOMENTUM)
    p = jtp.shard_params_tp(cfg, jtp.to_tp_layout(cfg, params_np), mesh,
                            shard_vocab=shard_vocab)
    opt = tx.init(p)
    step = jtp.make_tp_train_step(cfg, tx, mesh, donate=False, shard_vocab=shard_vocab)
    losses = []
    for s in range(STEPS):
        p, opt, loss = step(p, opt, jnp.asarray(_tokens(10 + s)))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jtp.from_tp_layout(cfg, p))


def port_steps(params_np, shard_vocab, **cfg_kw):
    cfg = TConfig(**SHAPE, **cfg_kw)
    mesh = tp.make_tp_mesh(N)
    tx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    p = port_shards(params_np, shard_vocab)
    opt = tx.init(p)
    step = tp.make_tp_train_step(cfg, tx, mesh, shard_vocab)
    losses = []
    for s in range(STEPS):
        p, opt, loss = step(p, opt, torch.from_numpy(_tokens(10 + s)))
        losses.append(float(loss))
    return losses, port_plain(p, shard_vocab)


@pytest.mark.parametrize("shard_vocab", [False, True], ids=["replicated", "vocab"])
def test_torch_tp_steps_match_jax(jax_params, shard_vocab):
    want_losses, want = _jax_steps(jax_params, shard_vocab)
    losses, got = port_steps(jax_params, shard_vocab)
    np.testing.assert_allclose(losses, want_losses, rtol=3e-5, atol=3e-5)
    assert_trees(got, want, rtol=3e-5, atol=3e-5)
    assert losses[1] != losses[0]


def test_torch_tp_remat_step_is_the_step(jax_params):
    """Remat recomputes each block's forward in backward: the same numbers."""
    plain = port_steps(jax_params, True)
    remat = port_steps(jax_params, True, remat=True)
    assert plain[0] == remat[0]
    assert_trees(remat[1], plain[1], rtol=0, atol=0)


@pytest.mark.parametrize("scheme,remat", [("tp", False), ("tp", True), ("dp_tp", True)])
def test_torch_tp_attention_calls_per_step(jax_params, monkeypatch, scheme, remat):
    """flash_fwd (K4) and flash_bwd (K5 + K6) wrapper calls a step on the
    flash path: one a block over every shard's (and dp row's) heads."""
    from ps_pytorch_tpu_torch.parallel import dp_tp

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_fwd, tfa.flash_bwd

    def count_fwd(q, *a, **kw):
        calls["fwd"] += 1
        assert q.shape == (N * B, T, SHAPE["heads"] // N, 8)  # shards fold into B
        return fwd(q, *a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", count_fwd)
    monkeypatch.setattr(tfa, "flash_bwd", count_bwd)
    cfg = TConfig(**SHAPE, attention_impl="flash", remat=remat)
    tx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    p = port_shards(jax_params, True)
    tok = torch.from_numpy(_tokens(4))
    if scheme == "tp":
        tp.make_tp_train_step(cfg, tx, tp.make_tp_mesh(N), True)(p, tx.init(p), tok)
    else:
        mesh = dp_tp.make_mesh_dp_tp(2, N)
        dp_tp.make_dp_tp_train_step(cfg, tx, mesh, True)(p, tx.init(p),
                                                         dp_tp.shard_tokens_dp(tok, mesh))
    depth = SHAPE["depth"]
    assert calls == {"fwd": depth * (2 if remat else 1), "bwd": depth}


LM = ["--device", "cpu", "--vocab-size", "48", "--dim", "32", "--depth", "2", "--heads",
      "4", "--seq-len", "16", "--batch-size", "4", "--max-steps", "4", "--log-interval",
      "1", "--lr", "0.1", "--attention-impl", "flash"]


def test_torch_cli_train_lm_tp_runs_and_writes_the_plain_layout(tmp_path):
    from ps_pytorch_tpu_torch.checkpoint import listify_raw, load_checkpoint_raw

    out = train_lm.main(LM + ["--parallelism", "tp", "--num-shards", "4", "--shard-vocab",
                              "--train-dir", str(tmp_path)])
    losses = [h["loss"] for h in out["history"]]
    assert out["layout"] == "tp 4 (vocab-parallel)"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    raw = load_checkpoint_raw(str(tmp_path), 4)
    params = listify_raw(raw["params"])
    assert np.asarray(params["blocks"][0]["wqkv"]).shape == (32, 96)
    assert np.asarray(params["embed"]).shape == (48, 32)
    assert raw["model"]["kind"] == "dense" and raw["step"] == 4
    # --num-shards 0: every device, one on the one card
    assert train_lm.main(LM + ["--parallelism", "tp", "--max-steps", "1"])["layout"] == "tp 1"
    with pytest.raises(ValueError, match="heads 4 not divisible by 3"):
        train_lm.main(LM + ["--parallelism", "tp", "--num-shards", "3"])
