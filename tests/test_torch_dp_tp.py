"""Port parity: ps_pytorch_tpu_torch.parallel.dp_tp (data x tensor
parallelism on a stacked grid) against the JAX package's
parallel/dp_tp.py on the 8-device CPU mesh.

The same JAX-initialised weights (through ``to_tp_layout`` and the
port's ``params_from_jax``) and numpy tokens: two SGD-momentum steps at
dp 2 x tp 4 (and dp 4 x tp 2) match JAX's ``make_dp_tp_train_step`` in
params and loss within rtol = atol = 5e-5 (the JAX package's own bound,
tests/test_dp_tp.py:59), with and without ``shard_vocab``; the port's
loss is also the plain model's batch mean; the CLI's ``dp_tp`` branch
runs and refuses what JAX refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models.transformer import TransformerConfig as JConfig
from ps_pytorch_tpu.optim import sgd as j_sgd
from ps_pytorch_tpu.parallel import dp_tp as jdt
from ps_pytorch_tpu.parallel import tp as jtp
from ps_pytorch_tpu.parallel.mesh import place_on_mesh
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig as TConfig
from ps_pytorch_tpu_torch.models.transformer import apply_transformer
from ps_pytorch_tpu_torch.ops.metrics import next_token_nll
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import dp_tp
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_tp import LM, SHAPE, T, assert_trees, port_plain, port_shards

B = 8
LR, MOMENTUM = 0.1, 0.9
STEPS = 2


@pytest.fixture(scope="module")
def jax_params():
    from ps_pytorch_tpu.models.transformer import init_transformer

    return jax.tree.map(np.asarray, init_transformer(JConfig(**SHAPE), jax.random.key(3)))


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], (B, T)).astype(np.int32)


def _jax_steps(params_np, n_dp, n_tp, shard_vocab):
    cfg = JConfig(**SHAPE)
    mesh = jdt.make_mesh_dp_tp(n_dp, n_tp)
    tx = j_sgd(LR, momentum=MOMENTUM)
    p = place_on_mesh(jtp.to_tp_layout(cfg, params_np), mesh,
                      jtp.tp_param_specs(cfg, shard_vocab=shard_vocab))
    opt = tx.init(p)
    step = jdt.make_dp_tp_train_step(cfg, tx, mesh, donate=False, shard_vocab=shard_vocab)
    losses = []
    for s in range(STEPS):
        p, opt, loss = step(p, opt, jdt.shard_tokens_dp(jnp.asarray(_tokens(s)), mesh))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jtp.from_tp_layout(cfg, p))


def _port_steps(params_np, n_dp, n_tp, shard_vocab):
    cfg = TConfig(**SHAPE)
    mesh = dp_tp.make_mesh_dp_tp(n_dp, n_tp)
    tx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    p = port_shards(params_np, shard_vocab, n=n_tp)
    opt = tx.init(p)
    step = dp_tp.make_dp_tp_train_step(cfg, tx, mesh, shard_vocab)
    losses = []
    for s in range(STEPS):
        tok = dp_tp.shard_tokens_dp(torch.from_numpy(_tokens(s)), mesh)
        assert tok.shape == (n_dp, B // n_dp, T)
        p, opt, loss = step(p, opt, tok)
        losses.append(float(loss))
    return losses, port_plain(p, shard_vocab)


@pytest.mark.parametrize("shard_vocab", [False, True], ids=["replicated", "vocab"])
@pytest.mark.parametrize("n_dp,n_tp", [(2, 4), (4, 2)])
def test_torch_dp_tp_steps_match_jax(jax_params, n_dp, n_tp, shard_vocab):
    want_losses, want = _jax_steps(jax_params, n_dp, n_tp, shard_vocab)
    losses, got = _port_steps(jax_params, n_dp, n_tp, shard_vocab)
    np.testing.assert_allclose(losses, want_losses, rtol=5e-5, atol=5e-5)
    assert_trees(got, want, rtol=5e-5, atol=5e-5)


def test_torch_dp_tp_loss_is_the_plain_batch_mean(jax_params):
    """lr 0: the step's loss is the plain model's mean over the whole
    batch, and the params do not move."""
    cfg = TConfig(**SHAPE)
    mesh = dp_tp.make_mesh_dp_tp(2, 4)
    tx = build_optimizer("sgd", 0.0, momentum=0.0)
    p = port_shards(jax_params, True)
    tok = torch.from_numpy(_tokens(7))
    p2, _, loss = dp_tp.make_dp_tp_train_step(cfg, tx, mesh, True)(
        p, tx.init(p), dp_tp.shard_tokens_dp(tok, mesh))
    plain = convert.params_from_jax(jax_params, device="cpu")
    want = next_token_nll(apply_transformer(cfg, plain, tok), tok)
    torch.testing.assert_close(loss, want, rtol=2e-6, atol=2e-6)
    assert_trees(port_plain(p2, True), jax_params, rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not split over dp 3"):
        dp_tp.shard_tokens_dp(tok, dp_tp.make_mesh_dp_tp(3, 1))


def test_torch_cli_train_lm_dp_tp_runs():
    out = train_lm.main(LM + ["--parallelism", "dp_tp", "--num-dp", "2", "--num-shards", "2",
                              "--shard-vocab"])
    losses = [h["loss"] for h in out["history"]]
    assert out["layout"] == "dp 2 x tp 2 (vocab-parallel)"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert train_lm.main(LM + ["--parallelism", "dp_tp", "--num-dp", "2",
                               "--max-steps", "1"])["layout"] == "dp 2 x tp 1"
    with pytest.raises(ValueError, match="divisible by num_dp=3"):
        train_lm.main(LM + ["--parallelism", "dp_tp", "--num-dp", "3"])
