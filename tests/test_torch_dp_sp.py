"""Port parity: ps_pytorch_tpu_torch.parallel.dp_sp (the dp x sp LM train
step on the stacked backend) against the JAX package's
``make_lm_train_step`` on the 8-device CPU mesh.

The same JAX-initialised weights (carried across by
``models/convert.params_from_jax``) and the same numpy token batches go
through 3 steps of SGD (lr 0.1, momentum 0.9) at (dp 2, sp 4), naive and
flash attention (JAX's ring flash on its interpret-mode kernels, the
port's on the kernels' plain versions). Losses and params are held to the
JAX package's own dp_sp tolerances (tests/test_dp_sp.py: loss rtol 1e-5,
params rtol 2e-4 / atol 2e-5): JAX differentiates each device's local
loss and psums the grads over sp, then pmeans over dp; the port runs one
backward over the sum of every worker's local loss, the same sum in
another order. Remat gives the port the same numbers as no remat; bf16
block math stays within a stated bound of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.models.transformer import TransformerConfig as JConfig
from ps_pytorch_tpu.models.transformer import init_transformer as j_init
from ps_pytorch_tpu.optim import sgd as j_sgd
from ps_pytorch_tpu.parallel.dp_sp import lm_loss_local as j_loss_local
from ps_pytorch_tpu.parallel.dp_sp import make_lm_train_step as j_step
from ps_pytorch_tpu.parallel.dp_sp import make_mesh_2d as j_mesh
from ps_pytorch_tpu.parallel.dp_sp import shard_tokens_2d as j_shard
from ps_pytorch_tpu.parallel.mesh import WORKER_AXIS
from ps_pytorch_tpu.parallel.ring_attention import SEQ_AXIS
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig as TConfig
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import dp_sp as tdp
from tests.test_torch_one_thread import _one_thread  # noqa: F401


B, T, V = 4, 32, 48
SHAPE = dict(vocab_size=V, dim=32, depth=2, heads=2, max_seq_len=T)
DP, SP = 2, 4
STEPS = 3


@pytest.fixture(scope="module")
def jax_params():
    return j_init(JConfig(**SHAPE), jax.random.key(0))


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, (B, T)).astype(np.int32) for _ in range(STEPS)]


def _run_jax(params, cfg_kw):
    cfg = JConfig(**SHAPE, **cfg_kw)
    mesh = j_mesh(DP, SP)
    tx = j_sgd(0.1, momentum=0.9)
    opt = tx.init(params)
    step = j_step(cfg, tx, mesh, donate=False)
    losses = []
    for tok in _batches():
        params, opt, loss = step(params, opt, j_shard(jnp.asarray(tok), mesh))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def _run_port(params, cfg_kw):
    cfg = TConfig(**SHAPE, **cfg_kw)
    mesh = tdp.make_mesh_2d(DP, SP)
    tx = build_optimizer("sgd", 0.1, momentum=0.9)
    params = convert.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    opt = tx.init(params)
    step = tdp.make_lm_train_step(cfg, tx, mesh)
    losses = []
    for tok in _batches():
        params, opt, loss = step(params, opt, tdp.shard_tokens_2d(torch.from_numpy(tok), mesh))
        losses.append(float(loss))
    return losses, convert.params_to_numpy(params)


def _assert_params(got, want, rtol, atol):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def runs(jax_params):
    """Each configuration's (losses, params), JAX's and the port's, run
    once for the module."""
    cache = {}

    def get(side, impl, remat=False):
        key = (side, impl, remat)
        if key not in cache:
            run = _run_jax if side == "jax" else _run_port
            cache[key] = run(jax_params, dict(attention_impl=impl, remat=remat))
        return cache[key]

    return get


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_torch_dp_sp_steps_match_jax(runs, impl, remat):
    """The port with and without remat against JAX's step without it
    (JAX's remat gives its no-remat numbers: tests/test_ring_flash.py)."""
    want_losses, want_params = runs("jax", impl)
    losses, params = runs("port", impl, remat)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_params(params, want_params, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_torch_dp_sp_remat_is_no_remat(runs, impl):
    """Remat recomputes each block's forward (the ring's included) in
    backward: the same numbers, bit for bit."""
    plain, remat = runs("port", impl), runs("port", impl, True)
    assert plain[0] == remat[0]
    _assert_params(remat[1], plain[1], rtol=0, atol=0)


def test_torch_dp_sp_bf16_compute_within_bound(jax_params):
    """bf16 block math over f32 params: the two frameworks round bf16 at
    other places (casts, fused GELU), so the losses agree to 2e-3
    relative and the params to 2e-3 absolute after 3 steps (updates of
    ~1e-2 per step at lr 0.1)."""
    want_losses, want_params = _run_jax(
        jax_params, dict(attention_impl="flash", compute_dtype=jnp.bfloat16))
    losses, params = _run_port(
        jax_params, dict(attention_impl="flash", compute_dtype=torch.bfloat16))
    np.testing.assert_allclose(losses, want_losses, rtol=2e-3)
    _assert_params(params, want_params, rtol=0, atol=2e-3)


def test_torch_dp_sp_local_losses_and_shards_match_jax(jax_params):
    """Every worker's local loss slice (the quantity each differentiates),
    worker by worker: JAX's [dp, sp] against the port's [sp, dp]."""
    tok = _batches(1)[0]
    mesh = j_mesh(DP, SP)

    def local(p, t):
        return j_loss_local(JConfig(**SHAPE), p, t, SEQ_AXIS)[None, None]

    mapped = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(WORKER_AXIS, SEQ_AXIS)),
                           out_specs=P(WORKER_AXIS, SEQ_AXIS), check_vma=False)
    want = np.asarray(jax.jit(mapped)(jax_params, j_shard(jnp.asarray(tok), mesh)))
    tmesh = tdp.make_mesh_2d(DP, SP)
    shards = tdp.shard_tokens_2d(torch.from_numpy(tok), tmesh)
    # worker (i, j) holds batch rows i*B/dp.. and positions j*T/sp..
    np.testing.assert_array_equal(shards[1, 0].numpy(), tok[:B // DP, T // SP:2 * T // SP])
    params = convert.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    got = tdp.lm_loss_local(TConfig(**SHAPE), params, shards, tmesh)
    assert got.shape == (SP, DP)
    np.testing.assert_allclose(got.detach().numpy().T, want, rtol=1e-5)
    assert tmesh.worker_ids().tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
