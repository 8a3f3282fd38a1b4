"""Port parity: the sequence-parallel transformer forward
(models/transformer.make_sp_forward: stacked shards, positions by global
offset, ring or Ulysses attention) and the global-in, global-out ring API
(parallel/ring_attention.make_ring_attention), against the JAX package's
on a 4-device sequence mesh, from the same JAX-initialised weights.
f32; logits within 1e-4 (two blocks of f32 sums in other orders), ring
outputs within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import transformer as jtr
from ps_pytorch_tpu.parallel.ring_attention import make_ring_attention as j_make_ring
from ps_pytorch_tpu.parallel.ring_attention import make_seq_mesh
from ps_pytorch_tpu.parallel.ring_attention import shard_sequence as jra_shard
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models import transformer as ttr
from ps_pytorch_tpu_torch.parallel import ring_attention as tra
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis


@pytest.mark.parametrize("sp_attention,impl", [("ring", "naive"), ("ring", "flash"),
                                               ("ulysses", "flash")])
def test_torch_sp_forward_matches_jax(monkeypatch, sp_attention, impl):
    """make_sp_forward (global tokens in, global logits out, positions by
    global offset) on JAX-initialised weights, against JAX's
    make_sp_forward on a 4-device sequence mesh."""
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")

    shape = dict(vocab_size=40, dim=64, depth=2, heads=4, max_seq_len=32,
                 sp_attention=sp_attention, attention_impl=impl)
    jparams = jtr.init_transformer(jtr.TransformerConfig(**shape), jax.random.key(0))
    tok = np.random.RandomState(3).randint(0, 40, (2, 32)).astype(np.int32)
    mesh = make_seq_mesh(4)
    want = np.asarray(jtr.make_sp_forward(jtr.TransformerConfig(**shape), mesh)(
        jparams, jra_shard(jnp.asarray(tok), mesh)))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    got = ttr.make_sp_forward(ttr.TransformerConfig(**shape), WorkerAxis(4))(
        params, torch.from_numpy(tok).long())
    assert got.shape == (2, 32, 40)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)


def test_torch_make_ring_attention_matches_jax():
    """The global-in, global-out ring API (make_ring_attention)."""
    rng = np.random.RandomState(50)
    q, k, v = (rng.randn(2, 32, 2, 16).astype(np.float32) for _ in range(3))
    mesh = make_seq_mesh(4)
    want = np.asarray(j_make_ring(mesh, causal=True, impl="flash")(
        *(jra_shard(jnp.asarray(x), mesh) for x in (q, k, v))))
    got = tra.make_ring_attention(WorkerAxis(4), causal=True, impl="flash")(
        *(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
