"""Port parity: ps_pytorch_tpu_torch.ops.flash_attention (kernel K4's
module) and parallel/ring_attention.full_attention against the JAX
package.

On the CPU the port runs its plain version; the JAX side runs its Pallas
forward kernel in interpret mode (PS_TPU_PALLAS_INTERPRET=1, as
tests/test_flash_attention.py does). f32 inputs, 1e-5 abs. The kernel is
held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.ops import flash_attention as jfa
from ps_pytorch_tpu.parallel.ring_attention import full_attention as j_full
from ps_pytorch_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_fwd,
    flash_fwd_plain,
)
from ps_pytorch_tpu_torch.parallel.ring_attention import full_attention


def _qkv(b, t, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("t", [16, 12, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_torch_flash_matches_jax_interpret_kernel(monkeypatch, t, causal):
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")
    q, k, v = _qkv(2, t, 2, 32, seed=t)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (2, t, 2, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_torch_flash_lse_is_masked_logsumexp(causal):
    q, k, v = _qkv(1, 100, 3, 32, seed=7)
    scale = 32 ** -0.5
    _, lse = flash_fwd(*_t(q, k, v), causal=causal)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    if causal:
        s = np.where(np.tril(np.ones((100, 100), bool))[None, None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (1, 3, 100) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)


def test_torch_flash_offsets_and_key_length_match_jax_kernel():
    """Runtime causal offsets and the key-length mask, with rows whose
    keys are all masked (o = 0, lse = NEG_INF), against the JAX forward
    kernel called directly in interpret mode."""
    b, t, h, d = 1, 32, 2, 32
    q, k, v = _qkv(b, t, h, d, seed=3)
    fold = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))
    for offsets, k_len in [((0, 8), None), ((4, 0), 20), ((0, 40), None)]:
        oj, lj = jfa._flash_fwd(
            fold(q), fold(k), fold(v), d ** -0.5, True, 16, 16,
            {"interpret": True}, offsets=offsets, k_len=k_len,
        )
        ot, lt = flash_fwd(*_t(q, k, v), causal=True, k_len=k_len,
                           q_off=offsets[0], k_off=offsets[1])
        want_o = np.asarray(oj).reshape(b, h, t, d).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(ot.numpy(), want_o, atol=1e-5, rtol=0)
        np.testing.assert_allclose(lt.numpy().reshape(b * h, t), np.asarray(lj),
                                   atol=1e-5, rtol=0)
    # k_off = 40 masks every key for every row
    assert np.all(ot.numpy() == 0.0)
    assert np.all(lt.numpy() == np.float32(NEG_INF))


@pytest.mark.parametrize("causal", [True, False])
def test_torch_full_attention_matches_jax(causal):
    q, k, v = _qkv(2, 12, 4, 8, seed=11)
    want = np.asarray(j_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal))
    got = full_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_torch_flash_is_forward_only():
    q, k, v = _t(*_qkv(1, 8, 1, 32, seed=0))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        flash_attention(q, k, v, causal=True)  # no gradient asked: fine

