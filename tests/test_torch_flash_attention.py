"""Port parity: ps_pytorch_tpu_torch.ops.flash_attention (kernel K4's
module) and parallel/ring_attention.full_attention against the JAX
package.

On the CPU the port runs its plain version; the JAX side runs its Pallas
forward kernel in interpret mode (PS_TPU_PALLAS_INTERPRET=1, as
tests/test_flash_attention.py does). f32 inputs, 1e-5 abs. The kernel is
held against the plain version on the card in
tests/test_torch_kernels_cuda.py; the arithmetic of its bf16 route (the
tensor cores) is emulated here against the JAX kernel.
"""

import functools

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



# ------------------------------------------------ the tensor-core product scheme

# the partial triple's bounds, of the largest magnitude (at least 1):
# chip_smoke.py phase 14's and the card tests'
PARTIAL_TOL = {"pv": 2e-5, "m": 2e-6, "l": 2e-5}


def _bf16_qkv(d):
    """bf16 q, k, v ([BH, T, D] numpy, one causal head pair at T 256)."""
    rng = np.random.RandomState(100 + d)
    return [rng.randn(2, 256, d).astype(np.float32).astype(jnp.bfloat16) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_bf16_fwd(d, normalize):
    """The JAX package's ``_flash_fwd`` on bf16 inputs, in interpret mode as
    its own tests run it (64 x 64 blocks, f32 P in the PV product): (o,
    lse) as f32 numpy when ``normalize``, else (pv, m, l)."""
    q, k, v = (jnp.asarray(x) for x in _bf16_qkv(d))
    out = jfa._flash_fwd(q, k, v, d ** -0.5, True, 64, 64, {"interpret": True},
                         normalize=normalize)
    return tuple(np.asarray(x.astype(jnp.float32)) for x in out)


def _tensor_core_forward(d, split, block=64):
    """The bf16 K4's arithmetic emulated in torch on the CPU, causal: S =
    Q.K^T of one 64-key tile from bf16 values (every product exact in f32)
    summed in f32, times the scale; the mask; the online softmax in f32 (m,
    alpha, p, l = l alpha + rowsum p); acc = acc alpha + P.V with P as a
    bf16 hi + lo pair (``split``) or rounded once to bf16, against bf16 V,
    summed in f32. Returns the partial triple (acc, m, l)."""
    qf, kf, vf = (torch.from_numpy(np.asarray(x, np.float32)) for x in _bf16_qkv(d))
    bh, t, _ = qf.shape
    m = torch.full((bh, t), NEG_INF)
    l = torch.zeros(bh, t)
    acc = torch.zeros(bh, t, d)
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, block):
        kt, vt = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        s = qf @ kt.transpose(-1, -2) * d ** -0.5
        s = torch.where(torch.arange(k0, k0 + block)[None] <= rows, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where((m_new > NEG_INF / 2)[..., None], p, torch.zeros(()))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pieces = (hi, (p - hi).to(torch.bfloat16).float()) if split else (hi,)
        acc = acc * alpha[..., None] + sum(x @ vt for x in pieces)
        m = m_new
    return acc, m, l


def _err(got, want, tol):
    """(max abs error, its bound: ``tol`` of the largest magnitude, at
    least 1)."""
    return (float(np.abs(got.numpy() - want).max()),
            tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("d", [32, 64, 128])
def test_torch_flash_fwd_partial_hi_lo_products_match_jax(d):
    """The tensor-core route's product scheme holds the JAX kernel's f32
    semantics for the partial triple of a ring hop: with P entering
    acc += P.V as a bf16 hi + lo pair, pv, m and l stay within phase 14's
    bounds of ``_flash_fwd(normalize=False)``; rounding P once to bf16
    (FlashAttention-2's scheme) puts pv outside them, which is why the
    kernel takes the extra product."""
    want = dict(zip(("pv", "m", "l"), _jax_bf16_fwd(d, False)))
    split = dict(zip(("pv", "m", "l"), _tensor_core_forward(d, split=True)))
    for key, tol in PARTIAL_TOL.items():
        err, bound = _err(split[key], want[key], tol)
        assert err <= bound, (key, err, bound)
    err_once, bound = _err(_tensor_core_forward(d, split=False)[0], want["pv"],
                           PARTIAL_TOL["pv"])
    assert err_once > bound, (err_once, bound)


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_torch_flash_fwd_normalized_hi_lo_products_match_jax(d):
    """The same scheme for the normalized entry: o, rounded once to bf16 at
    the end, is within one bf16 ulp of ``_flash_fwd(normalize=True)``'s
    and lse within 1e-4 (phase 4's bound). Before that rounding the two
    f32 values may differ by the partial triple's pv bound (o = pv / l,
    sums in another order), which shows on its own where cancellation
    leaves |o| far below the largest; the ulp is added to it."""
    want_o, want_lse = _jax_bf16_fwd(d, True)
    acc, m, l = _tensor_core_forward(d, split=True)
    l_safe = torch.where(l == 0.0, torch.ones(()), l)
    o = (acc / l_safe[..., None]).to(torch.bfloat16).float().numpy()
    f32_bound = PARTIAL_TOL["pv"] * max(1.0, float(np.abs(want_o).max()))
    ulp = _bf16_ulp(np.maximum(np.abs(o), np.abs(want_o)))
    err = np.abs(o - want_o)
    assert bool((err <= ulp + f32_bound).all()), float(err.max())
    assert float((err == 0).mean()) > 0.99  # almost every element rounds alike
    lse = (m + torch.log(l_safe)).numpy()
    assert float(np.abs(lse - want_lse).max()) <= 1e-4
