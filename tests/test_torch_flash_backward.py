"""Port parity: the rest of ps_pytorch_tpu_torch.ops.flash_attention — the
shared mask, K4's partial triple (``flash_partial``), the backward K5 +
K6 (``flash_grads_partial`` / ``flash_bwd``) and ``flash_attention``'s
gradients — against the JAX package.

On the CPU the port runs the kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode, called directly (``flash_partial``,
``flash_grads_partial`` take a ``mode``) or under
``PS_TPU_PALLAS_INTERPRET=1`` (``flash_attention``). The JAX functions
take ``[BH, T, D]``; the port's ``[B, T, H, D]`` holds that as ``H = 1``.
Cases: offsets that mask whole hops, partial diagonals, odd Tq != Tk
(JAX pads to its block grid, the port masks ragged tiles), f32 and bf16
inputs. Tolerances: f32 outputs 1e-5 absolute of values of order 1-10
(the same f32 sums, tile by tile with an online rescale in JAX and over
the whole row in the plain version); bf16 inputs give f32 triples and
gradients on both sides (every product of bf16 values is exact in f32),
so they are held to the same bound.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_bwd,
    flash_fwd_plain,
    flash_grads_partial,
    flash_partial,
    mask_scores,
)

# the module (the package's ops namespace exports the function of that name)
jfa = importlib.import_module("ps_pytorch_tpu.ops.flash_attention")

INTERPRET = {"interpret": True}


def _arrays(bh, tq, tk, d, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    mk = lambda t: rng.randn(bh, t, d).astype(np.float32).astype(dtype)
    return mk(tq), mk(tk), mk(tk), mk(tq)


def _t(x):
    """JAX-layout [BH, T, D] numpy -> the port's [BH, T, 1, D] tensor."""
    t = torch.from_numpy(np.asarray(x, np.float32))[:, :, None]
    return t.to(torch.bfloat16) if x.dtype != np.float32 else t


def _j(x):
    return jnp.asarray(x)


HOPS = [
    # tq, tk, causal, q_off, k_off
    (16, 16, True, 16, 0),    # an earlier shard: every key kept
    (16, 16, True, 0, 16),    # a later shard: the whole hop masked
    (16, 16, True, 8, 8),     # the own shard: the diagonal
    (24, 17, True, 5, 9),     # odd Tq != Tk, a cut diagonal
    (12, 20, False, 0, 0),
]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("tq,tk,causal,q_off,k_off", HOPS)
def test_torch_flash_partial_matches_jax_kernel(tq, tk, causal, q_off, k_off, dtype):
    q, k, v, _ = _arrays(3, tq, tk, 16, tq + tk, dtype)
    scale = 16 ** -0.5
    want = jfa.flash_partial(_j(q), _j(k), _j(v), scale, causal, q_off, k_off,
                             block_q=8, block_k=8, mode=INTERPRET)
    got = flash_partial(_t(q), _t(k), _t(v), causal, scale, q_off, k_off)
    pv, m, l = got
    assert pv.dtype == m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(pv[:, :, 0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(m[:, 0].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(l[:, 0].numpy(), np.asarray(want[2]), atol=1e-5, rtol=1e-6)
    if k_off >= q_off + tq:  # the no-op triple (pv 0, m NEG_INF, l 0)
        assert bool((pv == 0).all()) and bool((l == 0).all())
        assert bool((m == NEG_INF).all())


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("tq,tk,causal,q_off,k_off", HOPS)
def test_torch_flash_grads_partial_matches_jax_kernel(tq, tk, causal, q_off, k_off, dtype):
    """One hop's f32 (dq, dk, dv) from a merged lse/delta, including rows
    whose keys are all masked in this hop and rows whose lse is NEG_INF."""
    q, k, v, do = _arrays(3, tq, tk, 16, 7 * tq + tk, dtype)
    scale = 16 ** -0.5
    rng = np.random.RandomState(tq)
    # a merged lse as the ring hands it (other hops count too), one row
    # fully masked everywhere (lse NEG_INF), and a delta
    lse = (rng.rand(3, tq) * 3 + 1).astype(np.float32)
    lse[0, 1] = NEG_INF
    delta = rng.randn(3, tq).astype(np.float32)
    want = jfa.flash_grads_partial(_j(q), _j(k), _j(v), _j(do), _j(lse), _j(delta), scale,
                                   causal, q_off, k_off, block_q=8, block_k=8,
                                   mode=INTERPRET)
    got = flash_grads_partial(_t(q), _t(k), _t(v), _t(do),
                              torch.from_numpy(lse)[:, None],
                              torch.from_numpy(delta)[:, None], scale, causal, q_off, k_off)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g[:, :, 0].numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 13])
def test_torch_flash_bwd_input_dtype_matches_jax(causal, t):
    """The single-device backward (_flash_bwd in the input dtype) from the
    forward's own lse and delta = rowsum(do * o)."""
    q, k, v, do = _arrays(4, t, t, 32, t, np.float32)
    scale = 32 ** -0.5
    pad = -(-t // 8) * 8
    padt = lambda x: jnp.pad(_j(x), ((0, 0), (0, pad - t), (0, 0)))
    k_len = t if pad != t else None
    o, lse = jfa._flash_fwd(padt(q), padt(k), padt(v), scale, causal, 8, 8, INTERPRET,
                            k_len=k_len)
    delta = jnp.sum(padt(do) * o, axis=-1)
    want = jfa._flash_bwd(padt(q), padt(k), padt(v), lse, delta, padt(do), scale, causal,
                          8, 8, INTERPRET, k_len=k_len)
    to, tlse = flash_fwd_plain(_t(q), _t(k), _t(v), causal, scale)
    tdelta = (_t(do) * to).sum(-1).transpose(1, 2)
    got = flash_bwd(_t(q), _t(k), _t(v), _t(do), tlse, tdelta, causal, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g[:, :, 0].numpy(), np.asarray(w)[:, :t], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 12, 100])
def test_torch_flash_attention_grads_match_jax(monkeypatch, t, causal):
    """flash_attention's autograd (K4 forward, K5 + K6 backward in the
    input dtype) against JAX's custom VJP on its interpret-mode kernels."""
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(t)
    q, k, v, w = (rng.randn(2, t, 2, 32).astype(np.float32) for _ in range(4))

    def loss(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, causal=causal) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (flash_attention(*xs, causal=causal) * torch.from_numpy(w)).sum().backward()
    for x, g in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,k_len,q_off,k_off", [
    (True, None, 0, 0), (True, None, 16, 0), (True, 11, 3, 7), (False, 9, 0, 0),
    (True, None, 0, 40),
])
def test_torch_mask_scores_matches_jax_mask(causal, k_len, q_off, k_off):
    """The plain mask against _mask_scores on one whole [Tq, Tk] tile."""
    s = np.random.RandomState(0).randn(16, 16).astype(np.float32)
    want = jfa._mask_scores(_j(s), 0, 0, 16, 16, causal, k_len, q_off, k_off)
    got = mask_scores(torch.from_numpy(s)[None, None], causal, k_len, q_off, k_off)
    assert np.array_equal(got[0, 0].numpy(), np.asarray(want))


def test_torch_mask_scores_per_row_offsets():
    """Tensor offsets, one per batch row (the stacked shards of a ring
    hop), equal the rows' scalar masks."""
    s = torch.randn(3, 2, 8, 8)
    q_off, k_off = torch.tensor([0, 8, 16]), torch.tensor([8, 0, 16])
    got = mask_scores(s, True, None, q_off, k_off)
    for r in range(3):
        want = mask_scores(s[r:r + 1], True, None, int(q_off[r]), int(k_off[r]))
        assert torch.equal(got[r:r + 1], want)


# ------------------------------------------------ the tensor-core product scheme

PRODUCT_TOL = 5e-5  # of the largest gradient: phase 14's and the card tests' bound


@functools.lru_cache(maxsize=None)
def _jax_bf16_grads(d):
    """bf16 q, k, v, do ([BH, T, D], one causal head pair at T 256), the
    forward's lse and delta = rowsum(do * o), and the JAX package's
    ``_flash_bwd`` on them in f32, in interpret mode as its own tests run
    it: exact f32 P and dS in every product."""
    q, k, v, do = _arrays(2, 256, 256, d, d, jnp.bfloat16)
    scale = d ** -0.5
    o, lse = jfa._flash_fwd(_j(q), _j(k), _j(v), scale, True, 64, 64, INTERPRET)
    delta = jnp.sum(_j(do).astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    want = jfa._flash_bwd(_j(q), _j(k), _j(v), lse, delta, _j(do), scale, True, 64, 64,
                          INTERPRET, out_dtype=jnp.float32)
    return ((q, k, v, do), np.array(lse), np.array(delta),
            dict(zip(("dq", "dk", "dv"), (np.array(w) for w in want))))


def _tensor_core_products(q, k, v, do, lse, delta, scale, split):
    """The bf16 K5/K6's arithmetic emulated in torch on the CPU, causal:
    S = Q.K^T and dP = dO.V^T from bf16 values (every product exact in
    f32) summed in f32; p = exp(S scale - lse) and ds = p (dP - delta)
    scale in f32; then each accumulating product (dS.K, dS^T.Q, P^T.dO)
    takes P or dS as a bf16 hi + lo pair (``split``) or rounded once to
    bf16, against the bf16 operand, summed in f32."""
    qf, kf, vf, dof = (_t(x)[:, :, 0].float() for x in (q, k, v, do))
    lse, delta = torch.from_numpy(lse)[..., None], torch.from_numpy(delta)[..., None]
    t = qf.shape[1]
    keep = torch.ones(t, t, dtype=torch.bool).tril()
    s = qf @ kf.transpose(-1, -2) * scale
    p = torch.where(keep & (lse > NEG_INF / 2), torch.exp(s - lse), torch.zeros(()))
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale

    def pieces(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    prod = lambda x, y: sum(piece @ y for piece in pieces(x))
    return {"dq": prod(ds, kf), "dk": prod(ds.transpose(-1, -2), qf),
            "dv": prod(p.transpose(-1, -2), dof)}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_torch_flash_bwd_hi_lo_products_match_jax(grad, d):
    """The tensor-core route's product scheme holds the JAX kernels' f32
    semantics: P and dS entering dq += dS.K, dk += dS^T.Q and dv += P^T.dO
    as a bf16 hi + lo pair stay within 5e-5 of the largest gradient of
    ``_flash_bwd``; rounding them once to bf16 (FlashAttention-2's scheme)
    does not, which is why the kernels take the extra product."""
    (q, k, v, do), lse, delta, want = _jax_bf16_grads(d)
    scale = d ** -0.5
    bound = PRODUCT_TOL * float(np.abs(want[grad]).max())
    split = _tensor_core_products(q, k, v, do, lse, delta, scale, split=True)[grad]
    once = _tensor_core_products(q, k, v, do, lse, delta, scale, split=False)[grad]
    err_split = float(np.abs(split.numpy() - want[grad]).max())
    err_once = float(np.abs(once.numpy() - want[grad]).max())
    assert err_split <= bound, (err_split, bound)
    assert err_once > bound, (err_once, bound)


def test_torch_flash_bwd_rows16_copies_only_misaligned_views():
    """The bf16 backward kernels copy 16-byte row chunks: head splits of a
    fused projection and [B, H, T, D] transposes pass as they are; a view
    whose base or row stride breaks 16-byte alignment is copied."""
    fa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
    qkv = torch.arange(2 * 5 * 384, dtype=torch.float32).to(torch.bfloat16).view(2, 5, 384)
    k = qkv[..., 128:256].reshape(2, 5, 4, 32)  # row stride 3 H D
    assert fa._rows16(k) is k
    t = torch.zeros(2, 4, 5, 32, dtype=torch.bfloat16).transpose(1, 2)
    assert fa._rows16(t) is t
    for bad in (qkv.view(-1)[1:1 + 2 * 5 * 128].view(2, 5, 4, 32),  # base off by 2 bytes
                qkv[..., :144].reshape(2, 5, 4, 36)[..., :32]):     # row stride 36
        got = fa._rows16(bad)
        assert got is not bad and got.data_ptr() % 16 == 0
        assert all(got.stride(i) % 8 == 0 for i in range(3)) and torch.equal(got, bad)
