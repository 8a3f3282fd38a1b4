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
    flash_bwd_plain,
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
    out = ((q, k, v, do), np.array(lse), np.array(delta),
           dict(zip(("dq", "dk", "dv"), (np.array(w) for w in want))))
    for a in (*out[0], out[1], out[2], *out[3].values()):
        a.setflags(write=False)  # shared by the cases: no case may write it
    return out


def _tensor_core_products(q, k, v, do, lse, delta, scale, split):
    """The bf16 K5/K6's arithmetic emulated in torch on the CPU, causal:
    S = Q.K^T and dP = dO.V^T from bf16 values (every product exact in
    f32) summed in f32; p = exp(S scale - lse) and ds = p (dP - delta)
    scale in f32; then each accumulating product (dS.K, dS^T.Q, P^T.dO)
    takes P or dS as a bf16 hi + lo pair (``split``) or rounded once to
    bf16, against the bf16 operand, summed in f32."""
    qf, kf, vf, dof = (_t(x)[:, :, 0].float() for x in (q, k, v, do))
    lse, delta = torch.tensor(lse)[..., None], torch.tensor(delta)[..., None]
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
    """The backward kernels (bf16 and f32 routes) copy 16-byte row chunks:
    head splits of a fused projection and [B, H, T, D] transposes pass as
    they are; a view whose base or row stride breaks 16-byte alignment is
    copied."""
    fa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
    for dtype in (torch.bfloat16, torch.float32):
        step = 16 // torch.tensor([], dtype=dtype).element_size()  # elements in 16 bytes
        qkv = torch.arange(2 * 5 * 384, dtype=torch.float32).to(dtype).view(2, 5, 384)
        k = qkv[..., 128:256].reshape(2, 5, 4, 32)  # row stride 3 H D
        assert fa._rows16(k) is k
        t = torch.zeros(2, 4, 5, 32, dtype=dtype).transpose(1, 2)
        assert fa._rows16(t) is t
        for bad in (qkv.view(-1)[1:1 + 2 * 5 * 128].view(2, 5, 4, 32),  # base off one element
                    qkv[..., :136].reshape(2, 5, 4, 34)[..., :32]):  # row stride 34
            got = fa._rows16(bad)
            assert got is not bad and got.data_ptr() % 16 == 0
            assert all(got.stride(i) % step == 0 for i in range(3)) and torch.equal(got, bad)


# --------------------------------------------- the f32 route's 3xTF32 scheme

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties
    away from zero), on the bit pattern: half of the 13 dropped bits added
    to the magnitude, then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_torch_tf32_rounding_matches_cvt_rna():
    """TF32 keeps 10 mantissa bits: 1 + 2^-11 is a tie and goes away from
    zero, just below it goes down; the sign is kept; exact values and the
    low 13 bits of any result are as cvt.rna leaves them."""
    u = 2.0 ** -10  # one TF32 ulp at 1
    x = torch.tensor([1 + u / 2, 1 + u / 2 - 2 ** -23, -(1 + u / 2), 1 + u, 3.0, 0.0,
                      1 + 1.5 * u, -(1 + u / 2 - 2 ** -23)])
    want = torch.tensor([1 + u, 1.0, -(1 + u), 1 + u, 3.0, 0.0, 1 + 2 * u, -1.0])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(np.float32))
    got = _tf32(r)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())
    assert bool(((got - r).abs() <= r.abs() * 2.0 ** -11).all())


# The mma.m16n8k8 .tf32 fragments (PTX ISA), lane = 4 g + t: (row, col) of
# C register e, (row, k-slot) of A register r, (k-slot, col) of B register r
def _c_frag(lane, e):
    g, t = divmod(lane, 4)
    return g + 8 * (e // 2), 2 * t + e % 2


def _a_frag(lane, r):
    g, t = divmod(lane, 4)
    return g + 8 * (r % 2), t + 4 * (r // 2)


def _b_frag(lane, r):
    g, t = divmod(lane, 4)
    return t + 4 * r, g


# what flash_tf32.cuh's gemm_split_ab does: A register r takes C register
# A_FROM_C[r] of the same lane; B register r reads row 2 t + r of the tile
A_FROM_C = (0, 2, 1, 3)


def _b_row(lane, r):
    return 2 * (lane % 4) + r


def _slot_maps():
    """k-slot -> the C column that A's registers carry into it, and ->
    the B row the kernel reads for it, as the fragment layouts imply; each
    must be one value per slot."""
    a_col, b_row = {}, {}
    for lane in range(32):
        for r in range(4):
            row, slot = _a_frag(lane, r)
            c_row, c_col = _c_frag(lane, A_FROM_C[r])
            assert c_row == row, "an A register must hold its own row's value"
            a_col.setdefault(slot, set()).add(c_col)
        for r in range(2):
            slot, col = _b_frag(lane, r)
            b_row.setdefault(slot, set()).add(_b_row(lane, r))
    assert all(len(v) == 1 for v in (*a_col.values(), *b_row.values()))
    return ([a_col[s].pop() for s in range(8)], [b_row[s].pop() for s in range(8)])


def test_torch_flash_tf32_accumulator_feeds_operand_in_place():
    """P and dS feed dQ += dS.K, dK += dS^T.Q, dV += P^T.dO from their own
    accumulator registers: every A register takes a C register of the same
    lane and row, the k-slots run over the C tile's columns in a permuted
    order, and B's rows are read in that same order, so a fragment-level
    m16n8k8 over random tiles gives C . B."""
    a_perm, b_perm = _slot_maps()
    assert a_perm == b_perm == [0, 2, 4, 6, 1, 3, 5, 7]
    rng = np.random.RandomState(0)
    c, b = rng.randn(16, 8), rng.randn(8, 8)
    a_regs = np.zeros((32, 4))
    b_regs = np.zeros((32, 2))
    for lane in range(32):
        for r in range(4):
            a_regs[lane, r] = c[_c_frag(lane, A_FROM_C[r])]
        for r in range(2):
            b_regs[lane, r] = b[_b_row(lane, r), _b_frag(lane, r)[1]]
    # the hardware's product, from the registers as the fragments place them
    a_tile, b_tile = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        for r in range(4):
            a_tile[_a_frag(lane, r)] = a_regs[lane, r]
        for r in range(2):
            b_tile[_b_frag(lane, r)] = b_regs[lane, r]
    np.testing.assert_allclose(a_tile @ b_tile, c @ b, rtol=1e-12)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_torch_flash_tf32_fragment_reads_are_bank_conflict_free(d):
    """At the f32 tiles' pitch D + 4 words, each warp-wide 32-bit read of
    a fragment touches 32 distinct banks: A and B along D (lane reads row
    g, column t or t + 4) and B along the rows in the permuted order (rows
    2 t and 2 t + 1, column g)."""
    pitch = d + 4
    g, t = np.divmod(np.arange(32), 4)
    reads = {"along D": g * pitch + t, "along D, +4": g * pitch + t + 4,
             "rows 2t": 2 * t * pitch + g, "rows 2t + 1": (2 * t + 1) * pitch + g,
             "A rows g + 8": (g + 8) * pitch + t}
    for name, words in reads.items():
        assert len(set(words % 32)) == 32, name
    # an unpermuted row read (rows t and t + 4) would conflict
    assert len(set((t * pitch + g) % 32)) < 32


def _rz(x):
    """float64 -> f32 rounded toward zero: an mma's sum as the tensor
    cores leave it in their accumulator (they truncate; Fasi et al.,
    "Numerical behavior of NVIDIA tensor cores", 2021)."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _products(x, y, split, a_perm=None, b_perm=None, chain=False, acc=None):
    """x @ y as the f32 kernels' m16n8k8 TF32 products sum it: the
    contraction in steps of 8, each step's products (hi.lo + lo.hi, then
    hi.hi with ``split``: 3xTF32; hi.hi alone: one TF32 product) into a
    fresh accumulator, every mma's sum truncated to f32 (``_rz``), and the
    step added to the running f32 accumulator rounded to nearest, as
    flash_tf32.cuh's mma_3xtf32 does. ``chain``: every mma into the
    running accumulator instead (what the kernels avoid). Operands are
    rounded by ``_tf32``; within a step the k-slots take x's columns in
    ``a_perm`` and y's rows in ``b_perm`` (the accumulator-fed products'
    order). The products are summed in float64, exactly for TF32
    operands, so no f32 matmul setting reaches the result. ``acc``: the
    running f32 accumulator the steps are added to (default zeros)."""
    xh, yh = _tf32(x), _tf32(y)
    xl, yl = _tf32(x - xh), _tf32(y - yh)
    xh, yh, xl, yl = (t.double() for t in (xh, yh, xl, yl))
    if acc is None:
        acc = torch.zeros(x.shape[:-1] + y.shape[-1:])
    for k in range(0, x.shape[-1], 8):
        ca = [k + i for i in (a_perm or range(8))]
        cb = [k + i for i in (b_perm or range(8))]
        pairs = ([(xh, yl), (xl, yh)] if split else []) + [(xh, yh)]
        step = acc if chain else torch.zeros_like(acc)
        for a, b in pairs:
            step = _rz(step.double() + a[..., ca] @ b[..., cb, :])
        acc = step if chain else acc + step
    return acc


@functools.lru_cache(maxsize=None)
def _jax_f32_grads(d):
    """f32 q, k, v, do ([BH, T, D], two causal heads at T 256), the
    forward's lse and delta = rowsum(do * o), and the JAX package's
    ``_flash_bwd`` on them, in interpret mode: f32 products throughout."""
    q, k, v, do = _arrays(2, 256, 256, d, 3 * d, np.float32)
    scale = d ** -0.5
    o, lse = jfa._flash_fwd(_j(q), _j(k), _j(v), scale, True, 64, 64, INTERPRET)
    delta = jnp.sum(_j(do) * o, axis=-1)
    want = jfa._flash_bwd(_j(q), _j(k), _j(v), lse, delta, _j(do), scale, True, 64, 64,
                          INTERPRET, out_dtype=jnp.float32)
    out = ((q, k, v, do), np.array(lse), np.array(delta),
           dict(zip(("dq", "dk", "dv"), (np.array(w) for w in want))))
    for a in (*out[0], out[1], out[2], *out[3].values()):
        a.setflags(write=False)  # shared by the cases: no case may write it
    return out


def _one_thread(fn):
    """Run ``fn`` on one CPU thread (the thread count put back after):
    the TF32 emulations are thousands of small ops, and in a parallel
    test run each op on a full thread pool waits on every core (the
    long-row test took 4 s alone and 852 s beside five other test
    processes). Their values do not depend on it: ``_products`` sums
    exact float64 products of TF32 operands and truncates elementwise."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_num_threads(threads)

    return run


@_one_thread
def _tf32_kernel_grads(q, k, v, do, lse, delta, scale, split, chain=False):
    """The f32 K5 / K6 arithmetic emulated in torch on the CPU, causal:
    K5's S = Q.K^T and dP = dO.V^T, K6's S^T = K.Q^T and dP^T = V.dO^T,
    each a TF32 product over D; p = exp(S scale - lse) and ds = p (dP -
    delta) scale in f32; then dQ += dS.K, dK += dS^T.Q and dV += P^T.dO
    over the keys (queries) with the accumulator-fed k-slot order
    (``_products``; the inputs are copied, never shared)."""
    qf, kf, vf, dof = (torch.tensor(x) for x in (q, k, v, do))
    lse, delta = torch.tensor(lse), torch.tensor(delta)
    t = qf.shape[1]
    keep = torch.ones(t, t, dtype=torch.bool).tril()
    live = lse[..., None] > NEG_INF / 2
    tr = lambda x: x.transpose(-1, -2)
    prod = functools.partial(_products, split=split, chain=chain)
    perms = dict(zip(("a_perm", "b_perm"), _slot_maps()))
    # K5: queries on M
    p = torch.where(keep & live, torch.exp(prod(qf, tr(kf)) * scale - lse[..., None]),
                    torch.zeros(()))
    ds = p * (prod(dof, tr(vf)) - delta[..., None]) * scale
    dq = prod(ds, kf, **perms)
    # K6: keys on M
    pt = torch.where(tr(keep & live),
                     torch.exp(prod(kf, tr(qf)) * scale - lse[:, None, :]), torch.zeros(()))
    dst = pt * (prod(vf, tr(dof)) - delta[:, None, :]) * scale
    return {"dq": dq, "dk": prod(dst, qf, **perms), "dv": prod(pt, dof, **perms)}


@functools.lru_cache(maxsize=None)
def _tf32_grads_of(d, split):
    """``_tf32_kernel_grads`` on ``_jax_f32_grads(d)``'s inputs, computed
    once per (d, split) and shared by the three gradients' cases as
    read-only numpy arrays (the emulation yields dq, dk and dv together)."""
    (q, k, v, do), lse, delta, _ = _jax_f32_grads(d)
    out = {g: t.numpy() for g, t in
           _tf32_kernel_grads(q, k, v, do, lse, delta, d ** -0.5, split=split).items()}
    for a in out.values():
        a.setflags(write=False)  # shared by the cases: no case may write it
    return out


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_torch_flash_bwd_3xtf32_products_match_jax(grad, d):
    """The f32 route's product scheme holds the JAX kernels' f32
    semantics: every product of K5 / K6 as 3xTF32 (operands split into
    TF32 hi + lo pairs by cvt.rna, hi.lo + lo.hi + hi.hi, eight k-slots a
    step summed apart by the truncating tensor cores and added in f32, the
    accumulator-fed products in the kernels' permuted order) stays within
    5e-5 of the largest gradient of ``_flash_bwd`` on f32 inputs; one TF32
    product (hi.hi) does not, which is why the kernels take three."""
    want = _jax_f32_grads(d)[3]
    bound = PRODUCT_TOL * float(np.abs(want[grad]).max())
    three = _tf32_grads_of(d, split=True)[grad]
    one = _tf32_grads_of(d, split=False)[grad]
    err_three = float(np.abs(three - want[grad]).max())
    err_one = float(np.abs(one - want[grad]).max())
    assert err_three <= bound, (err_three, bound)
    assert err_one > bound, (err_one, bound)


def test_torch_flash_tf32_step_sums_hold_long_rows():
    """Why mma_3xtf32 adds each step in f32 outside the tensor cores: they
    truncate the sum an mma leaves, and over a long row (one causal head,
    T 1024, D 64, f32 inputs) that bias, chained through the running
    accumulator, puts dK and dV several times further from float64 than
    f32 sums (``flash_bwd_plain``) are. Summed a step apart, every
    gradient stays within 3x of the f32 sums' error and within 5e-5 of
    the largest gradient."""
    t, d = 1024, 64
    q, k, v, do = _arrays(1, t, t, d, 11, np.float32)
    scale = d ** -0.5
    q64, k64, v64, do64 = (torch.tensor(x, dtype=torch.float64) for x in (q, k, v, do))
    keep = torch.ones(t, t, dtype=torch.bool).tril()
    s = (q64 @ k64.transpose(1, 2) * scale).masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    delta = (do64 * (p @ v64)).sum(-1)
    ds = p * (do64 @ v64.transpose(1, 2) - delta[..., None]) * scale
    exact = (ds @ k64, ds.transpose(1, 2) @ q64, p.transpose(1, 2) @ do64)
    lse32, delta32 = lse.float(), delta.float()
    f32 = flash_bwd_plain(*(torch.tensor(x)[:, :, None] for x in (q, k, v, do)),
                          lse32[:, None], delta32[:, None], True, scale,
                          out_dtype=torch.float32)
    step = _tf32_kernel_grads(q, k, v, do, lse32.numpy(), delta32.numpy(), scale, split=True)
    chain = _tf32_kernel_grads(q, k, v, do, lse32.numpy(), delta32.numpy(), scale,
                               split=True, chain=True)
    for i, name in enumerate(("dq", "dk", "dv")):
        want = exact[i]
        top = float(want.abs().max())
        err = lambda got: float((got.double() - want).abs().max())
        plain, mine, chained = err(f32[i][:, :, 0]), err(step[name]), err(chain[name])
        assert mine <= 3 * plain and mine <= PRODUCT_TOL * top, (name, mine, plain)
        if name != "dq":
            assert chained > 5 * plain, (name, chained, plain)
