"""The port's hand-written kernels on the card, against their plain
PyTorch versions (K1 quantize_rows and its multi-tensor shared-scale
entry quantize_rows_scaled_many, K2's multi-tensor quantize_tensors and
its one-piece call quantize_tensor, K3 accumulate_rescale_int8, K4
flash_fwd and its partial triple flash_partial, K5 flash_bwd_dq and K6
flash_bwd_dkv), the serving engine on the card against the same engine on the
CPU, and the gradient wires on the card against the same wires on the CPU
(bit-exact: every op on them is elementwise or an exact integer sum).

Every test here needs a CUDA card and skips without one. This file
imports neither JAX nor the JAX package (the card's machine has no JAX),
so it runs there on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX's CPU mesh.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from ps_pytorch_tpu_torch.models import TransformerConfig, init_transformer
from ps_pytorch_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_bwd,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_bwd_plain,
    flash_fwd,
    flash_fwd_plain,
    flash_partial,
    flash_partial_plain,
)
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.ops import quantize as tq
from ps_pytorch_tpu_torch.ops.quantize import (
    accumulate_rescale_int8,
    accumulate_rescale_plain,
    quantize_int8,
    quantize_rows,
    quantize_rows_plain,
    quantize_rows_scaled_many,
    quantize_rows_scaled_many_plain,
    quantize_tensor,
    quantize_tensor_plain,
    quantize_tensors,
    quantize_tensors_plain,
)
from ps_pytorch_tpu_torch.parallel import collectives
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves, tree_map
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from ps_pytorch_tpu_torch.serve import Request, ServeConfig, ServingEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest --noconftest -m cuda "
                    "tests/test_torch_kernels_cuda.py` on the H100")
    # f32 comparisons need full f32 matmuls on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nb,bs,dtype", [
    (1024, 64, torch.bfloat16),   # prefill write: max_prompt_len * heads rows
    (64, 64, torch.bfloat16),     # decode write: slots * heads rows
    (1001, 128, torch.float32),   # ragged row count
    (3, 33, torch.float32),       # row width not a multiple of 32
    (17, 500, torch.bfloat16),
])
def test_torch_quantize_rows_kernel_bit_exact_on_card(cuda_device, nb, bs, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(nb + bs)
    x = (torch.randn((nb, bs), generator=g, device=cuda_device) * 3).to(dtype)
    x[1] = 0.0
    before = quantize_rows.launches
    q, s = quantize_rows(x)
    qp, sp = quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1
    assert torch.equal(q, qp)
    assert torch.equal(s, sp)


@pytest.mark.cuda
def test_torch_quantize_kernel_rounds_half_to_even_on_card(cuda_device):
    x = torch.full((8, 128), 0.5, device=cuda_device)
    x[0, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5])
    q, s = quantize_int8(x, block_size=128)
    assert q[0, :6].tolist() == [127, 2, -4, 0, 0, 2]
    assert float(s[0, 0]) == 1.0


def _halves(x: torch.Tensor) -> torch.Tensor:
    """Plant exact halves where absmax is 127 (inv == 1): round half to
    even decides them."""
    flat = x.view(-1)
    flat[:6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5])
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((8, 3, 3, 512, 512), torch.float32),  # largest ResNet18 leaf, 8 workers
    ((8, 512), torch.float32),             # a BN leaf
    ((8, 10), torch.float32),              # the dense bias
    ((8, 1001), torch.float32),            # ragged odd length
    ((7, 33), torch.bfloat16),
])
def test_torch_quantize_tensor_kernel_bit_exact_on_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=cuda_device) * 3).to(dtype)
    if dtype == torch.float32:
        # absmax 127 -> inv 1: the planted halves land on .5 exactly
        x = _halves(x.clamp(-100, 100))
    before = quantize_tensors.launches
    q, s = quantize_tensor(x)
    qp, sp = quantize_tensor_plain(x)
    torch.cuda.synchronize()
    assert quantize_tensors.launches == before + 1
    assert q.shape == x.shape and q.dtype == torch.int8 and s.shape == ()
    assert torch.equal(q, qp) and torch.equal(s, sp)
    if dtype == torch.float32:
        assert q.view(-1)[:6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.mark.cuda
def test_torch_quantize_tensor_kernel_all_zero_and_offset_view(cuda_device):
    z = torch.zeros((8, 513), device=cuda_device)
    q, s = quantize_tensor(z)
    assert float(s) == 0.0 and not q.any()
    # an unaligned slice takes the scalar path of both launches
    x = torch.randn(4097, device=cuda_device)[1:]
    q, s = quantize_tensor(x)
    qp, sp = quantize_tensor_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("workers,nb,bs,dtype", [
    (8, 18432, 128, torch.float32),  # the largest ResNet18 leaf at block 128
    (8, 4, 128, torch.float32),
    (3, 5, 33, torch.float32),
    (2, 9, 64, torch.bfloat16),
])
def test_torch_quantize_rows_scaled_kernel_bit_exact_on_card(cuda_device, workers,
                                                            nb, bs, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(nb + bs)
    x = (torch.randn((workers, nb * bs), generator=g, device=cuda_device) * 3).to(dtype)
    x.view(workers, nb, bs)[:, 1] = 0.0  # a block all-zero on every worker
    if dtype == torch.float32:
        x[0, 2 * bs:3 * bs] = 0.5
        x[0, 2 * bs:2 * bs + 6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5])
        x[1:, 2 * bs:3 * bs] = 0.0  # block 2's absmax is 127 (inv 1): halves decide
    before = quantize_rows_scaled_many.launches
    (q, s, a), = quantize_rows_scaled_many([x], bs)
    (qp, sp, ap), = quantize_rows_scaled_many_plain([x], bs)
    torch.cuda.synchronize()
    assert quantize_rows_scaled_many.launches == before + 1
    assert q.shape == (workers, nb, bs) and s.shape == (nb, 1)
    assert torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(a, ap)
    assert float(s[1, 0]) == 0.0
    if dtype == torch.float32:
        assert q[0, 2, :6].tolist() == [127, 2, -4, 0, 0, 2]


def _resnet18_pieces(dev, dtype=torch.float32, seed=0):
    """ResNet18's 62 leaves stacked for 8 workers, magnitudes varying by
    worker and leaf: the per-leaf wire's pieces of one step."""
    params, _ = build_model("ResNet18").init(torch.Generator().manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for leaf in tree_leaves(params):
        scale = torch.exp(torch.randn((8,) + (1,) * leaf.dim(), generator=g, device=dev) * 2)
        out.append((torch.randn((8,) + tuple(leaf.shape), generator=g, device=dev)
                    * scale).to(dtype))
    return out


def _same_many(got, want):
    assert len(got) == len(want)
    for (q, s, a), (qp, sp, ap) in zip(got, want):
        assert q.shape == qp.shape and s.shape == sp.shape
        assert torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(a, ap)


@pytest.mark.cuda
def test_torch_quantize_tensors_kernel_resnet18_leaves_on_card(cuda_device):
    """The per-leaf wire's step: 62 pieces in ONE call, bit-exact, and
    the same bits twice."""
    xs = _resnet18_pieces(cuda_device)
    before = quantize_tensors.launches
    got = quantize_tensors(xs)
    again = quantize_tensors(xs)
    torch.cuda.synchronize()
    assert quantize_tensors.launches == before + 2
    _same_many(got, quantize_tensors_plain(xs))
    _same_many(again, got)


@pytest.mark.cuda
def test_torch_quantize_rows_scaled_many_kernel_resnet18_leaves_on_card(cuda_device):
    """The block-128 wire's step: 62 pieces in ONE call (ragged leaves:
    their last block is padded in the kernel), bit-exact, twice equal."""
    xs = _resnet18_pieces(cuda_device, seed=1)
    before = quantize_rows_scaled_many.launches
    got = quantize_rows_scaled_many(xs, 128)
    again = quantize_rows_scaled_many(xs, 128)
    torch.cuda.synchronize()
    assert quantize_rows_scaled_many.launches == before + 2
    _same_many(got, quantize_rows_scaled_many_plain(xs, 128))
    _same_many(again, got)


def _odd_pieces(dev, count, seed):
    """``count`` worker-stacked pieces of assorted lengths (0 included,
    multiples of 4 or not), f32 and bf16, every third f32 one a view one
    element past an aligned start (the element-wise load path)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        n = int(rng.choice([0, 1, 3, 4, 127, 128, 129, 1000, 4099, 9001]))
        flat = torch.randn(8 * n + 1, generator=g, device=dev) * float(np.exp(rng.randn() * 3))
        x = (flat[1:] if i % 3 == 1 else flat[:-1]).view(8, n)
        out.append(x.to(torch.bfloat16) if i % 5 == 3 else x)
    return out


@pytest.mark.cuda
def test_torch_quantize_tensors_kernel_300_pieces_on_card(cuda_device):
    """300 pieces: more than one descriptor table (MAX_PIECES each), with
    0-length, misaligned and bf16 pieces among them; one wrapper call."""
    xs = _odd_pieces(cuda_device, 300, 3)
    assert len(tq.plan_tensor_tables([x.numel() for x in xs])) > 4
    before = quantize_tensors.launches
    got = quantize_tensors(xs)
    torch.cuda.synchronize()
    assert quantize_tensors.launches == before + 1
    _same_many(got, quantize_tensors_plain(xs))


@pytest.mark.cuda
def test_torch_quantize_rows_scaled_many_kernel_300_pieces_on_card(cuda_device):
    xs = _odd_pieces(cuda_device, 300, 4)
    assert len(tq.plan_rows_tables([-(-x.shape[1] // 128) for x in xs])) > 4
    for bs in (128, 33):
        before = quantize_rows_scaled_many.launches
        got = quantize_rows_scaled_many(xs, bs)
        torch.cuda.synchronize()
        assert quantize_rows_scaled_many.launches == before + 1
        _same_many(got, quantize_rows_scaled_many_plain(xs, bs))


@pytest.mark.cuda
def test_torch_quantize_many_kernels_misaligned_views_on_card(cuda_device):
    """Views one element past a 16-byte boundary take the element-wise
    loads, decided per piece; the aligned pieces beside them keep float4."""
    flat = torch.randn(8 * 4096 + 8, device=cuda_device)
    xs = [flat[1:1 + 8 * 4096].view(8, 4096), flat[:8 * 4096].view(8, 4096),
          flat[3:3 + 8 * 129].view(8, 129), torch.zeros((8, 0), device=cuda_device)]
    _same_many(quantize_tensors(xs), quantize_tensors_plain(xs))
    _same_many(quantize_rows_scaled_many(xs, 128), quantize_rows_scaled_many_plain(xs, 128))


@pytest.mark.cuda
def test_torch_quantize_many_kernels_non_finite_piece_on_card(cuda_device):
    """A piece holding inf and NaN runs without a fault (its payload need
    not match: the non-finite guard skips such a step); the finite pieces
    beside it stay bit-exact."""
    xs = _resnet18_pieces(cuda_device, seed=2)[:6]
    xs[2].view(-1)[5] = float("inf")
    xs[2].view(-1)[77] = float("nan")
    for got, want in ((quantize_tensors(xs), quantize_tensors_plain(xs)),
                      (quantize_rows_scaled_many(xs, 128),
                       quantize_rows_scaled_many_plain(xs, 128))):
        torch.cuda.synchronize()
        _same_many(got[:2] + got[3:], want[:2] + want[3:])


def _attn_inputs(b, t, h, d, dtype, seed, dev, layout):
    """q, k, v ``[B, T, H, D]``: ``"fused"`` head splits of one [B, T, 3 H
    D] projection (strided rows, no copy), ``"dense"`` contiguous tensors,
    ``"misaligned"`` views whose base lies 2 or 4 bytes past a 16-byte
    boundary (the bf16 route copies them first: ``_rows16``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "fused":
        qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dtype)
        return [a.reshape(b, t, h, d) for a in qkv.split(h * d, dim=-1)]
    n = b * t * h * d
    flat = torch.randn((3 * n + 1,), generator=g, device=dev).to(dtype)
    off = 1 if layout == "misaligned" else 0
    return [flat[off + i * n:off + (i + 1) * n].view(b, t, h, d) for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,dtype,causal,kw,layout", [
    (1, 128, 8, 64, torch.bfloat16, True, {}, "fused"),   # the serving prefill shape
    (1, 128, 8, 64, torch.float32, True, {}, "fused"),
    (1, 100, 8, 64, torch.float32, True, {}, "fused"),
    (2, 100, 4, 32, torch.float32, False, {}, "fused"),
    (1, 200, 2, 128, torch.float32, True, {}, "fused"),
    (1, 77, 3, 64, torch.float32, True, {"q_off": 5, "k_off": 30, "k_len": 60}, "fused"),
    # bf16: the tensor-core route at every head dim and edge
    (1, 128, 8, 32, torch.bfloat16, True, {}, "fused"),   # D = 32
    (1, 200, 2, 128, torch.bfloat16, True, {}, "fused"),  # D = 128, ragged T
    (2, 100, 4, 64, torch.bfloat16, True, {}, "dense"),   # ragged T
    (2, 100, 4, 32, torch.bfloat16, False, {}, "dense"),
    (1, 77, 3, 64, torch.bfloat16, True, {"q_off": 5, "k_off": 30, "k_len": 60}, "fused"),
    (1, 64, 2, 64, torch.bfloat16, True, {"q_off": 0, "k_off": 64}, "dense"),  # all masked
    (2, 130, 4, 64, torch.bfloat16, True, {}, "misaligned"),
])
def test_torch_flash_kernel_matches_plain_on_card(cuda_device, b, t, h, d,
                                                  dtype, causal, kw, layout):
    """K4 normalized against flash_fwd_plain; two runs give the same bits
    (no atomics)."""
    q, k, v = _attn_inputs(b, t, h, d, dtype, t + d, cuda_device, layout)
    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, causal=causal, **kw)
    o2, lse2 = flash_fwd(q, k, v, causal=causal, **kw)
    op, lsep = flash_fwd_plain(q, k, v, causal, d ** -0.5, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 2
    assert o.dtype == dtype and o.shape == (b, t, h, d)
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "changed between two runs"
    if dtype == torch.bfloat16:
        torch.testing.assert_close(o.float(), op.float(), atol=2e-2, rtol=1e-2)
        torch.testing.assert_close(lse, lsep, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(o, op, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, lsep, atol=1e-5, rtol=0)
    if kw.get("k_off") == 64:  # every key masked: o = 0, lse = NEG_INF
        assert not o.any() and bool((lse == NEG_INF).all())


def _assert_near(got, want, tol):
    """f32 sums in another order: the kernels sum keys (or queries) tile by
    tile (K4 with an online rescale; K5/K6 on bf16 inputs with tensor-core
    products that take P and dS as a bf16 hi + lo pair, on f32 inputs with
    3xTF32 tensor-core products), the plain versions over the whole row
    with matmuls. Held to ``tol`` of the result's largest magnitude,
    elementwise."""
    want = want.float()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol * scale)


def _hop_inputs(b, tq, tk, h, d, dtype, seed, dev, layout="dense"):
    """q, k, v, do; ``layout="fused"`` gives head splits of fused
    projections (q, k, v of one [B, T, 3 H D] tensor, do of a [B, T, 2 H
    D] one: strided rows, no copy) and needs tq == tk; ``"misaligned"``
    views whose base lies one element past a 16-byte boundary (the
    tensor-core routes copy them first: ``_rows16``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "misaligned":
        mk = lambda t: torch.randn((b * t * h * d + 1,), generator=g,
                                   device=dev).to(dtype)[1:].view(b, t, h, d)
        return mk(tq), mk(tk), mk(tk), mk(tq)
    if layout == "fused":
        qkv = torch.randn((b, tq, 3 * h * d), generator=g, device=dev).to(dtype)
        q, k, v = (a.reshape(b, tq, h, d) for a in qkv.split(h * d, dim=-1))
        dd = torch.randn((b, tq, 2 * h * d), generator=g, device=dev).to(dtype)
        return q, k, v, dd[..., h * d:].reshape(b, tq, h, d)
    mk = lambda t: torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    return mk(tq), mk(tk), mk(tk), mk(tq)


def _offsets(kind, dev):
    """Scalars, or one (q_off, k_off) per batch row: two stacked shards
    of a 2-way ring at hop 1 (row 0 sees a later shard: every key masked;
    row 1 an earlier one: every key kept)."""
    if kind == "ring":
        return (torch.tensor([0, 256], device=dev), torch.tensor([256, 0], device=dev))
    return kind


FLASH_HOP_CASES = [
    # b, tq, tk, h, d, dtype, causal, offsets, layout
    (8, 1024, 1024, 8, 64, torch.bfloat16, True, (0, 0), "dense"),  # LM-1, one hop
    (2, 256, 256, 8, 64, torch.bfloat16, True, "ring", "dense"),    # stacked ring hop
    (2, 256, 256, 8, 64, torch.float32, True, "ring", "dense"),
    (1, 100, 77, 3, 32, torch.float32, True, (5, 30), "dense"),     # ragged, cut diagonal
    (2, 64, 64, 2, 128, torch.float32, True, (0, 64), "dense"),     # whole hop masked
    (2, 50, 70, 2, 64, torch.float32, False, (0, 0), "dense"),
    # bf16: the tensor-core route of K5/K6 at every head dim and edge
    (2, 192, 192, 4, 32, torch.bfloat16, True, (0, 0), "dense"),    # D = 32
    (2, 160, 160, 2, 128, torch.bfloat16, True, (0, 0), "dense"),   # D = 128, ragged T
    (1, 100, 77, 3, 64, torch.bfloat16, True, (5, 30), "dense"),    # ragged, cut diagonal
    (2, 256, 256, 4, 128, torch.bfloat16, True, "ring", "dense"),   # stacked ring, D = 128
    (2, 256, 256, 4, 32, torch.bfloat16, True, "ring", "dense"),    # stacked ring, D = 32
    (2, 64, 64, 2, 128, torch.bfloat16, True, (0, 64), "dense"),    # whole hop masked
    (2, 50, 70, 2, 32, torch.bfloat16, False, (0, 0), "dense"),
    (2, 192, 192, 4, 64, torch.bfloat16, True, (0, 0), "fused"),    # strided head splits
    (2, 130, 130, 4, 64, torch.bfloat16, True, "ring", "misaligned"),  # copied first
    # f32: the TF32 route of K5/K6 at every head dim, layout and LM-1
    (8, 1024, 1024, 8, 64, torch.float32, True, (0, 0), "dense"),   # LM-1, one hop
    (2, 256, 256, 4, 128, torch.float32, True, "ring", "dense"),    # stacked ring, D = 128
    (2, 256, 256, 4, 32, torch.float32, True, "ring", "dense"),     # stacked ring, D = 32
    (2, 160, 160, 2, 128, torch.float32, True, (0, 0), "dense"),    # D = 128, ragged T
    (2, 192, 192, 4, 64, torch.float32, True, (0, 0), "fused"),     # strided head splits
    (2, 130, 130, 4, 64, torch.float32, True, "ring", "misaligned"),   # copied first
    # Ulysses over LM-ring's whole sequence (2 of 8 heads a rank at sp 4):
    # the longest f32 rows, where truncated tensor-core sums would drift most
    (2, 8192, 8192, 2, 64, torch.float32, True, (0, 0), "dense"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dtype,causal,offsets,layout", FLASH_HOP_CASES)
def test_torch_flash_partial_kernel_matches_plain_on_card(cuda_device, b, tq, tk, h, d,
                                                          dtype, causal, offsets, layout):
    """K4's partial triple against flash_partial_plain; two runs give the
    same bits (no atomics)."""
    q, k, v, _ = _hop_inputs(b, tq, tk, h, d, dtype, tq + d, cuda_device, layout)
    q_off, k_off = _offsets(offsets, cuda_device)
    before = flash_partial.launches
    pv, m, l = flash_partial(q, k, v, causal, d ** -0.5, q_off, k_off)
    again = flash_partial(q, k, v, causal, d ** -0.5, q_off, k_off)
    pvp, mp, lp = flash_partial_plain(q, k, v, causal, d ** -0.5, q_off, k_off)
    torch.cuda.synchronize()
    assert flash_partial.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip((pv, m, l), again)), \
        "changed between two runs"
    assert pv.dtype == m.dtype == l.dtype == torch.float32
    assert pv.shape == (b, tq, h, d) and m.shape == l.shape == (b, h, tq)
    _assert_near(pv, pvp, 2e-5)
    _assert_near(m, mp, 2e-6)
    _assert_near(l, lp, 2e-5)
    if offsets in ("ring", (0, 64)):  # a wholly masked hop is the no-op triple
        row = 0
        assert bool((pv[row] == 0).all()) and bool((l[row] == 0).all())
        assert bool((m[row] == NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dtype,causal,offsets,layout", FLASH_HOP_CASES)
@pytest.mark.parametrize("out", ["f32", "input"])
def test_torch_flash_bwd_kernels_match_plain_on_card(cuda_device, b, tq, tk, h, d, dtype,
                                                     causal, offsets, layout, out):
    """K5 and K6 against flash_bwd_plain from the plain forward's final lse
    and delta; f32 outputs (ring hops) and input-dtype outputs (the
    single-device backward: bf16 outputs may differ by one bf16 ulp of
    the largest gradient). Two runs give the same bits (no atomics)."""
    q, k, v, do = _hop_inputs(b, tq, tk, h, d, dtype, tk + d, cuda_device, layout)
    q_off, k_off = _offsets(offsets, cuda_device)
    scale = d ** -0.5
    o, lse = flash_fwd_plain(q, k, v, causal, scale, q_off=q_off, k_off=k_off)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    out_dtype = torch.float32 if out == "f32" else None
    n5, n6 = flash_bwd_dq.launches, flash_bwd_dkv.launches
    got = flash_bwd(q, k, v, do, lse, delta, causal, scale, q_off, k_off,
                    out_dtype=out_dtype)
    again = flash_bwd(q, k, v, do, lse, delta, causal, scale, q_off, k_off,
                      out_dtype=out_dtype)
    want = flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, q_off, k_off,
                           out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches - n5, flash_bwd_dkv.launches - n6) == (2, 2)
    tol = 1e-2 if (out == "input" and dtype == torch.bfloat16) else 5e-5
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, g2), f"{name} changed between two runs"
        _assert_near(g, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq,tk,k_len,causal,offsets", [
    (100, 90, 70, False, (0, 0)),    # keys past k_len masked mid-tile
    (130, 130, 64, True, (20, 0)),   # k_len on a tile edge, a cut diagonal
])
def test_torch_flash_bwd_kernels_key_length_on_card(cuda_device, dtype, tq, tk, k_len,
                                                    causal, offsets):
    """K5 and K6 with the key-length mask (``k_len``, local key positions)
    against flash_bwd_plain, from the plain forward's lse and delta under
    the same mask; f32 outputs, the same tolerance and determinism."""
    q, k, v, do = _hop_inputs(2, tq, tk, 4, 64, dtype, tq + k_len, cuda_device)
    q_off, k_off = offsets
    scale = 64 ** -0.5
    o, lse = flash_fwd_plain(q, k, v, causal, scale, k_len, q_off, k_off)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, lse, delta, causal, scale, q_off, k_off, k_len)
    got = flash_bwd(*args, out_dtype=torch.float32)
    again = flash_bwd(*args, out_dtype=torch.float32)
    want = flash_bwd_plain(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, g2), f"{name} changed between two runs"
        _assert_near(g, w, 5e-5)
    assert not got[1][:, k_len:].any() and not got[2][:, k_len:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("t,causal,dtype", [(100, True, torch.float32),
                                            (64, False, torch.float32),
                                            (128, True, torch.bfloat16)])
def test_torch_flash_attention_grads_on_card_match_cpu(cuda_device, t, causal, dtype):
    """flash_attention's autograd (K4 forward, K5 + K6 backward in the
    input dtype) on the card against the same Function on the CPU (the
    plain versions)."""
    rng = np.random.RandomState(t)
    xs = [torch.from_numpy(rng.randn(2, t, 4, 64).astype(np.float32)).to(dtype)
          for _ in range(4)]
    grads = {}
    for dev in ("cpu", cuda_device):
        q, k, v = (x.to(dev).detach().requires_grad_(True) for x in xs[:3])
        o = flash_attention(q, k, v, causal=causal)
        o.backward(xs[3].to(dev))
        grads[str(dev)] = [x.grad.cpu() for x in (q, k, v)]
    tol = 1e-2 if dtype == torch.bfloat16 else 5e-5
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert g.dtype == dtype
        _assert_near(g, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_torch_engine_on_card_matches_cpu_engine(cuda_device, int8):
    """The engine on the card (kernels) emits the tokens the same engine
    emits on the CPU (plain versions), and launches K4 once per block per
    prefill and K1 twice per block per prefill and per decode step."""
    cfg = TransformerConfig(vocab_size=97, dim=128, depth=2, heads=2,
                            max_seq_len=64, attention_impl="flash")
    params = init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    serve = ServeConfig(slots=3, max_len=48, max_prompt_len=12, kv_int8=int8)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, 97, p).astype(np.int32),
                    max_new_tokens=n)
            for i, (p, n) in enumerate([(5, 9), (1, 6), (12, 8), (7, 14)])]
    outs = {}
    for dev in ("cpu", cuda_device):
        engine = ServingEngine(cfg, params, serve, device=dev)
        engine.warmup()
        k4, k1 = flash_fwd.launches, quantize_rows.launches
        p0, d0 = engine.n_prefills, engine.n_decode_steps
        outs[str(dev)] = [c.tokens for c in
                          engine.decode_requests([dataclasses.replace(r) for r in reqs])]
        if dev != "cpu":
            prefills = engine.n_prefills - p0
            steps = engine.n_decode_steps - d0
            assert prefills == 3
            assert flash_fwd.launches - k4 == cfg.depth * prefills
            assert quantize_rows.launches - k1 == (
                2 * cfg.depth * (prefills + steps) if int8 else 0)
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [
    (8, 11173968),  # the ResNet18 fused stacked payload (16-byte path)
    (8, 1396746),   # one region of it (byte path: s % 16 != 0)
    (8, 130), (1, 1), (258, 4096), (1, 300), (8, 16), (3, 17),
])
def test_torch_accumulate_rescale_kernel_bit_exact_on_card(cuda_device, n, s):
    g = torch.Generator(device=cuda_device).manual_seed(n + s)
    recv = torch.randint(-127, 128, (n, s), generator=g, device=cuda_device,
                         dtype=torch.int32).to(torch.int8)
    recv[:, 0] = 127  # a full-scale column: acc = 127 n
    for d in (5.0, 8.0, float(n), torch.tensor(float(n), device=cuda_device)):
        before = accumulate_rescale_int8.launches
        out = accumulate_rescale_int8(recv, d)
        plain = accumulate_rescale_plain(recv, d)
        torch.cuda.synchronize()
        assert accumulate_rescale_int8.launches == before + 1
        assert out.dtype == torch.int8 and tuple(out.shape) == (s,)
        assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 5, 6, 8, 16])
def test_torch_accumulate_rescale_kernel_every_accumulator_on_card(cuda_device, d):
    """Every accumulator value in [-127 d, 127 d] rounds to the exact
    rounded quotient (half to even), from an aligned and from an
    unaligned base pointer."""
    target = np.arange(-127 * d, 127 * d + 1)
    rows, rest = [], target.copy()
    for _ in range(d):
        rows.append(np.clip(rest, -127, 127))
        rest = rest - rows[-1]
    recv = torch.from_numpy(np.stack(rows).astype(np.int8)).to(cuda_device)
    exact = torch.from_numpy(np.clip(np.round(target / d), -127, 127).astype(np.int8))
    assert torch.equal(accumulate_rescale_int8(recv, float(d)).cpu(), exact)
    buf = torch.empty(recv.numel() + 1, dtype=torch.int8, device=cuda_device)
    shifted = buf[1:].view(recv.shape)  # contiguous, base address odd
    shifted.copy_(recv)
    assert torch.equal(accumulate_rescale_int8(shifted, float(d)).cpu(), exact)


def _grads(device):
    rng = np.random.RandomState(0)
    scale = np.exp(rng.randn(8, 1) * 2).astype(np.float32)

    def leaf(*shape):
        x = rng.randn(8, *shape).astype(np.float32)
        return torch.from_numpy(x * scale.reshape((8,) + (1,) * len(shape))).to(device)

    return {"conv": {"kernel": leaf(3, 3, 16, 32), "bias": leaf(32)},
            "dense": leaf(512, 10), "odd": leaf(301),
            "zero": torch.zeros((8, 9), device=device)}


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_bytes", [None, 0, 65536])
@pytest.mark.parametrize("block", [0, 128])
@pytest.mark.parametrize("compress,domain", [
    ("int8", "dequant"), ("int8", "homomorphic"),
    ("int8_2round", "dequant"), ("int8_2round", "homomorphic"),
])
def test_torch_wires_on_card_match_cpu(cuda_device, compress, domain, block, bucket_bytes):
    """The aggregate and the EF contribution on the card (the kernels)
    equal the same wire on the CPU (the plain versions), bit for bit."""
    perm = torch.tensor([3, 0, 6, 1, 5, 2, 7, 4])
    kw = dict(num_aggregate=5, perm=perm, compress=compress, quant_block_size=block,
              bucket_bytes=bucket_bytes, wire_domain=domain, flat_output=True,
              return_contribution=True)
    g = _grads("cpu")
    k3 = accumulate_rescale_int8.launches
    agg_gpu, c_gpu = collectives.aggregate_gradients(
        tree_map(lambda t: t.to(cuda_device), g), WorkerAxis(8), 8, **kw)
    agg_cpu, c_cpu = collectives.aggregate_gradients(g, WorkerAxis(8), 8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(agg_gpu.cpu(), agg_cpu)
    for a, b in zip(tree_leaves(c_gpu), tree_leaves(c_cpu)):
        assert torch.equal(a.cpu(), b)
    pieces = 1 if bucket_bytes == 0 else (5 if bucket_bytes is None else None)
    if compress == "int8_2round" and domain == "homomorphic" and pieces:
        assert accumulate_rescale_int8.launches - k3 == pieces
