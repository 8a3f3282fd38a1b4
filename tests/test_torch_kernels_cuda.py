"""The port's hand-written kernels on the card, against their plain
PyTorch versions (K1's KV pool write quantize_kv_write, its multi-tensor
shared-scale entry quantize_rows_scaled_many and the per-row calls that
run it at one worker, quantize_rows_many and quantize_rows, K2's
multi-tensor quantize_tensors and its one-piece call quantize_tensor,
the split routes of K2 and of K1's shared-scale entry, K3
accumulate_rescale_int8, K4
flash_fwd and its partial triple flash_partial, K5 flash_bwd_dq and K6
flash_bwd_dkv, also at the tensor and pipeline schemes' shard shapes), the
serving engine on the card against the same engine on the
CPU (also across a hot checkpoint rollover), the gradient wires on the card against the same wires on the CPU
(bit-exact: every op on them is elementwise or an exact integer sum), and
the MoE steps (moe, ep_sp) on the card against the CPU, with the same
expert choices; and the profiler's padded captures, each holding all its
device events.

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
    quantize_kv_write,
    quantize_kv_write_plain,
    quantize_rows,
    quantize_rows_many,
    quantize_rows_many_plain,
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
    """quantize_rows is quantize_rows_many's one-piece call, on the
    lane-group kernel: one launch, bit-exact."""
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
    (qm, sm), = quantize_rows_many([x])
    assert torch.equal(qm, qp) and torch.equal(sm, sp)


SLOTS_KV = 4


def _kv_pool(slots, max_len, heads, hd, dev):
    """One layer's sentinel-filled int8 pool views (k_q, k_s, v_q, v_s)."""
    g = torch.Generator(device=dev).manual_seed(hd)
    shape = (slots, max_len, heads, hd)
    q = [torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int32)
         .to(torch.int8) for _ in range(2)]
    s = [torch.full(shape[:-1] + (1,), c, device=dev) for c in (-3.5, 7.25)]
    return [q[0], s[0], q[1], s[1]]


def _kv_inputs(rows, heads, hd, dtype, dev, seed, layout="fused"):
    """K and V ``[rows, H, hd]``: head splits of one projection (strided,
    as the engine hands them over), or views 4 bytes past a 16-byte
    boundary (the element loop); an all-zero head vector."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "fused":
        qkv = (torch.randn((rows, 3 * heads * hd), generator=g, device=dev) * 3).to(dtype)
        k, v = (a.reshape(rows, heads, hd) for a in qkv.split(heads * hd, dim=1)[1:])
    else:
        n = rows * heads * hd
        flat = (torch.randn((2 * n + 2,), generator=g, device=dev) * 3).to(dtype)
        k, v = (flat[2 + i * n:2 + (i + 1) * n].view(rows, heads, hd) for i in range(2))
    k[0, 0] = 0.0
    return k, v


def _kv_write_both(k, v, pool, **where):
    """The kernel and the plain version on copies of one pool: the
    kernel's pool, the plain version's, and the kernel's launches."""
    plain = [t.clone() for t in pool]
    before = quantize_kv_write.launches
    quantize_kv_write(k, v, *pool, **where)
    launches = quantize_kv_write.launches - before
    quantize_kv_write_plain(k, v, *plain, **where)
    torch.cuda.synchronize()
    return pool, plain, launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 77, 128])
def test_torch_kv_write_kernel_prefill_bit_exact_on_card(cuda_device, dtype, hd, t):
    """A prefill write into slot 5 of an 8-slot pool: every pool tensor
    equals the plain version's, rows past T and the other slots
    untouched, one launch."""
    heads = 8
    pool = _kv_pool(8, 256, heads, hd, cuda_device)
    before = [x.clone() for x in pool]
    k, v = _kv_inputs(t, heads, hd, dtype, cuda_device, seed=t + hd)
    got, want, launches = _kv_write_both(k, v, pool, slot=5)
    assert launches == 1
    for a, b, orig in zip(got, want, before):
        assert torch.equal(a, b)
        assert torch.equal(a[:5], orig[:5]) and torch.equal(a[6:], orig[6:])
        assert torch.equal(a[5, t:], orig[5, t:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
def test_torch_kv_write_kernel_decode_bit_exact_on_card(cuda_device, dtype, hd, pos_dtype):
    """A decode write for 8 slots: positions 0, max_len - 1 and -1 are
    written, max_len and -(max_len + 1) dropped; every pool tensor equals
    the plain version's and only the written rows changed."""
    heads, max_len = 8, 256
    pool = _kv_pool(8, max_len, heads, hd, cuda_device)
    before = [x.clone() for x in pool]
    pos = torch.tensor([3, max_len - 1, max_len, 0, -1, 100, -(max_len + 1), 17],
                       dtype=pos_dtype, device=cuda_device)
    k, v = _kv_inputs(8, heads, hd, dtype, cuda_device, seed=hd)
    got, want, launches = _kv_write_both(k, v, pool, pos=pos)
    assert launches == 1
    written = {(0, 3), (1, max_len - 1), (3, 0), (4, max_len - 1), (5, 100), (7, 17)}
    for a, b, orig in zip(got, want, before):
        assert torch.equal(a, b)
        changed = (a != orig).reshape(8, max_len, -1).any(-1).nonzero().tolist()
        assert {tuple(c) for c in changed} <= written


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,layout", [
    (torch.bfloat16, 64, "misaligned"),  # 4 bytes past a boundary: the element loop
    (torch.float32, 64, "misaligned"),
    (torch.bfloat16, 96, "fused"),       # 12 lanes a row: the element loop
    (torch.float32, 256, "fused"),       # 64 lanes a row: the element loop
])
def test_torch_kv_write_kernel_element_loop_on_card(cuda_device, dtype, hd, layout):
    pool = _kv_pool(4, 32, 2, hd, cuda_device)
    k, v = _kv_inputs(4, 2, hd, dtype, cuda_device, seed=hd, layout=layout)
    for where in (dict(slot=2), dict(pos=torch.tensor([31, 32, 0, 5], device=cuda_device,
                                                      dtype=torch.int32))):
        got, want, launches = _kv_write_both(k, v, pool, **where)
        assert launches == 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_torch_quantize_rows_many_kernel_resnet18_round2_on_card(cuda_device):
    """The block-128 two-round wire's round 2 on ResNet18's 62 leaves:
    each leaf's region sums [8, s] as [8 s / 128, 128] rows, all in ONE
    call, bit-exact against the plain version, the same bits twice."""
    xs = []
    for x in _resnet18_pieces(cuda_device, seed=3):
        n = x[0].numel()
        s = (-(-n // 8) + 127) // 128 * 128
        flat = torch.nn.functional.pad(x.reshape(8, n), (0, 8 * s - n)).reshape(8, 8 * s)
        xs.append(flat.sum(0).reshape(-1, 128))  # a partial sum's rows
    before = quantize_rows_many.launches
    got = quantize_rows_many(xs)
    again = quantize_rows_many(xs)
    torch.cuda.synchronize()
    assert quantize_rows_many.launches == before + 2
    want = quantize_rows_many_plain(xs)
    for (q, s), (q2, s2), (qp, sp) in zip(got, again, want):
        assert torch.equal(q, qp) and torch.equal(s, sp)
        assert torch.equal(q2, q) and torch.equal(s2, s)


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


def _odd_pieces(dev, count, seed, workers=8):
    """``count`` worker-stacked pieces of assorted lengths (0 included,
    multiples of 4 or not), f32 and bf16, every third f32 one a view one
    element past an aligned start (the element-wise load path)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        n = int(rng.choice([0, 1, 3, 4, 127, 128, 129, 1000, 4099, 9001]))
        flat = (torch.randn(workers * n + 1, generator=g, device=dev)
                * float(np.exp(rng.randn() * 3)))
        x = (flat[1:] if i % 3 == 1 else flat[:-1]).view(workers, n)
        out.append(x.to(torch.bfloat16) if i % 5 == 3 else x)
    return out


def _bf16_views(dev, workers, seed):
    """bf16 pieces on both of K1's bf16 load kinds: whole 8-byte words
    (aligned, n % 4 == 0: block 128 takes the lane mapping) and views
    one element off, or with n % 4 != 0 (element by element)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for n, off in ((4096, 0), (4096, 1), (1000, 0), (1001, 0), (130, 2), (128 * 37, 4)):
        flat = (torch.randn(workers * n + off, generator=g, device=dev) * 3).to(torch.bfloat16)
        out.append(flat[off:].view(workers, n))
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
@pytest.mark.parametrize("workers", [8, 1, 2, 3, 4, 5, 6, 7, 9])
@pytest.mark.parametrize("block", [0, 128, 33])
def test_torch_split_routes_bit_exact_on_card(cuda_device, block, workers):
    """The split routes (absmax, then the quantize with a given absmax:
    K2's per tensor, K1's shared-scale per block) over assorted pieces of
    1-9 local workers (9: K1's element loop at block 128, up to 8 its
    lane mapping), f32 and bf16 on both load kinds, lengths with n % 4 !=
    0 among them, equal their plain versions and the fused entry; one
    wrapper call a half; a NaN-only worker row gives its piece scale NaN
    and an all-zero payload, as a NaN absmax from another process would,
    and a block row of NaN only (every worker) gives that row's scale NaN
    and zero payload beside finite rows."""
    xs = (_odd_pieces(cuda_device, 300 if workers == 8 else 60, 5, workers)
          + _bf16_views(cuda_device, workers, 6))
    if block:
        absmax, given = tq.rows_scaled_absmax, tq.quantize_rows_scaled_given
        plain = (lambda ys: tq.rows_scaled_absmax_plain(ys, block),
                 lambda ys, a: tq.quantize_rows_scaled_given_plain(ys, block, a))
        run = lambda ys: given(ys, block, absmax(ys, block))
        fused = lambda ys: quantize_rows_scaled_many(ys, block)
    else:
        absmax, given = tq.tensors_absmax, tq.quantize_tensors_given
        plain = (tq.tensors_absmax_plain, tq.quantize_tensors_given_plain)
        run = lambda ys: given(ys, absmax(ys))
        fused = quantize_tensors
    before = (absmax.launches, given.launches)
    got = run(xs)
    torch.cuda.synchronize()
    assert (absmax.launches, given.launches) == (before[0] + 1, before[1] + 1)
    _same_many(got, plain[1](xs, plain[0](xs)))
    _same_many(got, fused(xs))
    for dtype in (torch.float32, torch.bfloat16):
        ys = [x.to(dtype).clone() for x in xs if x.shape[1] >= 256][:4]
        ys[2][-1] = float("nan")  # a worker's row: every block of the piece
        ys[3].view(workers, -1)[:, :max(block, 1)] = float("nan")  # block row 0 only
        got = run(ys)
        want = plain[1](ys, plain[0](ys))
        for (q, s, a), (qp, sp, ap) in zip(got, want):
            assert torch.equal(q, qp)
            assert torch.equal(s.view(torch.int32), sp.view(torch.int32))
        assert bool(torch.isnan(got[2][1]).all()) and not bool(got[2][0].any())
        assert bool(torch.isnan(got[3][1].reshape(-1)[0]))
        if block:
            assert not bool(got[3][0][:, 0].any())
            assert bool(torch.isfinite(got[3][1].reshape(-1)[1:]).all())


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


def _bits(t):
    """A tensor's bits: an f32 tensor as int32 (NaN equal to NaN of the
    same bits), any other as it is."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_torch_quantize_kernels_non_finite_only_pieces_bit_exact_on_card(cuda_device, bad):
    """A piece or row holding NaN and no inf (or inf and no NaN) through
    each entry of K1 and K2: the absmax keeps the NaN (scale NaN, payload
    0) or is +inf (inverse 0, inf * 0 sent to 0), bit for bit the plain
    version's, beside finite pieces that stay bit-exact."""
    dev = cuda_device
    # K2 and K1's shared-scale entry: worker-stacked pieces, f32 and bf16
    xs = _resnet18_pieces(dev, seed=5)[:6] + [_resnet18_pieces(dev, torch.bfloat16, 6)[3]]
    xs[2].view(-1)[77] = bad
    xs[4].view(-1)[-1] = -bad
    xs[6].view(-1)[100] = bad
    _same_bits(quantize_tensors(xs), quantize_tensors_plain(xs))
    _same_bits(quantize_rows_scaled_many(xs, 128), quantize_rows_scaled_many_plain(xs, 128))
    _same_bits(quantize_rows_scaled_many(xs, 33), quantize_rows_scaled_many_plain(xs, 33))
    # K1's per-row entries: one bad element in a row, and a whole bad row
    g = torch.Generator(device=dev).manual_seed(9)
    for bs, dtype in ((128, torch.float32), (64, torch.bfloat16), (33, torch.float32)):
        x = (torch.randn((40, bs), generator=g, device=dev) * 3).to(dtype)
        x[3, 5] = bad
        x[11] = -bad
        _same_bits([quantize_rows(x)], [quantize_rows_plain(x)])
        _same_bits(quantize_rows_many([x, x[20:]]), quantize_rows_many_plain([x, x[20:]]))
    # K1's KV entry: prefill and decode writes into the int8 pool
    for dtype in (torch.bfloat16, torch.float32):
        k, v = _kv_inputs(SLOTS_KV, 8, 64, dtype, dev, seed=12)
        k[1, 2, 7] = bad
        v[2, 5] = -bad
        for where in (dict(slot=1), dict(pos=torch.tensor([0, 5, 9, 2], device=dev))):
            pool, plain, launches = _kv_write_both(k, v, _kv_pool(4, 16, 8, 64, dev), **where)
            assert launches == 1
            _same_bits([pool], [plain])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bs,dtype", [(128, torch.float32), (64, torch.bfloat16),
                                      (33, torch.float32), (500, torch.bfloat16)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_torch_quantize_rows_many_kernel_300_pieces_on_card(cuda_device, bs, dtype, misaligned):
    """300 pieces of 0-40 rows (five descriptor tables) in one call, a
    launch a table, on the lane groups or, for odd widths and a piece 4
    bytes past a 16-byte boundary, the element loop; an all-zero row
    among them."""
    g = torch.Generator(device=cuda_device).manual_seed(bs)
    rng = np.random.RandomState(bs)
    xs = []
    for i in range(300):
        r = int(rng.randint(0, 41))
        flat = (torch.randn(r * bs + 2, generator=g, device=cuda_device)
                * float(np.exp(rng.randn() * 3))).to(dtype)
        xs.append((flat[2:] if misaligned and i == 7 else flat[:-2]).view(r, bs))
    xs[3] = torch.zeros((5, bs), device=cuda_device, dtype=dtype)
    assert len(tq.plan_rows_tables([x.shape[0] for x in xs])) == 5
    before = quantize_rows_many.launches
    got = quantize_rows_many(xs)
    torch.cuda.synchronize()
    assert quantize_rows_many.launches == before + 5
    for (q, s), (qp, sp) in zip(got, quantize_rows_many_plain(xs)):
        assert q.shape == qp.shape and s.shape == sp.shape
        assert torch.equal(q, qp) and torch.equal(s, sp)


def _attn_inputs(b, t, h, d, dtype, seed, dev, layout):
    """q, k, v ``[B, T, H, D]``: ``"fused"`` head splits of one [B, T, 3 H
    D] projection (strided rows, no copy), ``"dense"`` contiguous tensors,
    ``"misaligned"`` views whose base lies 2 or 4 bytes past a 16-byte
    boundary (both routes copy them first: ``_rows16``)."""
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
    # f32: the TF32 route's edges and its longest rows
    (1, 64, 2, 64, torch.float32, True, {"q_off": 0, "k_off": 64}, "dense"),  # all masked
    (2, 130, 4, 64, torch.float32, True, {}, "misaligned"),
    (1, 128, 8, 32, torch.float32, True, {}, "fused"),    # D = 32
    (2, 8192, 2, 64, torch.float32, True, {}, "dense"),   # Ulysses over LM-ring's sequence
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
    tile (K4 with an online rescale) with tensor-core products, on bf16
    inputs taking P and dS as a bf16 hi + lo pair, on f32 inputs as
    3xTF32 products, the plain versions over the whole row
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h", [(8 * 4, 2), (2 * 2, 8)], ids=["tp4_heads", "pp2_stages"])
def test_torch_flash_kernels_at_shard_shapes_match_plain_on_card(cuda_device, b, h, dtype):
    """K4 (normalized), K5 and K6 (input-dtype gradients, as
    flash_attention's backward runs them) at the shapes the LM's tensor
    and pipeline schemes give them: a tp 4 step of LM-1 folds its shards'
    heads into the batch ([8 x 4, 1024, 2, 64]), a pp 2 tick its stages'
    microbatch rows ([2 x 2, 1024, 8, 64]); head splits of one fused
    projection, causal. The bounds of the tests above; two runs give the
    same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(b * h)
    t, d = 1024, 64
    q, k, v = torch.randn((b, t, 3, h, d), generator=g, device=cuda_device).to(dtype).unbind(2)
    do = torch.randn((b, t, h, d), generator=g, device=cuda_device).to(dtype)
    scale = d ** -0.5
    o, lse = flash_fwd(q, k, v, causal=True)
    o2, lse2 = flash_fwd(q, k, v, causal=True)
    op, lsep = flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * op.float()).sum(-1).transpose(1, 2)
    got = flash_bwd(q, k, v, do, lsep, delta, True, scale)
    again = flash_bwd(q, k, v, do, lsep, delta, True, scale)
    want = flash_bwd_plain(q, k, v, do, lsep, delta, True, scale)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "K4 changed between two runs"
    if dtype == torch.bfloat16:
        torch.testing.assert_close(o.float(), op.float(), atol=2e-2, rtol=1e-2)
        torch.testing.assert_close(lse, lsep, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(o, op, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, lsep, atol=1e-5, rtol=0)
    tol = 1e-2 if dtype == torch.bfloat16 else 5e-5
    for name, g_, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g_.dtype == dtype and g_.shape == (b, t, h, d), name
        assert torch.equal(g_, g2), f"{name} changed between two runs"
        _assert_near(g_, w, tol)


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
    prefill and K1's KV entry once per block per prefill and per decode
    step (nothing else of K1)."""
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
        k4, k1 = flash_fwd.launches, quantize_kv_write.launches
        others = (quantize_rows.launches, quantize_rows_many.launches,
                  quantize_rows_scaled_many.launches)
        p0, d0 = engine.n_prefills, engine.n_decode_steps
        outs[str(dev)] = [c.tokens for c in
                          engine.decode_requests([dataclasses.replace(r) for r in reqs])]
        if dev != "cpu":
            prefills = engine.n_prefills - p0
            steps = engine.n_decode_steps - d0
            assert prefills == 3
            assert flash_fwd.launches - k4 == cfg.depth * prefills
            assert quantize_kv_write.launches - k1 == (
                cfg.depth * (prefills + steps) if int8 else 0)
            assert (quantize_rows.launches, quantize_rows_many.launches,
                    quantize_rows_scaled_many.launches) == others
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_torch_engine_rollover_on_card_matches_cpu_engine(cuda_device, int8, tmp_path):
    """Hot rollover on the card: a request in flight when step 2 lands
    finishes on step 1's weights, the queued one runs on step 2's, and
    the tokens are the CPU engine's. The engine built from a checkpoint
    prefills with naive attention (no K4, as JAX's), and an int8 pool
    launches K1's KV entry once a block a prefill and a decode step."""
    from ps_pytorch_tpu_torch.checkpoint import save_checkpoint
    from ps_pytorch_tpu_torch.models.convert import params_to_numpy

    cfg = TransformerConfig(vocab_size=97, dim=128, depth=2, heads=2, max_seq_len=64)
    model = {"kind": "dense", "vocab_size": 97, "dim": 128, "depth": 2, "heads": 2,
             "mlp_ratio": cfg.mlp_ratio, "max_seq_len": 64}
    serve = ServeConfig(slots=3, max_len=48, max_prompt_len=12, kv_int8=int8)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, 97, p).astype(np.int32),
                    max_new_tokens=n) for i, (p, n) in enumerate([(5, 20), (6, 7)])]
    def write(d, step):  # step s holds the weights of seed s - 1
        p = init_transformer(cfg, torch.Generator().manual_seed(step - 1), device="cpu")
        save_checkpoint({"params": params_to_numpy(p), "step": step, "model": model,
                         "data": {"seed": 1, "seq_len": 32}}, str(d), step)

    outs = {}
    for dev in ("cpu", cuda_device):
        d = tmp_path / str(dev)
        write(d, 1)
        engine = ServingEngine.from_checkpoint(str(d), serve, step=1, device=dev)
        engine.warmup()
        k4, k1 = flash_fwd.launches, quantize_kv_write.launches
        p0, d0 = engine.n_prefills, engine.n_decode_steps
        engine.submit(dataclasses.replace(reqs[0]))
        for _ in range(3):
            engine.tick()
        write(d, 2)
        assert engine.poll_rollover() == 2
        engine.submit(dataclasses.replace(reqs[1]))
        done = {}
        while not engine.scheduler.idle or engine.draining:
            for c in engine.tick():
                done[c.rid] = c
        outs[str(dev)] = [(c.weights_step, c.tokens) for _, c in sorted(done.items())]
        assert [c.weights_step for _, c in sorted(done.items())] == [1, 2]
        if dev != "cpu":
            prefills = engine.n_prefills - p0
            steps = engine.n_decode_steps - d0
            assert prefills == 2 and flash_fwd.launches == k4
            assert quantize_kv_write.launches - k1 == (
                cfg.depth * (prefills + steps) if int8 else 0)
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [
    (8, 11173968),  # the ResNet18 fused stacked payload (every row aligned)
    (8, 1396746),   # one region of it (s % 16 == 10: rows at four offsets)
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


def _int8_view(dev, n, s, offset, seed):
    """A contiguous int8 [n, s] at storage offset ``offset`` of a buffer
    with guard bytes on both sides, and the buffer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randint(-128, 128, (n * s + offset + 16,), generator=g, device=dev,
                        dtype=torch.int32).to(torch.int8)
    recv = buf[offset:offset + n * s].view(n, s)
    if s:
        recv[:, 0] = 127  # a full-scale column
    return recv, buf


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 8, 15])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 258])
def test_torch_accumulate_rescale_kernel_every_pitch_and_offset_on_card(cuda_device, n, offset):
    """K3 at every pitch class s % 16, at small s and past several
    blocks, with recv's base at storage offsets 0, 1, 8 and 15 (rows at
    every misalignment, read as aligned 16-byte words): bit for bit the
    plain version, one launch a call, and the buffer around recv as it
    was (the kernel writes only ``out``)."""
    for s in [j for j in range(1, 16)] + [16 * k + j for k in (1, 263) for j in range(16)]:
        recv, buf = _int8_view(cuda_device, n, s, offset, n * 1000 + s + offset)
        before_buf = buf.clone()
        for d in (float(n), 5.0, torch.tensor(3.0, device=cuda_device)):
            launches = accumulate_rescale_int8.launches
            out = accumulate_rescale_int8(recv, d)
            torch.cuda.synchronize()
            assert accumulate_rescale_int8.launches == launches + 1
            assert tuple(out.shape) == (s,) and torch.equal(out, accumulate_rescale_plain(recv, d))
        assert torch.equal(buf, before_buf)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,s", [(4, 22347928), (2, 11173968), (4, 11173964), (2, 5586984)],
                         ids=["grid_ici", "grid_dcn", "process_ici", "process_dcn"])
def test_torch_accumulate_rescale_kernel_grid_hop_shapes_on_card(cuda_device, n, s, offset):
    """K3 at the 2 x 4 grid's hop shapes (the stacked grid's ICI and DCN
    hops, one process's), at an aligned base and one byte off, bit for
    bit the plain version at the hop's divisor."""
    recv, _ = _int8_view(cuda_device, n, s, offset, s + offset)
    for d in (float(n), torch.tensor(float(n), device=cuda_device)):
        out = accumulate_rescale_int8(recv, d)
        assert torch.equal(out, accumulate_rescale_plain(recv, d))


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


@pytest.mark.cuda
def test_torch_accumulate_rescale_kernel_changing_device_divisor_on_card(cuda_device):
    """K3 with the adaptive count's divisor: one device tensor refilled on
    the card between launches (no host copy), each launch bit-exact
    against the plain version at that divisor."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    recv = torch.randint(-127, 128, (8, 1 << 16), generator=g, device=cuda_device,
                         dtype=torch.int32).to(torch.int8)
    k = torch.empty((), dtype=torch.float32, device=cuda_device)
    before = accumulate_rescale_int8.launches
    outs = []
    for count in (8, 7, 3, 5, 1, 8):
        k.fill_(count)
        outs.append((count, accumulate_rescale_int8(recv, k)))
    torch.cuda.synchronize()
    assert accumulate_rescale_int8.launches == before + 6
    for count, out in outs:
        assert torch.equal(out, accumulate_rescale_plain(recv, float(count)))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [2, 3])
def test_torch_prefetch_pinned_batches_equal_the_host_on_card(cuda_device, size):
    """The pinned copy-stream prefetch: every batch arrives whole and in
    order while the consumer's stream is kept busy (so staging buffers
    are refilled and device blocks freed while earlier work is queued)."""
    from ps_pytorch_tpu_torch.data import BatchIterator, make_synthetic, prefetch_to_device

    d = make_synthetic("Cifar10", 2048, 4, seed=5)
    host = list(BatchIterator(d.train_images, d.train_labels, 256, seed=2).epoch())
    busy = torch.randn(2048, 2048, device=cuda_device)
    sums = []
    for batch in prefetch_to_device(iter(host), size=size, device=cuda_device):
        assert batch["image"].is_cuda and batch["label"].dtype == torch.int32
        for _ in range(4):
            busy = busy @ busy / 2048.0  # queue work ahead of the batch's use
        sums.append((batch["image"].to(torch.int64).sum(), batch["label"].to(torch.int64).sum(),
                     batch["image"].clone(), batch["label"].clone()))
    torch.cuda.synchronize()
    assert len(sums) == len(host) == 8
    for (si, sl, img, lab), b in zip(sums, host):
        assert int(si) == int(b["image"].astype(np.int64).sum())
        assert int(sl) == int(b["label"].astype(np.int64).sum())
        assert torch.equal(img.cpu(), torch.from_numpy(b["image"]))
        assert torch.equal(lab.cpu(), torch.from_numpy(b["label"]))


@pytest.mark.cuda
@pytest.mark.parametrize("compress,domain,block", [
    ("int8", "dequant", 0), ("int8", "homomorphic", 128),
    ("int8_2round", "dequant", 128), ("int8_2round", "homomorphic", 0),
])
def test_torch_adaptive_wires_on_card_match_cpu(cuda_device, compress, domain, block):
    """The adaptive routes on the card equal the CPU's bit for bit: a
    device count with mixed lattice peaks, and (dequant wires) stochastic
    rounding with the same injected draws. No K1 / K2 call on a lattice
    or stochastic round 1."""
    perm = torch.tensor([3, 0, 6, 1, 5, 2, 7, 4])
    g = _grads("cpu")
    pieces = len(collectives.piece_stream(g, 4096, align=block or 1)[1])
    peaks = torch.tensor([0.0, 7.0, 127.0, 127.0 if compress == "int8_2round" else 4095.0]
                         * pieces)[:pieces]
    draws_cache = {}

    def draws(pid, rnd, shape):
        key = (pid, rnd, shape)
        if key not in draws_cache:
            gen = torch.Generator().manual_seed(pid * 2 + rnd)
            draws_cache[key] = torch.rand((8,) + shape, generator=gen)
        return draws_cache[key]

    runs = [dict(num_aggregate=torch.tensor(6, dtype=torch.int32), bucket_peaks=peaks,
                 lattice_hi_peak=127 if compress == "int8_2round" else 4095)]
    if domain == "dequant":
        runs.append(dict(num_aggregate=5, quant_rounding="stochastic", quant_draws=draws))
    for extra in runs:
        kw = dict(perm=perm, compress=compress, quant_block_size=block, bucket_bytes=4096,
                  wire_domain=domain, flat_output=True, return_contribution=True, **extra)
        if compress == "int8_2round":
            kw.pop("lattice_hi_peak", None)
        card_kw = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) and k != "perm" else v)
                   for k, v in kw.items()}
        k2, k1 = tq.quantize_tensors.launches, tq.quantize_rows_scaled_many.launches
        agg_gpu, c_gpu = collectives.aggregate_gradients(
            tree_map(lambda t: t.to(cuda_device), g), WorkerAxis(8), 8, **card_kw)
        torch.cuda.synchronize()
        if compress == "int8":
            assert (tq.quantize_tensors.launches, tq.quantize_rows_scaled_many.launches) == (
                k2, k1)
        agg_cpu, c_cpu = collectives.aggregate_gradients(g, WorkerAxis(8), 8, **kw)
        assert torch.equal(agg_gpu.cpu(), agg_cpu)
        for a, b in zip(tree_leaves(c_gpu), tree_leaves(c_cpu)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(compress="int8", error_feedback=True, bucket_bytes=65536),
    dict(compress="int8_2round", wire_domain="homomorphic", error_feedback=True,
         bucket_bytes=65536),
    dict(opt_placement="sharded", compress="int8", quant_block_size=128, error_feedback=True,
         bucket_bytes=65536),
], ids=["int8_ef", "2round_homomorphic_ef", "zero1_block128_ef"])
def test_torch_pipelined_step_equals_serial_on_card(cuda_device, kw):
    """The pipelined step on the card (each bucket's wire launched from the
    backward's hooks on a side stream, its update waiting on the bucket's
    event) gives the serial step's params and EF residuals bit for bit
    (cuDNN deterministic), with one K2 / K1 call a bucket where the serial
    wire makes one a step."""
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.ps import (
        PSConfig,
        StepDraws,
        init_ps_state,
        make_ps_train_step,
        state_plan,
    )

    model = build_model("LeNet")
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 64, 28, 28, 1), generator=g).to(torch.uint8)
    labels = torch.randint(0, 10, (2, 64), generator=g)
    out, calls = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for overlap in ("serial", "pipelined"):
            cfg = PSConfig(num_workers=8, num_aggregate=5, overlap=overlap, **kw)
            tx = build_optimizer("sgd", 0.05, momentum=0.9)
            st = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(1),
                               device=cuda_device)
            step = make_ps_train_step(model, tx, cfg, device=cuda_device)
            k2, k1 = tq.quantize_tensors.launches, tq.quantize_rows_scaled_many.launches
            for i in range(2):
                st, _ = step(st, {"image": images[i].to(cuda_device),
                                  "label": labels[i].to(cuda_device)},
                             StepDraws(perm=torch.tensor([3, 0, 6, 1, 5, 2, 7, 4])))
            torch.cuda.synchronize()
            calls[overlap] = (tq.quantize_tensors.launches - k2
                              + tq.quantize_rows_scaled_many.launches - k1)
            out[overlap] = [st.params.flat] + tree_leaves(st.comm_state)
            n_buckets = state_plan(cfg, st.params.layout.total).n_buckets
    finally:
        torch.backends.cudnn.deterministic = False
    for a, b in zip(out["serial"], out["pipelined"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert n_buckets > 1 and calls["pipelined"] == 2 * n_buckets
    assert calls["serial"] == (2 * n_buckets if kw.get("opt_placement") else 2)


@pytest.mark.cuda
def test_torch_hier_k3_at_both_hops_equals_plain_on_card(cuda_device):
    """The hierarchical homomorphic wire on a 2 x 4 grid: K3 at the ICI
    hop (divisor per_host) and at the DCN hop (divisor hosts), each
    launch held against its plain version on its own input, and the
    aggregate bit for bit the CPU's."""
    from ps_pytorch_tpu_torch.parallel.mesh import make_hybrid_mesh

    seen = []
    real = collectives.accumulate_rescale_int8

    def spy(recv, divisor):
        out = real(recv, divisor)
        seen.append((recv.clone(), float(divisor), out))
        return out

    g = _grads("cpu")
    grid = make_hybrid_mesh(2, 4)
    kw = dict(num_aggregate=5, perm=torch.tensor([3, 0, 6, 1, 5, 2, 7, 4]),
              compress="int8_2round", wire_domain="homomorphic", bucket_bytes=0,
              flat_output=True)
    collectives.accumulate_rescale_int8 = spy
    try:
        before = accumulate_rescale_int8.launches
        agg_gpu = collectives.aggregate_gradients(tree_map(lambda t: t.to(cuda_device), g),
                                                  grid, 8, **kw)
        torch.cuda.synchronize()
        launched = accumulate_rescale_int8.launches - before
    finally:
        collectives.accumulate_rescale_int8 = real
    assert launched == 2 and [d for _, d, _ in seen] == [4.0, 2.0]
    for recv, d, out in seen:
        assert out.is_cuda and torch.equal(out.cpu(), accumulate_rescale_plain(recv.cpu(), d))
    agg_cpu = collectives.aggregate_gradients(g, grid, 8, **kw)
    assert torch.equal(agg_gpu.cpu(), agg_cpu)


def _moe_step_on(device, scheme, params, tokens, cfg, record):
    """One SGD step of a MoE scheme on ``device``; every gate call's
    dispatch (the expert choices and slots) goes to ``record``."""
    from ps_pytorch_tpu_torch import on_device
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel import ep_sp, moe

    real = moe._gate_and_dispatch

    def rec(x2d, wg, capacity, top_k=1):
        out = real(x2d, wg, capacity, top_k)
        record.append(out[0].cpu())
        return out

    tx = build_optimizer("sgd", 0.1, momentum=0.9)
    p = on_device(params, torch.device(device))
    if scheme == "moe":
        mesh = moe.make_ep_mesh(4)
        step = moe.make_moe_train_step(
            cfg, moe.MoEConfig(num_experts=8, capacity_factor=1.0, top_k=2), tx, mesh)
        tok = moe.shard_moe_batch(tokens.to(device), mesh)
    else:
        mesh = ep_sp.make_mesh_ep_sp(2, 2)
        step = ep_sp.make_ep_sp_train_step(cfg, moe.MoEConfig(num_experts=8), tx, mesh)
        tok = ep_sp.shard_tokens_ep_sp(tokens.to(device), mesh)
    moe._gate_and_dispatch = rec
    try:
        p2, _, task, aux = step(p, tx.init(p), tok)
    finally:
        moe._gate_and_dispatch = real
    return [x.detach().cpu() for x in tree_leaves(p2)], float(task), float(aux)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["moe", "ep_sp"])
def test_torch_moe_step_on_card_matches_cpu(cuda_device, scheme):
    """One f32 step (TF32 off) of moe 4 shards top-2 at capacity factor 1.0
    (tokens drop) and of ep_sp 2 x 2 on the flash ring (K4's partial
    triple, K5, K6) against the same step on the CPU (plain versions):
    every gate call's dispatch equal, the loss and aux within 1e-5
    relative, the params within 2e-5 + 2e-4 |p| (chip_smoke phase 36's
    rule)."""
    from ps_pytorch_tpu_torch.cli.train_lm import make_synthetic_tokens
    from ps_pytorch_tpu_torch.parallel import moe

    cfg = TransformerConfig(vocab_size=256, dim=128, depth=2, heads=4, max_seq_len=128,
                            attention_impl="flash", remat=True)
    params = moe.init_moe_params(cfg, moe.MoEConfig(num_experts=8),
                                 torch.Generator().manual_seed(5), device="cpu")
    params = moe.shard_params_moe(cfg, params, moe.make_ep_mesh(4 if scheme == "moe" else 2))
    tokens = torch.from_numpy(make_synthetic_tokens(256, 4, 128, seed=4))
    gates = {"cpu": [], "cuda": []}
    pc, lc, ac = _moe_step_on("cpu", scheme, params, tokens, cfg, gates["cpu"])
    pg, lg, ag = _moe_step_on(cuda_device, scheme, params, tokens, cfg, gates["cuda"])
    assert len(gates["cpu"]) == len(gates["cuda"]) > 0
    for a, b in zip(gates["cuda"], gates["cpu"]):
        assert torch.equal(a, b)  # the same expert choices and slots
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(ag - ac) <= 1e-5 * abs(ac)
    for a, b in zip(pg, pc):
        assert bool(((a - b).abs() <= 2e-5 + 2e-4 * b.abs()).all())


@pytest.mark.cuda
def test_torch_moe_bf16_lm1_width_step_on_card_is_finite(cuda_device):
    """A bf16 moe step at LM-1's width (d512, 8 heads of 64, vocab 2048,
    seq 1024, 8 experts over 4 shards, remat, flash) at depth 2: finite
    loss, aux and params, with the f32 params kept f32."""
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel import moe

    cfg = TransformerConfig(vocab_size=2048, dim=512, depth=2, heads=8, max_seq_len=1024,
                            attention_impl="flash", remat=True, compute_dtype=torch.bfloat16)
    mesh = moe.make_ep_mesh(4)
    mcfg = moe.MoEConfig(num_experts=8)
    tx = build_optimizer("sgd", 0.01, momentum=0.9)
    p, opt = moe.init_moe_state(cfg, mcfg, tx, torch.Generator().manual_seed(1), mesh,
                                device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    tok = torch.randint(0, 2048, (8, 1024), generator=g, device=cuda_device)
    p, opt, task, aux = moe.make_moe_train_step(cfg, mcfg, tx, mesh)(
        p, opt, moe.shard_moe_batch(tok, mesh))
    assert np.isfinite(float(task)) and np.isfinite(float(aux))
    for x in tree_leaves(p):
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ps_int8_replicated", "ps_int8_replicated_bucketed64k_pipelined",
                                  "ps_int8_2round_replicated_bucketed_homomorphic",
                                  "ps_hier_int8_2round_replicated_bucketed_homomorphic",
                                  "serve_decode_int8kv"])
def test_torch_check_records_the_same_step_on_card_as_on_cpu(cuda_device, name):
    """pscheck on the card: a registry spec recorded with device="cuda"
    (the kernels launch) gives the CPU's accounting rows and feeds_params
    flags, no finding, and one kernel node a launch, entry by entry (the
    pipelined spec's buckets go out from autograd's device thread, on a
    side stream)."""
    from ps_pytorch_tpu_torch.check import get_contracts, load_contract, run_checks, trace_spec
    from ps_pytorch_tpu_torch.check.core import DEFAULT_CONTRACT
    import importlib

    # the module: ``ops.flash_attention`` is the function the package re-exports
    fa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
    spec = next(s for s in get_contracts() if s.name == name)
    entries = {n: getattr(tq, n) for n in (
        "quantize_tensors", "quantize_rows_scaled_many", "quantize_rows_many", "quantize_rows",
        "quantize_kv_write", "accumulate_rescale_int8", "tensors_absmax",
        "quantize_tensors_given", "rows_scaled_absmax", "quantize_rows_scaled_given")}
    entries.update({n: getattr(fa, n) for n in ("flash_fwd", "flash_partial", "flash_bwd_dq",
                                                "flash_bwd_dkv")})
    before = {n: fn.launches for n, fn in entries.items()}
    card = trace_spec(spec, device=cuda_device)
    torch.cuda.synchronize()
    grew = {n: fn.launches - before[n] for n, fn in entries.items() if fn.launches != before[n]}
    assert {k.split(":", 1)[1]: v for k, v in card.kernels.items()} == grew
    assert grew, "the spec launched no kernel on the card"
    cpu = trace_spec(spec, device="cpu")
    rows = [(c.kind, c.axes, c.dtype, c.bytes, c.feeds_params) for c in card.collectives]
    assert rows == [(c.kind, c.axes, c.dtype, c.bytes, c.feeds_params) for c in cpu.collectives]
    assert card.kernels == cpu.kernels
    contract = load_contract(DEFAULT_CONTRACT)
    assert run_checks([card], contract, check_stale=False) == []


def _numerics_events(rep):
    """A NumericsReport event for event, scale-root sets by their size."""
    def strip(e):
        d = dict(vars(e))
        for k in ("roots", "scale_roots"):
            if k in d:
                d[k] = len(d[k])
        return d

    return [[strip(e) for e in getattr(rep, f)]
            for f in ("sites", "dequants", "accums", "narrows", "residuals")]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ps_int8_2round_replicated_bucketed_homomorphic",
                                  "serve_decode_int8kv"])
def test_torch_check_numerics_report_on_card_equals_cpu(cuda_device, name):
    """psnumerics on the card: the recorded step's NumericsReport (K2's
    and K3's nodes declare their events on either device) is the CPU's,
    event for event, with no PSC111-114 finding."""
    from ps_pytorch_tpu_torch.check import get_contracts, trace_spec
    from ps_pytorch_tpu_torch.check.rules import (
        psc111_scale_provenance,
        psc112_error_feedback,
        psc113_capacity,
        psc114_downcast,
    )

    spec = next(s for s in get_contracts() if s.name == name)
    card = trace_spec(spec, device=cuda_device)
    cpu = trace_spec(spec, device="cpu")
    assert card.numerics.sites
    assert _numerics_events(card.numerics) == _numerics_events(cpu.numerics)
    assert card.numerics.axis_sizes == cpu.numerics.axis_sizes
    for rule in (psc111_scale_provenance, psc112_error_feedback, psc113_capacity,
                 psc114_downcast):
        assert rule(card) == []


@pytest.mark.cuda
def test_torch_autotune_probe_runs_the_kernels_on_the_card(cuda_device):
    """A measured probe of the homomorphic two-round wire on the card:
    K2 and K3 launch every step, the backend stamp is the card's."""
    from ps_pytorch_tpu_torch.tune.search import Knobs, measure_probe

    kn = Knobs(compress="int8_2round", bucket_bytes=0, wire_domain="homomorphic")
    probe = measure_probe(kn, "LeNet", "MNIST", steps=3, batch=64, device=cuda_device)
    assert probe["platform"] == "gpu"
    assert probe["device_kind"] == torch.cuda.get_device_name(cuda_device)
    assert probe["launches"]["K2"] == 3 and probe["launches"]["K3"] == 3
    assert probe["launches"]["K1"] == 0 and probe["measured_step_s"] > 0


@pytest.mark.cuda
def test_torch_padded_captures_keep_every_device_event(cuda_device):
    """150 back-to-back captures in one process (the whole chip_smoke.py run
    opens 109-111), each over 10 of K2's calls on ResNet18's 62 leaves:
    every capture holds all its device events. The profiler misplaces a
    capture's device events on the host's clock by up to 5.8 ms and drops
    those it places before the capture began; ``padded_profile`` begins
    and ends each capture with host time."""
    from ps_pytorch_tpu_torch.obs import padded_profile

    xs = _resnet18_pieces(cuda_device)
    quantize_tensors(xs)
    torch.cuda.synchronize()
    counts = []
    for _ in range(150):
        with padded_profile() as prof:
            for _ in range(10):
                quantize_tensors(xs)
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    assert counts[0] >= 20 and counts == [counts[0]] * len(counts), counts
