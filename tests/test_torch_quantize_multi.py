"""Port parity: the multi-tensor quantize entries of
ps_pytorch_tpu_torch.ops.quantize (K2 ``quantize_tensors`` and K1's
shared-scale ``quantize_rows_scaled_many``, through the wire's
``quantize_int8_many``) against the JAX package's ``quantize_int8``, and
their pure-Python launch planners.

Bit-exact on the CPU: the same numpy pieces (LeNet's leaves, a ResNet
``(1, 1, 1, 1)``'s leaves, pieces of length 1, lengths that are not a
multiple of 4 or of 128, an all-zero piece), worker-stacked for 8
workers, go through JAX's ``quantize_int8(v, axis_name=WORKER_AXIS)``
inside ``shard_map`` under ``jax.jit`` on the 8-device mesh (one scale
per piece, shared by the workers) and through the port's plain versions
in one call. The kernels themselves are held against the plain versions
on the card in tests/test_torch_kernels_cuda.py.

The planners decide what each launch of a call does, so they are held
here by simulating the kernels' walk: every element (K2) or block-row
(K1) covered exactly once, each piece's units contiguous, and tables cut
where the 4 KB parameter space ends (``MAX_PIECES``).
"""

import bisect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.ops import quantize as jq
from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.models.resnet import BasicBlock, ResNet
from ps_pytorch_tpu_torch.ops import quantize as tq
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from tests.test_torch_one_thread import _one_thread  # noqa: F401


N = 8
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(tq.__file__))), "csrc")


def _leaf_shapes(model):
    params, _ = model.init(torch.Generator().manual_seed(0))
    return [tuple(t.shape) for t in tree_leaves(params)]


def _pieces(seed=0):
    """Worker-stacked f32 pieces: the two models' leaves and the edge
    lengths, magnitudes varying by worker and piece over many binades."""
    shapes = (_leaf_shapes(build_model("LeNet"))
              + _leaf_shapes(ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1)))
              + [(1,), (3,), (129,), (1001,), (4, 33), (256,)])
    rng = np.random.RandomState(seed)
    out = []
    for shape in shapes:
        scale = np.exp(rng.randn(N, *([1] * len(shape))) * 2).astype(np.float32)
        out.append((rng.randn(N, *shape) * scale).astype(np.float32))
    out[-1][:] = 0.0  # an all-zero piece: scale 0, inv 0
    return out


def _shard_map_quantize(mesh, pieces, block_size):
    """JAX's quantize_int8 of every piece with the worker axis, as the
    wire runs it: inside shard_map, under jit."""

    def fn(vs):
        outs = [jq.quantize_int8(v[0], axis_name=WORKER_AXIS, block_size=block_size)
                for v in vs]
        return [q[None] for q, _ in outs], [s[None] for _, s in outs]

    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(WORKER_AXIS),),
                              out_specs=(P(WORKER_AXIS), P(WORKER_AXIS)), check_vma=False))
    qs, ss = f([jnp.asarray(x) for x in pieces])
    return [np.asarray(q) for q in qs], [np.asarray(s) for s in ss]


@pytest.mark.parametrize("block_size", [0, 128, 64])
def test_torch_quantize_many_plain_bit_exact_vs_shard_map(mesh, block_size):
    pieces = _pieces(block_size)
    qj, sj = _shard_map_quantize(mesh, pieces, block_size)
    got = tq.quantize_int8_many([torch.from_numpy(x) for x in pieces], WorkerAxis(N),
                                block_size)
    assert len(got) == len(pieces)
    for x, (q, s, a), qr, sr in zip(pieces, got, qj, sj):
        assert np.all(sr == sr[:1])  # JAX's scales are shared by the workers
        np.testing.assert_array_equal(q.numpy(), qr.reshape(q.shape))
        np.testing.assert_array_equal(s.numpy(), sr[0].reshape(s.shape))
        np.testing.assert_array_equal((a * tq.RECIP_127).numpy(), s.numpy())
        if block_size:
            nb = -(-x[0].size // block_size)
            assert tuple(q.shape) == (N, nb, block_size) and tuple(s.shape) == (nb, 1)
            flat = np.zeros((N, nb * block_size), np.float32)
            flat[:, :x[0].size] = x.reshape(N, -1)
            want = np.abs(flat.reshape(N, nb, block_size)).max(axis=(0, 2)).reshape(nb, 1)
        else:
            assert tuple(q.shape) == x.shape and s.shape == ()
            want = np.abs(x).max()
        np.testing.assert_array_equal(a.numpy(), want)
    q0, s0, _ = got[-1]
    assert not q0.any() and not s0.any()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def split_case(request):
    """``_pieces`` with NaN block rows (the ragged (129,) piece NaN in
    every worker; block row 2 of every worker of the (1001,) piece) as
    torch tensors of the param's dtype, and JAX's block-128 quantize of
    them with the worker axis."""
    dtype = request.param
    pieces = _pieces(7)
    pieces[-4][:] = np.nan  # (129,): both block rows, every worker
    pieces[-3][:, 256:384] = np.nan  # (1001,): block row 2 of every worker
    pieces = [x for x in pieces if x[0].size <= 1 << 16]  # LeNet's leaves and the edges
    ts = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in pieces]
    mesh = jax.make_mesh((N,), (WORKER_AXIS,))
    wide = [jnp.asarray(t.float().numpy(), dtype=getattr(jnp, dtype)) for t in ts]
    return ts, _shard_map_quantize(mesh, wide, 128)


@pytest.mark.parametrize("processes", [1, 2, 4, 8])
def test_torch_split_halves_plain_bit_exact_vs_shard_map(split_case, processes):
    """K1's split route as ``processes`` processes run it, in its plain
    versions: each process's ``rows_scaled_absmax_plain`` over its
    workers, the max over the stacked processes' absmax bits between the
    halves (``ProcessWorkerAxis.absmax_max``'s MAX over int32 bits, NaN
    kept), then each process's ``quantize_rows_scaled_given_plain``:
    every payload, and the shared scale of every finite block row, equal
    JAX's ``quantize_int8(block_size=128, axis_name=...)`` under jit on
    the 8-device mesh, in f32 and bf16, ragged lengths among them. A
    block row that is NaN in every worker gets payload 0 in both; its
    scale is NaN in the port (F1) and not finite in JAX, whose pmax on
    XLA:CPU drops NaN (-inf when every worker is NaN; ROADMAP "Reference
    caveats")."""
    ts, (qj, sj) = split_case
    per = N // processes
    parts = [[t[p * per:(p + 1) * per] for t in ts] for p in range(processes)]
    local = torch.stack([tq.rows_scaled_absmax_plain(xs, 128) for xs in parts])
    absmax = local.abs().view(torch.int32).amax(0).view(torch.float32)
    outs = [tq.quantize_rows_scaled_given_plain(xs, 128, absmax) for xs in parts]
    nan_rows, at = 0, 0
    for i, (qr, sr) in enumerate(zip(qj, sj)):
        q = torch.cat([o[i][0] for o in outs])
        scale, am = outs[0][i][1], outs[0][i][2]
        assert all(torch.equal(o[i][1].view(torch.int32), scale.view(torch.int32))
                   for o in outs)
        assert torch.equal(am.reshape(-1).view(torch.int32),
                           absmax[at:at + am.numel()].view(torch.int32))
        at += am.numel()
        np.testing.assert_array_equal(q.numpy(), qr.reshape(q.shape))
        bad = torch.isnan(scale.reshape(-1)).numpy()
        want = sr[0].reshape(-1)
        np.testing.assert_array_equal(scale.reshape(-1).numpy()[~bad], want[~bad])
        assert not np.isfinite(want[bad]).any()
        nan_rows += int(bad.sum())
    assert nan_rows == 2 + 1 and at == absmax.numel()


@pytest.mark.parametrize("block_size", [0, 128])
def test_torch_quantize_many_is_each_piece_quantized_alone(block_size):
    """One call over the list == quantize_int8 of each piece (the
    one-piece call of the same entry), with a piece of length 0 among
    them; no kernel launch on the CPU."""
    pieces = [torch.from_numpy(x) for x in _pieces(3)[-8:]]
    pieces.insert(2, torch.zeros((N, 0)))
    counts = (tq.quantize_tensors.launches, tq.quantize_rows_scaled_many.launches)
    many = tq.quantize_int8_many(pieces, WorkerAxis(N), block_size)
    for x, (q, s, a) in zip(pieces, many):
        q1, s1, a1 = tq.quantize_int8(x, axis_name=WorkerAxis(N), block_size=block_size,
                                      return_absmax=True)
        assert torch.equal(q, q1) and torch.equal(s, s1) and torch.equal(a, a1)
    q, s, a = many[2]
    if block_size:
        assert tuple(q.shape) == (N, 0, block_size) and tuple(s.shape) == (0, 1)
    else:
        assert tuple(q.shape) == (N, 0) and float(s) == 0.0 and float(a) == 0.0
    assert (tq.quantize_tensors.launches, tq.quantize_rows_scaled_many.launches) == counts


def test_torch_quantize_many_bf16_pieces_widen_exactly():
    """bf16 pieces quantize as their exact f32 widening does."""
    pieces = [torch.from_numpy(x).to(torch.bfloat16) for x in _pieces(4)[:6]]
    for block_size in (0, 128):
        got = tq.quantize_int8_many(pieces, WorkerAxis(N), block_size)
        want = tq.quantize_int8_many([p.float() for p in pieces], WorkerAxis(N), block_size)
        for (q, s, a), (qw, sw, aw) in zip(got, want):
            assert torch.equal(q, qw) and torch.equal(s, sw) and torch.equal(a, aw)


def test_torch_quantize_many_refuses_mixed_workers_and_devices():
    with pytest.raises(ValueError, match="worker-stacked"):
        tq.quantize_rows_scaled_many([torch.zeros((8, 4)), torch.zeros((4, 4))], 128)
    with pytest.raises(ValueError, match=r"\[8, \.\.\.\]"):
        tq.quantize_int8_many([torch.zeros((4, 4))], WorkerAxis(8), 128)
    with pytest.raises(TypeError, match="WorkerAxis"):
        tq.quantize_int8_many([torch.zeros((8, 4))], WORKER_AXIS, 0)


# ----------------------------------------------------------- the planners

def _walk_k2(tables, lengths, chunk):
    """What the K2 kernels do with the tables: each unit c of a table
    finds its piece by the last first-unit <= c (csrc piece_of) and
    covers elements [(c - first) * chunk, min(+chunk, n)) of it."""
    cover = [np.zeros(n, np.int64) for n in lengths]
    for t in tables:
        assert list(t.first) == sorted(t.first) and t.first[0] == 0
        for c in range(t.first[-1]):
            j = bisect.bisect_right(t.first, c) - 1
            i = t.pieces[j]
            e0 = (c - t.first[j]) * chunk
            cover[i][e0:min(e0 + chunk, lengths[i])] += 1
    return cover


@pytest.mark.parametrize("max_pieces,chunk", [(16, 16), (64, 16), (7, 5), (64, 8192)])
def test_torch_k2_plan_covers_every_element_once(max_pieces, chunk):
    rng = np.random.RandomState(max_pieces + chunk)
    lengths = [int(v) for v in rng.randint(0, 300, size=150)] + [0, 1, 17, 4096]
    tables = tq.plan_tensor_tables(lengths, max_pieces=max_pieces, chunk=chunk)
    cover = _walk_k2(tables, lengths, chunk)
    assert all(np.all(c == 1) for c in cover)
    placed = [i for t in tables for i in t.pieces]
    assert placed == [i for i, n in enumerate(lengths) if n]  # in order, once, none empty
    live = len(placed)
    assert [len(t.pieces) for t in tables] == \
        [max_pieces] * (live // max_pieces) + [live % max_pieces] * (live % max_pieces > 0)
    for t in tables:
        assert list(t.first[1:]) == list(np.cumsum([-(-lengths[i] // chunk) for i in t.pieces]))


def test_torch_k2_plan_cuts_tables_where_the_parameter_space_ends():
    """300 pieces (ResNet18's 62 leaves fit one table) cut into tables of
    MAX_PIECES, in order."""
    tables = tq.plan_tensor_tables([8 * (1000 + i) for i in range(300)])
    assert [len(t.pieces) for t in tables] == [64, 64, 64, 64, 44]
    assert [i for t in tables for i in t.pieces] == list(range(300))
    assert tq.MAX_PIECES == 64


def test_torch_k2_plan_resnet18_is_one_table():
    """ResNet18's 62 stacked leaves: one table, so one launch of each of
    K2's two kernels a step; every leaf ceil(n / K2_CHUNK) chunks."""
    lengths = [N * int(np.prod(s)) for s in _leaf_shapes(build_model("ResNet18"))]
    assert len(lengths) == 62
    tables = tq.plan_tensor_tables(lengths)
    assert len(tables) == 1 and tables[0].pieces == tuple(range(62))
    units = {i: b - a for t in tables for i, a, b in zip(t.pieces, t.first, t.first[1:])}
    assert units == {i: -(-n // tq.K2_CHUNK) for i, n in enumerate(lengths)}
    assert units[int(np.argmax(lengths))] == 2304  # the [8, 3, 3, 512, 512] leaf


def test_torch_k1_plan_covers_every_block_row_once():
    rng = np.random.RandomState(5)
    nbs = [int(v) for v in rng.randint(0, 40, size=200)] + [0, 1]
    tables = tq.plan_rows_tables(nbs)
    live = len(nbs) - nbs.count(0)
    assert [len(t.pieces) for t in tables] == [64] * (live // 64) + [live % 64] * (live % 64 > 0)
    cover = [np.zeros(nb, np.int64) for nb in nbs]
    for t in tables:
        for u in range(t.first[-1]):
            j = bisect.bisect_right(t.first, u) - 1
            cover[t.pieces[j]][u - t.first[j]] += 1
    assert all(np.all(c == 1) for c in cover)
    assert sorted(i for t in tables for i in t.pieces) == [i for i, nb in enumerate(nbs) if nb]


@pytest.mark.parametrize("source,struct,layout", [
    ("quantize_tensor.cu", "TensorTable", "_K2_TABLE"),
    ("quantize_rows.cu", "RowsTable", "_K1_TABLE"),
])
def test_torch_descriptor_table_layout_matches_the_source(source, struct, layout):
    """The words the host fills are the struct's fields in order: four
    scalar words, then arrays of kMaxPieces (+ 1) words."""
    with open(os.path.join(CSRC, source)) as f:
        body = re.search(r"struct %s \{(.*?)\n\};" % struct, f.read(), re.S).group(1)
    fields = re.findall(r"long long (\w+)(\[ps::kMaxPieces( \+ 1)?\])?;", body)
    lay = getattr(tq, layout)
    header = [name for name, arr, _ in fields if not arr]
    assert fields[:len(header)] == [(name, "", "") for name in header]
    assert len(header) == lay.header
    sizes = [tq.MAX_PIECES + (1 if extra else 0) for _, _, extra in fields[lay.header:]]
    starts = list(lay.offset.values())
    assert starts[0] == lay.header and np.diff(starts + [lay.words]).tolist() == sizes
    with open(os.path.join(CSRC, "common.cuh")) as f:
        assert re.search(r"kMaxPieces = (\d+);", f.read()).group(1) == str(tq.MAX_PIECES)
