"""Port parity: K1's fused entries as their callers use them, against the
JAX package on the CPU (the plain versions; the kernels' own checks are in
tests/test_torch_kernels_cuda.py).

- The serving pool's int8 write (``quantize_kv_write`` behind
  ``serve.kv.write_slot`` / ``write_token``) against JAX's jitted
  ``write_slot`` / ``write_token``: bf16 and f32 K/V, head_dim 32 and 64,
  a ragged prompt length, strided head-split views, bit-exact payloads
  and scales, and a sentinel-filled pool unchanged outside the written
  rows. Decode positions ``max_len - 1`` and ``-1`` are written,
  ``max_len`` and ``-(max_len + 1)`` dropped, as JAX's scatter does.
- The two-round wire's round 2 at block 128 over 65 pieces (two
  descriptor tables) against JAX's ``shard_map`` wire, in one
  ``quantize_rows_many`` call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu.parallel import collectives as jc
from ps_pytorch_tpu.serve import kv as jkv
from ps_pytorch_tpu_torch.ops import quantize as tq
from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from ps_pytorch_tpu_torch.serve import kv as tkv

SLOTS, MAX_LEN, HEADS, DEPTH = 4, 16, 2, 2
Q_SENTINEL, S_SENTINEL = 77, -3.5


def _pools(hd):
    """The same sentinel-filled int8 pool for JAX and for the port."""
    shape = (DEPTH, SLOTS, MAX_LEN, HEADS, hd)
    sshape = shape[:-1] + (1,)
    jpool = {"k_q": jnp.full(shape, Q_SENTINEL, jnp.int8),
             "k_s": jnp.full(sshape, S_SENTINEL, jnp.float32),
             "v_q": jnp.full(shape, -Q_SENTINEL, jnp.int8),
             "v_s": jnp.full(sshape, -S_SENTINEL, jnp.float32)}
    return jpool, {name: torch.from_numpy(np.array(a)) for name, a in jpool.items()}


def _kv(rows, hd, dtype, seed):
    """K and V as the engine hands them over: head-split views of one
    [rows, 3 * H * hd] projection, with an all-zero head vector."""
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(rows, 3 * HEADS * hd) * np.exp(rng.randn(rows, 1))).astype(np.float32)
    qkv[0, HEADS * hd:HEADS * hd + hd] = 0.0  # K's first head vector: scale 0
    t = torch.from_numpy(qkv).to(dtype)
    k, v = (a.reshape(rows, HEADS, hd) for a in t.split(HEADS * hd, dim=1)[1:])
    j = jnp.asarray(qkv).astype({torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])
    jk, jv = (a.reshape(rows, HEADS, hd) for a in jnp.split(j, 3, axis=1)[1:])
    return (k, v), (jk, jv)


def _same(tpool, jpool):
    for name in jpool:
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]), err_msg=name)


_JWRITE_SLOT = jax.jit(jkv.write_slot, static_argnums=1)
_JWRITE_TOKEN = jax.jit(jkv.write_token, static_argnums=1)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_kv_pool_write_matches_jax(dtype, hd):
    """A ragged prefill into slot 2 of block 1, then two decode ticks:
    every position in range written, every other row still the
    sentinel, bit for bit JAX's pool."""
    jpool, tpool = _pools(hd)
    (k, v), (jk, jv) = _kv(7, hd, dtype, seed=hd)
    jpool = _JWRITE_SLOT(jpool, 1, jnp.int32(2), jk, jv)
    tkv.write_slot(tpool, 1, 2, k, v)
    _same(tpool, jpool)
    assert (tpool["k_q"][0] == Q_SENTINEL).all() and (tpool["k_s"][1, 2, 7:] == S_SENTINEL).all()
    for tick, pos in enumerate(([7, MAX_LEN - 1, 0, 3], [8, MAX_LEN, -1, -(MAX_LEN + 1)])):
        (k, v), (jk, jv) = _kv(SLOTS, hd, dtype, seed=10 * hd + tick)
        p = np.asarray(pos, np.int32)
        jpool = _JWRITE_TOKEN(jpool, 0, jnp.asarray(p), jk, jv)
        tkv.write_token(tpool, 0, torch.from_numpy(p), k, v)
        _same(tpool, jpool)
    # the dropped positions left their slots' other rows alone; -1 went
    # to the last position
    assert (tpool["k_q"][0, 1, :MAX_LEN - 1] == Q_SENTINEL).all()
    assert (tpool["v_q"][0, 3, 4:] == -Q_SENTINEL).all()
    assert not (tpool["v_s"][0, 2, MAX_LEN - 1] == -S_SENTINEL).any()


def test_torch_kv_write_plain_drops_out_of_range_positions():
    """The plain version on its own: an index write would raise on
    ``max_len``; the KV entry drops it, and wraps a negative position
    once."""
    hd = 32
    _, pool = _pools(hd)
    views = [pool[n][0] for n in ("k_q", "k_s", "v_q", "v_s")]
    before = [t.clone() for t in views]
    (k, v), _ = _kv(SLOTS, hd, torch.float32, seed=3)
    pos = torch.tensor([MAX_LEN, -1, MAX_LEN + 5, -(MAX_LEN + 1)])
    tq.quantize_kv_write_plain(k, v, *views, pos=pos)
    q, s = tq.quantize_rows_plain(k[1])
    assert torch.equal(views[0][1, MAX_LEN - 1], q) and torch.equal(views[1][1, MAX_LEN - 1], s)
    changed = [(a != b).reshape(SLOTS, MAX_LEN, -1).any(-1) for a, b in zip(views, before)]
    for c in changed:
        assert c.nonzero().tolist() == [[1, MAX_LEN - 1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_kv_compute_dtype_pool_write_token_matches_jax(dtype):
    """The compute-dtype pool's decode write against JAX's jitted
    write_token: positions ``max_len`` and ``-(max_len + 1)`` are dropped
    (an index write would raise on them), ``-1`` wraps to the last
    position, and the pool is bit for bit JAX's."""
    hd = 32
    shape = (DEPTH, SLOTS, MAX_LEN, HEADS, hd)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jpool = {"k": jnp.full(shape, 5.0, jdt), "v": jnp.full(shape, -5.0, jdt)}
    tpool = {"k": torch.full(shape, 5.0, dtype=dtype), "v": torch.full(shape, -5.0, dtype=dtype)}
    for tick, pos in enumerate(([3, MAX_LEN, 0, -1], [MAX_LEN - 1, 2, -(MAX_LEN + 1), 7])):
        (k, v), (jk, jv) = _kv(SLOTS, hd, dtype, seed=50 + tick)
        p = np.asarray(pos, np.int32)
        jpool = _JWRITE_TOKEN(jpool, 1, jnp.asarray(p), jk, jv)
        tkv.write_token(tpool, 1, torch.from_numpy(p), k, v)
        for name in ("k", "v"):
            np.testing.assert_array_equal(tpool[name].float().numpy(),
                                          np.asarray(jpool[name].astype(jnp.float32)),
                                          err_msg=name)
    # slot 1 dropped MAX_LEN, then wrote 2; slot 2 wrote 0, then dropped
    assert (tpool["k"][1, 1, 3:] == 5.0).all() and not (tpool["k"][1, 1, 2] == 5.0).all()
    assert (tpool["v"][1, 2, 1:] == -5.0).all()


@pytest.mark.parametrize("kwargs,match", [
    (dict(), "a slot"),
    (dict(slot=0, pos=torch.zeros(SLOTS, dtype=torch.int32)), "a slot"),
    (dict(slot=SLOTS), "slot"),
    (dict(pos=torch.zeros(SLOTS + 1, dtype=torch.int32)), "positions"),
    (dict(pos=torch.zeros(SLOTS)), "positions"),
])
def test_torch_kv_write_refuses_bad_operands(kwargs, match):
    _, pool = _pools(32)
    views = [pool[n][0] for n in ("k_q", "k_s", "v_q", "v_s")]
    (k, v), _ = _kv(SLOTS, 32, torch.float32, seed=4)
    with pytest.raises(ValueError, match=match):
        tq.quantize_kv_write(k, v, *views, **kwargs)


def test_torch_kv_write_on_cpu_launches_nothing():
    _, pool = _pools(32)
    (k, v), _ = _kv(5, 32, torch.bfloat16, seed=5)
    before = tq.quantize_kv_write.launches
    tkv.write_slot(pool, 0, 1, k, v)
    assert tq.quantize_kv_write.launches == before


@pytest.mark.parametrize("hd,elt,offsets,want", [
    (64, 2, [0, 3072, 128], (True, 8)),     # the serving shape: 4 rows a warp
    (32, 2, [0], (True, 4)),
    (64, 4, [0], (True, 16)),
    (128, 4, [0], (True, 32)),
    (128, 2, [0], (True, 16)),
    (96, 2, [0], (False, 32)),              # 12 lanes: not a power of two
    (256, 4, [0], (False, 32)),             # 64 lanes: more than a warp
    (64, 2, [0, 2], (False, 32)),           # a view 2 bytes past a boundary
    (33, 4, [0], (False, 32)),
])
def test_torch_kv_lanes_picks_the_vector_path(hd, elt, offsets, want):
    assert tq.row_lanes(hd, elt, offsets) == want


# ------------------------------------------------- the wire's round 2

N = 8
KEY = jax.random.key(7)


def _many_leaves(count=65, seed=0):
    """``count`` worker-stacked leaves of assorted lengths (block-128
    ragged and not), magnitudes varying by worker and leaf."""
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(count):
        n = int(rng.choice([1, 5, 127, 128, 300, 1000]))
        x = rng.randn(N, n).astype(np.float32) * np.exp(rng.randn(N, 1) * 2).astype(np.float32)
        out[f"leaf_{i:03d}"] = x
    return out


def test_torch_2round_block_round2_over_two_tables_matches_jax(mesh, monkeypatch):
    """65 per-leaf pieces through the block-128 two-round wire: the
    aggregate is bit-exact against JAX's shard_map, and round 2 is ONE
    ``quantize_rows_many`` call whose pieces plan into two descriptor
    tables (one launch each on the card)."""
    grads = _many_leaves()

    def fn(g):
        g = jax.tree.map(lambda a: a[0], g)
        return jc.aggregate_gradients(g, WORKER_AXIS, N, mask_key=KEY, compress="int8_2round",
                                      quant_block_size=128, flat_output=True)

    want = np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(WORKER_AXIS),
                                            out_specs=P(), check_vma=False))(
        jax.tree.map(jnp.asarray, grads)))
    calls = []
    real = tc.quantize_rows_many

    def spy(xs):
        xs = list(xs)
        calls.append([x.shape[0] for x in xs])
        return real(xs)

    monkeypatch.setattr(tc, "quantize_rows_many", spy)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(KEY, N)).astype(np.int64))
    got = tc.aggregate_gradients({k: torch.from_numpy(v) for k, v in grads.items()},
                                 WorkerAxis(N), N, perm=perm, compress="int8_2round",
                                 quant_block_size=128, flat_output=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(calls) == 1 and len(calls[0]) == 65
    assert len(tq.plan_rows_tables(calls[0])) == 2


def test_torch_quantize_rows_many_is_the_plain_version_on_cpu():
    rng = np.random.RandomState(1)
    xs = [torch.from_numpy(rng.randn(r, 128).astype(np.float32)) for r in (3, 0, 17)]
    for pieces in (xs, [x.to(torch.bfloat16) for x in xs]):
        before = tq.quantize_rows_many.launches
        got = tq.quantize_rows_many(pieces)
        assert tq.quantize_rows_many.launches == before
        for (q, s), x in zip(got, pieces):
            qp, sp = tq.quantize_rows_plain(x)
            assert q.shape == (x.shape[0], 128) and s.shape == (x.shape[0], 1)
            assert torch.equal(q, qp) and torch.equal(s, sp)
    with pytest.raises(ValueError, match="one BS"):
        tq.quantize_rows_many([torch.zeros(2, 128), torch.zeros(2, 64)])
    with pytest.raises(ValueError, match="one dtype"):
        tq.quantize_rows_many([torch.zeros(2, 128), torch.zeros(2, 128, dtype=torch.bfloat16)])
