"""Port parity: the homomorphic (compressed-domain) algebra, kernel K3's
function and the homomorphic wires, against the JAX package.

- ``accumulate_rescale_int8`` (K3's plain version on the CPU) against
  JAX's jnp path and its Pallas kernel in interpret mode, bit-exact, over
  EVERY accumulator value in ``[-127 d, 127 d]`` for each divisor d, with
  a float and a 0-d tensor divisor, and at ragged shapes;
- ``accum_capacity`` / ``accum_dtype`` at the capacity edges;
- the stacked backend's ``all_to_all``, ``all_gather``, ``psum_scatter``
  and the int16 ``psum`` against the JAX collectives in ``shard_map``;
- the homomorphic int8 and two-round wires (per-tensor and block-128,
  per-leaf / fused / 64 KiB buckets, every mask) against JAX's
  ``aggregate_gradients`` under ``jax.jit``: aggregate and EF
  contribution bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.ops import quantize as jq
from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu_torch.ops import quantize as tq
from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_wires import MASKS, check_wire_matches_jax, torch_tree, wide_grads


N = 8
DIVISORS = [1, 2, 3, 4, 5, 6, 7, 8, 10, 16]


def every_accumulator(d: int) -> np.ndarray:
    """int8 rows ``[d, 254 d + 1]`` whose column sums run through every
    value of ``[-127 d, 127 d]``, each row in [-127, 127]."""
    target = np.arange(-127 * d, 127 * d + 1)
    rows, rest = [], target.copy()
    for _ in range(d):
        v = np.clip(rest, -127, 127)
        rows.append(v)
        rest = rest - v
    assert not rest.any()
    return np.stack(rows).astype(np.int8)


def _jax_rescale(recv, d):
    return jq.accumulate_rescale_int8(recv, d)


@pytest.mark.parametrize("d", DIVISORS)
def test_torch_accumulate_rescale_exhaustive_matches_jax(d, monkeypatch):
    recv = every_accumulator(d)
    acc = recv.astype(np.int64).sum(0)
    exact = np.clip(np.round(acc / d), -127, 127).astype(np.int8)  # half to even
    t = torch.from_numpy(recv)
    got_float = tq.accumulate_rescale_int8(t, float(d)).numpy()
    got_tensor = tq.accumulate_rescale_int8(t, torch.tensor(float(d))).numpy()
    np.testing.assert_array_equal(got_float, exact)
    np.testing.assert_array_equal(got_tensor, exact)

    monkeypatch.setenv("PS_TPU_DISABLE_PALLAS", "1")
    jr = jnp.asarray(recv)
    eager = np.asarray(jq.accumulate_rescale_int8(jr, float(d)))
    jitted = np.asarray(jax.jit(_jax_rescale, static_argnums=1)(jr, float(d)))
    traced = np.asarray(jax.jit(_jax_rescale)(jr, jnp.float32(d)))
    for want in (eager, jitted, traced):
        np.testing.assert_array_equal(got_float, want)
    # the Pallas kernel (interpret mode) takes s % 128 == 0: zero columns pad
    monkeypatch.delenv("PS_TPU_DISABLE_PALLAS")
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")
    s = recv.shape[1]
    padded = np.pad(recv, ((0, 0), (0, -s % 128)))
    pallas = np.asarray(jq.accumulate_rescale_int8(jnp.asarray(padded), float(d)))
    np.testing.assert_array_equal(got_float, pallas[:s])


@pytest.mark.parametrize("n,s", [(8, 130), (8, 1), (1, 300), (258, 4096), (3, 0)]
                         # the pitch classes s % 16 in {1, 4, 8, 12, 15}: rows of the
                         # kernel's aligned-word reads at every misalignment
                         + [(n, 32 + j) for n in (2, 4, 8) for j in (1, 4, 8, 12, 15)])
def test_torch_accumulate_rescale_shapes_match_jax(n, s, monkeypatch):
    monkeypatch.setenv("PS_TPU_DISABLE_PALLAS", "1")
    rng = np.random.RandomState(n + s)
    recv = rng.randint(-127, 128, (n, s)).astype(np.int8)
    if s:
        recv[:, 0] = 127  # the full-scale column: acc = 127 n
    for d in (float(n), 5.0, 8.0):
        got = tq.accumulate_rescale_int8(torch.from_numpy(recv), d)
        assert got.dtype == torch.int8 and tuple(got.shape) == (s,)
        want = np.asarray(jq.accumulate_rescale_int8(jnp.asarray(recv), d))
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tq.accumulate_rescale_int8(torch.from_numpy(recv), 8.0),
                       tq.accumulate_rescale_plain(torch.from_numpy(recv), 8.0))


def test_torch_accumulate_rescale_rejects_bad_inputs():
    with pytest.raises(ValueError):
        tq.accumulate_rescale_int8(torch.zeros((0, 4), dtype=torch.int8), 1.0)
    with pytest.raises(ValueError):
        tq.accumulate_rescale_int8(torch.zeros((2, 4), dtype=torch.int32), 1.0)
    with pytest.raises(TypeError):
        tq.accumulate_rescale_int8(torch.zeros((2, 4), dtype=torch.int8),
                                   torch.tensor(2.0, dtype=torch.float64))


@pytest.mark.parametrize("workers", [1, 258, 259, 16_909_320, 16_909_321])
def test_torch_accum_dtype_matches_jax(workers):
    assert tq.ACCUM_CAPACITY == jq.ACCUM_CAPACITY == {"int16": 258, "int32": 16_909_320}
    for name in ("int16", "int32"):
        for peak in (127, 7):
            assert tq.accum_capacity(name, peak) == jq.accum_capacity(name, peak)
    if workers > 16_909_320:
        with pytest.raises(ValueError, match="overflow int32"):
            jq.accum_dtype(workers)
        with pytest.raises(ValueError, match="overflow int32"):
            tq.accum_dtype(workers)
        return
    want = {jnp.int16: torch.int16, jnp.int32: torch.int32}[jq.accum_dtype(workers)]
    assert tq.accum_dtype(workers) == want


def test_torch_homomorphic_rescale_matches_jax():
    acc = np.arange(-700, 701, dtype=np.int32)
    for d in (3.0, 5.5, 6.0):
        want = np.asarray(jq.homomorphic_rescale(jnp.asarray(acc), d))
        got = tq.homomorphic_rescale(torch.from_numpy(acc), d)
        np.testing.assert_array_equal(got.numpy(), want)


def _collectives(x, y, z):
    a2a = lax.all_to_all(x[0], WORKER_AXIS, split_axis=0, concat_axis=0, tiled=True)
    return (a2a[None], lax.all_gather(y[0], WORKER_AXIS, tiled=True),
            lax.psum_scatter(z[0], WORKER_AXIS, tiled=True)[None],
            lax.psum(x[0].astype(jnp.int16), WORKER_AXIS))


def test_torch_worker_axis_collectives_match_jax(mesh):
    rng = np.random.RandomState(0)
    x = rng.randint(-127, 128, (N, N, 5)).astype(np.int8)  # [N, n, s]
    y = rng.randn(N, 3, 2).astype(np.float32)
    z = rng.randint(-30000, 30000, (N, N * 4, 2)).astype(np.int32)
    f = jax.jit(jax.shard_map(_collectives, mesh=mesh, in_specs=P(WORKER_AXIS),
                              out_specs=(P(WORKER_AXIS), P(), P(WORKER_AXIS), P()),
                              check_vma=False))
    a2a, gathered, scattered, summed = (np.asarray(v) for v in f(x, y, z))
    axis = WorkerAxis(N)
    # JAX's a2a result on worker w is [N(sender), s]; the port's [w, j]
    np.testing.assert_array_equal(axis.all_to_all(torch.from_numpy(x)).numpy(), a2a)
    np.testing.assert_array_equal(axis.all_gather(torch.from_numpy(y)).numpy(), gathered)
    ps = axis.psum_scatter(torch.from_numpy(z))
    assert ps.dtype == torch.int32
    np.testing.assert_array_equal(ps.numpy(), scattered)
    s16 = axis.psum(torch.from_numpy(x).to(torch.int16))
    assert s16.dtype == torch.int16  # the homomorphic wire's declared dtype
    np.testing.assert_array_equal(s16.numpy(), summed)
    with pytest.raises(ValueError):
        axis.psum_scatter(torch.zeros((N, 7)))


BUCKETS = [None, 0, 65536]


@pytest.mark.parametrize("bucket_bytes", BUCKETS)
@pytest.mark.parametrize("num_aggregate,mask_mode", MASKS)
@pytest.mark.parametrize("block", [0, 128])
def test_torch_int8_homomorphic_wire_matches_jax(mesh, block, num_aggregate, mask_mode,
                                                 bucket_bytes):
    check_wire_matches_jax(mesh, wide_grads(5), compress="int8", quant_block_size=block,
                           num_aggregate=num_aggregate, mask_mode=mask_mode,
                           bucket_bytes=bucket_bytes, wire_domain="homomorphic")


@pytest.mark.parametrize("bucket_bytes", BUCKETS)
@pytest.mark.parametrize("num_aggregate,mask_mode", MASKS)
@pytest.mark.parametrize("block", [0, 128])
def test_torch_2round_homomorphic_wire_matches_jax(mesh, block, num_aggregate, mask_mode,
                                                   bucket_bytes):
    check_wire_matches_jax(mesh, wide_grads(6), compress="int8_2round",
                           quant_block_size=block, num_aggregate=num_aggregate,
                           mask_mode=mask_mode, bucket_bytes=bucket_bytes,
                           wire_domain="homomorphic")


def test_torch_homomorphic_2round_launches_k3_once_per_piece():
    """The stacked launch shape: one K3 call per piece over the whole
    [N, n*s] round-1 payload, equal to the concatenation of the n
    per-region calls."""
    tg = torch_tree(wide_grads(7))
    calls = []
    real = tc.accumulate_rescale_int8

    def spy(recv, divisor):
        calls.append(tuple(recv.shape))
        out = real(recv, divisor)
        s = recv.shape[1] // N
        per_region = torch.cat([real(recv[:, w * s:(w + 1) * s], divisor) for w in range(N)])
        assert torch.equal(out, per_region)
        return out

    tc.accumulate_rescale_int8 = spy
    try:
        tc.aggregate_gradients(tg, WorkerAxis(N), N, compress="int8_2round",
                               bucket_bytes=0, wire_domain="homomorphic", num_aggregate=5,
                               mask_mode="first_k")
        assert len(calls) == 1 and calls[0][0] == N
        calls.clear()
        tc.aggregate_gradients(tg, WorkerAxis(N), N, compress="int8_2round",
                               wire_domain="homomorphic")
        assert len(calls) == len(tree_leaves(tg))
    finally:
        tc.accumulate_rescale_int8 = real
