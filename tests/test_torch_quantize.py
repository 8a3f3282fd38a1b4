"""Port parity: ps_pytorch_tpu_torch.ops.quantize (kernels K1 and K2's
module) against the JAX package's ops/quantize.

Bit-exact on the CPU: the same numpy inputs go through JAX's
``quantize_int8`` under ``jax.jit`` (through its Pallas kernels in
interpret mode, or through its jnp path) and through the port's plain
versions. Every JAX caller of ``quantize_int8`` is jitted (the train
step, the serving engine), and under jit XLA computes ``absmax / 127.0``
as ``absmax * f32(1/127)``; an eager call divides, so the reference here
is the jitted function. Shared scales are held against
``quantize_int8(x, axis_name=...)`` inside ``shard_map`` on the 8-device
mesh. The kernels themselves are held against the plain versions on the
card in tests/test_torch_kernels_cuda.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.ops import quantize as jq
from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu_torch.ops.quantize import (
    RECIP_127,
    dequantize_int8,
    quantize_int8,
    quantize_rows,
    quantize_rows_plain,
    quantize_tensor,
    quantize_tensor_plain,
    quantize_tensors,
)
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis


def _x(shape, seed, scale=3.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[1] = 0.0  # an all-zero block: scale 0, inv 0
    # a block whose absmax is 127 (inv == 1 exactly) holding exact halves:
    # round-half-to-even decides these
    flat[2] = 0.5
    flat[2, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    return x


def _jq(x, **kw):
    """JAX's quantize_int8 as its callers run it: under jit."""
    return jax.jit(partial(jq.quantize_int8, **kw))(jnp.asarray(x))


def _div127(v):
    return v / 127.0


def _assert_same(qt, st, qj, sj):
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.cpu().numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.cpu().numpy(), np.asarray(sj))


def test_torch_quantize_scale_is_the_jitted_reciprocal_multiply():
    """The reason the reference is the jitted function: XLA rewrites the
    division by the constant 127 into a multiply by f32(1/127), which
    differs from the IEEE quotient in the last bit for a few percent of
    values; eager JAX divides. The port copies the jitted form."""
    rng = np.random.RandomState(9)
    a = (np.abs(rng.randn(20000)) * np.exp(rng.randn(20000) * 4)).astype(np.float32)
    jitted = np.asarray(jax.jit(_div127)(jnp.asarray(a)))
    eager = np.asarray(jnp.asarray(a) / 127.0)
    assert RECIP_127 == float(np.float32(1.0 / 127.0))
    np.testing.assert_array_equal(jitted, a * np.float32(RECIP_127))
    np.testing.assert_array_equal(eager, a / np.float32(127.0))
    assert (jitted != eager).sum() > 100


@pytest.mark.parametrize("nb,seed", [(8, 0), (64, 1)])
def test_torch_quantize_block128_bit_exact_vs_pallas_interpret(monkeypatch, nb, seed):
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")
    x = _x((nb, 128), seed)
    assert jq._pallas_mode(jnp.asarray(x)) == {"interpret": True}
    qj, sj = _jq(x, block_size=128)
    qt, st = quantize_int8(torch.from_numpy(x), block_size=128)
    _assert_same(qt, st, qj, sj)
    assert qt[2, :6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.mark.parametrize("shape", [(12, 4, 8), (5, 8, 64), (3, 7)])
def test_torch_quantize_head_dim_bit_exact_vs_jnp_path(monkeypatch, shape):
    """block = head_dim, as the int8 KV cache quantizes; (3, 7) at block 4
    pads the flattened tail."""
    monkeypatch.delenv("PS_TPU_PALLAS_INTERPRET", raising=False)
    x = _x(shape, 2)
    block = 4 if shape == (3, 7) else shape[-1]
    qj, sj = _jq(x, block_size=block)
    qt, st = quantize_int8(torch.from_numpy(x), block_size=block)
    _assert_same(qt, st, qj, sj)


def test_torch_quantize_many_scales_bit_exact():
    """Thousands of rows whose absmax spans many binades: every scale and
    inverse must be what XLA computes (an IEEE quotient for the inverse,
    the f32(1/127) product for the scale)."""
    rng = np.random.RandomState(6)
    x = (rng.randn(4096, 64) * np.exp(rng.randn(4096, 1) * 4)).astype(np.float32)
    qj, sj = _jq(x, block_size=64)
    qt, st = quantize_int8(torch.from_numpy(x), block_size=64)
    _assert_same(qt, st, qj, sj)


def test_torch_quantize_bf16_input_bit_exact():
    """The serving path hands K1 bf16 K/V; JAX casts them to f32 first.
    Both widen exactly, so the payloads agree bit for bit. bf16 values
    put x * inv on an exact .5 often (short mantissas), so these rows also
    pin that inv is the IEEE quotient 127 / absmax: a reciprocal times
    127 rounds the other way on dozens of these elements."""
    x = _x((4096, 64), 3)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    qj, sj = _jq(xj.astype(jnp.float32), block_size=64)
    qt, st = quantize_int8(xt, block_size=64)
    _assert_same(qt, st, qj, sj)


def test_torch_dequantize_bit_exact():
    x = _x((6, 5, 8), 4)
    qj, sj = _jq(x, block_size=8)
    qt, st = quantize_int8(torch.from_numpy(x), block_size=8)
    dj = jq.dequantize_int8(qj, sj, block_size=8, shape=x.shape)
    dt = dequantize_int8(qt, st, block_size=8, shape=x.shape)
    assert tuple(dt.shape) == x.shape
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # symmetric absmax quantization: |err| <= scale / 2 per block
    err = np.abs(dt.numpy() - x).reshape(-1, 8)
    assert np.all(err <= st.numpy() / 2 + 1e-7)


def test_torch_quantize_rows_is_the_plain_version_on_cpu():
    x = torch.from_numpy(_x((9, 24), 5))
    before = quantize_rows.launches
    q, s = quantize_rows(x)
    qp, sp = quantize_rows_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert quantize_rows.launches == before  # no kernel launch on the CPU


# ------------------------------------------------ per-tensor (kernel K2)

@pytest.mark.parametrize("shape,seed", [((16, 128), 0), ((3, 3, 20, 50), 1),
                                        ((1000,), 2), ((10,), 3)])
def test_torch_quantize_per_tensor_bit_exact_vs_pallas_interpret(monkeypatch, shape, seed):
    """JAX's _pallas_quantize_2d (kernel K2) in interpret mode on its
    lane-padded [M, 128] view; the port takes any length as it is."""
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")
    x = _x(shape, seed) if len(shape) > 1 else (
        np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)
    qj, sj = _jq(x)
    qt, st = quantize_int8(torch.from_numpy(x))
    assert tuple(qt.shape) == shape and st.shape == ()
    _assert_same(qt, st, qj, sj)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_torch_quantize_per_tensor_bit_exact_vs_jnp_path(monkeypatch, seed):
    monkeypatch.delenv("PS_TPU_PALLAS_INTERPRET", raising=False)
    rng = np.random.RandomState(seed)
    x = (rng.randn(37, 11) * np.exp(rng.randn() * 4)).astype(np.float32)
    qj, sj = _jq(x)
    qt, st = quantize_int8(torch.from_numpy(x))
    _assert_same(qt, st, qj, sj)


def test_torch_quantize_per_tensor_halves_and_zero():
    x = np.full((4, 32), 0.5, np.float32)
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    qt, st = quantize_int8(torch.from_numpy(x))
    assert qt[0, :6].tolist() == [127, 2, -4, 0, 0, 2] and float(st) == 1.0
    qz, sz = quantize_int8(torch.zeros(7))
    assert float(sz) == 0.0 and not qz.any()


def test_torch_quantize_tensor_is_the_plain_version_on_cpu():
    """quantize_tensor is the one-piece call of K2's multi-tensor wrapper,
    whose counter counts its launching calls: none on the CPU."""
    x = torch.from_numpy(_x((9, 24), 7))
    before = quantize_tensors.launches
    q, s = quantize_tensor(x)
    qp, sp = quantize_tensor_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert quantize_tensors.launches == before


# --------------------------------- shared scales over the worker axis

def _shard_map_quantize(mesh, x, block_size):
    def fn(v):
        q, s = jq.quantize_int8(v[0], axis_name=WORKER_AXIS, block_size=block_size)
        return q[None], s[None]

    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(WORKER_AXIS),
                              out_specs=(P(WORKER_AXIS), P(WORKER_AXIS)), check_vma=False))
    qj, sj = f(jnp.asarray(x))
    return np.asarray(qj), np.asarray(sj)


@pytest.mark.parametrize("kwargs", [
    {"block_size": 0},
    {"block_size": 8, "axis_name": WORKER_AXIS},
])
def test_torch_quantize_training_modes_ported(mesh, kwargs):
    """Per-tensor scales, and block scales shared over the workers, both
    bit-exact against JAX's quantize_int8 inside shard_map (worker-stacked
    in the port, one scale for every worker)."""
    bs = kwargs["block_size"]
    rng = np.random.RandomState(11 + bs)
    x = (rng.randn(8, 5, 19) * np.exp(rng.randn(8, 1, 1) * 2)).astype(np.float32)
    x[3, 1] = 0.0
    qj, sj = _shard_map_quantize(mesh, x, bs)
    qt, st = quantize_int8(torch.from_numpy(x), axis_name=WorkerAxis(8), block_size=bs)
    assert np.all(sj == sj[:1])  # the JAX scales are shared too
    np.testing.assert_array_equal(qt.numpy(), qj.reshape(qt.shape))
    np.testing.assert_array_equal(st.numpy(), sj[0].reshape(st.shape))


@pytest.mark.parametrize("bs,seed", [(0, 0), (0, 1), (128, 2), (128, 3), (64, 4)])
def test_torch_quantize_shared_scales_bit_exact_vs_shard_map(mesh, bs, seed):
    """Many binades across workers and rows (the absmax comes from
    different workers for different blocks); a ragged leaf length pads
    the last block."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(8, 3, 700) * np.exp(rng.randn(8, 3, 1) * 3)).astype(np.float32)
    qj, sj = _shard_map_quantize(mesh, x, bs)
    qt, st = quantize_int8(torch.from_numpy(x), axis_name=WorkerAxis(8), block_size=bs)
    np.testing.assert_array_equal(qt.numpy(), qj.reshape(qt.shape))
    np.testing.assert_array_equal(st.numpy(), sj[0].reshape(st.shape))
    if bs:
        deq = dequantize_int8(qt, st, block_size=bs, shape=(3, 700))
        assert tuple(deq.shape) == (8, 3, 700)


@pytest.mark.parametrize("kwargs", [
    {"block_size": 8, "rounding": "stochastic"},
])
def test_torch_quantize_training_modes_not_ported_yet(kwargs):
    """Stochastic rounding (refused before its port) needs its uniform
    draws, as JAX's needs a key: ValueError without them
    (tests/test_torch_quantize_lattice.py holds the draws' route)."""
    with pytest.raises(ValueError, match="uniform draws"):
        quantize_int8(torch.zeros(16), **kwargs)
