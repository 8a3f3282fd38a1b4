"""Port parity: ps_pytorch_tpu_torch.ops.quantize (kernel K1's module)
against the JAX package's ops/quantize.

Bit-exact on the CPU: the same numpy inputs go through JAX's
``quantize_int8`` (through its Pallas row kernel in interpret mode at
block 128 with n_blocks % 8 == 0, through its jnp path at block =
head_dim) and through the port's plain version. The kernel itself is
held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.ops import quantize as jq
from ps_pytorch_tpu_torch.ops.quantize import (
    dequantize_int8,
    quantize_int8,
    quantize_rows,
    quantize_rows_plain,
)


def _x(shape, seed, scale=3.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[1] = 0.0  # an all-zero block: scale 0, inv 0
    # a block whose absmax is 127 (inv == 1 exactly) holding exact halves:
    # round-half-to-even decides these
    flat[2] = 0.5
    flat[2, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    return x


def _assert_same(qt, st, qj, sj):
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.cpu().numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.cpu().numpy(), np.asarray(sj))


@pytest.mark.parametrize("nb,seed", [(8, 0), (64, 1)])
def test_torch_quantize_block128_bit_exact_vs_pallas_interpret(monkeypatch, nb, seed):
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")
    x = _x((nb, 128), seed)
    assert jq._pallas_mode(jnp.asarray(x)) == {"interpret": True}
    qj, sj = jq.quantize_int8(jnp.asarray(x), block_size=128)
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
    qj, sj = jq.quantize_int8(jnp.asarray(x), block_size=block)
    qt, st = quantize_int8(torch.from_numpy(x), block_size=block)
    _assert_same(qt, st, qj, sj)


def test_torch_quantize_many_scales_bit_exact():
    """Thousands of rows whose absmax spans many binades: every scale and
    inverse must be the IEEE quotient (a reciprocal-multiply differs from
    it in the last bit for some of these)."""
    rng = np.random.RandomState(6)
    x = (rng.randn(4096, 64) * np.exp(rng.randn(4096, 1) * 4)).astype(np.float32)
    qj, sj = jq.quantize_int8(jnp.asarray(x), block_size=64)
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
    qj, sj = jq.quantize_int8(xj.astype(jnp.float32), block_size=64)
    qt, st = quantize_int8(xt, block_size=64)
    _assert_same(qt, st, qj, sj)


def test_torch_dequantize_bit_exact():
    x = _x((6, 5, 8), 4)
    qj, sj = jq.quantize_int8(jnp.asarray(x), block_size=8)
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


@pytest.mark.parametrize("kwargs", [
    {"block_size": 0},
    {"block_size": 8, "axis_name": "workers"},
    {"block_size": 8, "rounding": "stochastic"},
])
def test_torch_quantize_training_modes_not_ported_yet(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quantize_int8(torch.zeros(16), **kwargs)

