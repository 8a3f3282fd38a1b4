"""Port parity: the rest of ops/quantize.py (ps_pytorch_tpu_torch.ops
.quantize): stochastic rounding, the int4 / lattice codec and the
adaptive-precision tables, against the JAX functions under ``jax.jit``
(as the train step calls them), bit for bit.

Division, as XLA runs it under jit (ROADMAP.md Port rules "Division"):
``quantize_lattice``'s inverse scale ``peak / max(absmax, 1e-30)`` is a
quotient whatever the peak; its scale ``absmax / max(peak, 1)`` is a
quotient for a traced peak (a tag's, on the adaptive wire) and a
multiply by the f32 reciprocal for a constant one (``quantize_int4``'s
7). So at a traced peak of 127 the payload equals ``quantize_int8``'s
and the scale may differ from its ``absmax * (1/127)`` in the last bit,
in JAX and in the port alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.ops import quantize as jq
from ps_pytorch_tpu_torch.ops import quantize as tq

SHAPES = [(1000,), (7, 129), (3, 3, 5, 11)]


def _x(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * np.float32(np.exp(rng.randn()))
    x.reshape(-1)[::17] = 0.0
    return x


def _jit_lattice(block, hi, out_dtype):
    def f(x, peak):
        return jq.quantize_lattice(x, peak, block_size=block, hi_peak=hi, out_dtype=out_dtype)
    return jax.jit(f)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [0, 16])
@pytest.mark.parametrize("peak,hi", [(0.0, 127), (7.0, 127), (127.0, 127), (4095.0, 4095),
                                     (32767.0, 32767)])
def test_torch_quantize_lattice_traced_peak_matches_jax(shape, block, peak, hi):
    """A device-tensor peak (JAX: traced): payload and scale bit for bit,
    in the payload dtype of the HI peak."""
    out_j = {127: jnp.int8, 4095: jnp.int16, 32767: jnp.int16}[hi]
    out_t = {127: torch.int8, 4095: torch.int16, 32767: torch.int16}[hi]
    x = _x(shape, int(peak) + block)
    qj, sj = _jit_lattice(block, hi, out_j)(jnp.asarray(x), jnp.float32(peak))
    qt, st = tq.quantize_lattice(torch.from_numpy(x), torch.tensor(peak), block_size=block,
                                 hi_peak=hi, out_dtype=out_t)
    assert qt.dtype == out_t
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if peak == 0.0:
        assert not qt.any() and not st.any()


@pytest.mark.parametrize("block", [0, 16])
@pytest.mark.parametrize("peak", [0.0, 7.0, 127.0])
def test_torch_quantize_lattice_constant_peak_matches_jax(block, peak):
    """A Python-number peak (JAX: a constant under jit) multiplies by the
    f32 reciprocal of the peak; pinned against both spellings."""
    x = _x((5, 320), 3 + block)

    def f(x):
        return jq.quantize_lattice(x, peak, block_size=block)

    qj, sj = jax.jit(f)(jnp.asarray(x))
    qt, st = tq.quantize_lattice(torch.from_numpy(x), peak, block_size=block)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if peak:
        absmax = np.abs(x.reshape(-1, block) if block else x).max(
            axis=1 if block else None, keepdims=bool(block))
        np.testing.assert_array_equal(
            st.numpy(), absmax * (np.float32(1.0) / np.float32(peak)))


def test_torch_lattice_at_127_is_quantize_int8_but_for_the_scale_division():
    """The all-int8 tag: the payload is ``quantize_int8``'s bit for bit;
    the scale is the quotient ``absmax / 127`` where ``quantize_int8``
    multiplies by f32(1/127), within one ulp of it (as in JAX)."""
    x = _x((64, 128), 9)
    q8, s8 = tq.quantize_int8(torch.from_numpy(x), block_size=128)
    ql, sl = tq.quantize_lattice(torch.from_numpy(x), torch.tensor(127.0), block_size=128)
    assert torch.equal(q8, ql)
    ulps = np.abs(sl.numpy().view(np.int32) - s8.numpy().view(np.int32))
    assert ulps.max() <= 1
    qj8, sj8 = jax.jit(_jax_int8_block128)(jnp.asarray(x))
    qjl, sjl = _jit_lattice(128, 127, jnp.int8)(jnp.asarray(x), jnp.float32(127.0))
    np.testing.assert_array_equal(np.asarray(qj8), np.asarray(qjl))
    np.testing.assert_array_equal(np.asarray(sjl), sl.numpy())
    np.testing.assert_array_equal(np.asarray(sj8), s8.numpy())


def _jax_int8_block128(x):
    return jq.quantize_int8(x, block_size=128)


@pytest.mark.parametrize("block", [0, 32])
def test_torch_quantize_int4_matches_jax(block):
    x = _x((9, 77), 21 + block)

    def f(x):
        return jq.quantize_int4(x, block_size=block)

    qj, sj = jax.jit(f)(jnp.asarray(x))
    qt, st = tq.quantize_int4(torch.from_numpy(x), block_size=block)
    assert qt.dtype == torch.int8 and int(qt.abs().max()) <= 7
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("n", [1, 2, 15, 16, 1001])
def test_torch_pack_unpack_int4_matches_jax(n):
    """Odd lengths pad the last high nibble with the bias; unpack gives
    int8 back."""
    q = np.random.RandomState(n).randint(-7, 8, size=n).astype(np.int8)
    packed_j = jax.jit(jq.pack_int4)(jnp.asarray(q))
    packed_t = tq.pack_int4(torch.from_numpy(q))
    assert packed_t.dtype == torch.uint8 and packed_t.numel() == (n + 1) // 2
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    back = tq.unpack_int4(packed_t, n)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jq.unpack_int4(packed_j, n)))
    if n % 2:
        assert int(packed_t[-1]) >> 4 == 8  # the bias: value 0


@pytest.mark.parametrize("hi", [7, 127, 128, 4095, 32767, 40000])
def test_torch_precision_tables_match_jax(hi):
    np.testing.assert_array_equal(tq.precision_peaks(hi), jq.precision_peaks(hi))
    assert tq.precision_peaks(hi).dtype == np.float32
    assert tq.precision_bytes_per_element(hi) == jq.precision_bytes_per_element(hi)
    assert (tq.PREC_SKIP, tq.PREC_4BIT, tq.PREC_INT8, tq.PREC_HI) == (
        jq.PREC_SKIP, jq.PREC_4BIT, jq.PREC_INT8, jq.PREC_HI)
    assert tq.PRECISION_TAG_NAMES == jq.PRECISION_TAG_NAMES


@pytest.mark.parametrize("block", [0, 128])
def test_torch_quantization_error_matches_jax(block):
    x = _x((33, 70), 40 + block)

    def f(x):
        return jq.quantization_error(x, block_size=block)

    got = tq.quantization_error(torch.from_numpy(x), block_size=block)
    assert got.dim() == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(f)(jnp.asarray(x))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [0, 64])
def test_torch_stochastic_quantize_int8_matches_jax_draws(shape, block):
    """``floor(x * inv + u)`` with JAX's ``jax.random.uniform`` draws over
    the rounded operand (the padded block rows in block mode), bit for
    bit: XLA fuses ``x * inv + u`` into one multiply-add, and so does the
    port (the f64 product is exact)."""
    x = _x(shape, 60 + block)
    key = jax.random.key(5 + block)

    def f(x):
        return jq.quantize_int8(x, block_size=block, rounding="stochastic", key=key)

    qj, sj = jax.jit(f)(jnp.asarray(x))
    n = x.size
    op_shape = (-(-n // block), block) if block else shape
    u = np.array(jax.random.uniform(key, op_shape, jnp.float32))
    qt, st = tq.quantize_int8(torch.from_numpy(x), block_size=block, rounding="stochastic",
                              uniform=torch.from_numpy(u))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_torch_stochastic_rounding_is_the_fused_multiply_add():
    """The elements where ``fl(fl(x * inv) + u)`` and ``fl(x * inv + u)``
    floor differently: the port (and XLA) take the fused value."""
    rng = np.random.RandomState(0)
    x = (rng.standard_normal(1 << 21) * 3).astype(np.float32)
    u = rng.uniform(0, 1, x.shape).astype(np.float32)
    inv = np.float32(127.0) / np.float32(np.abs(x).max())
    twice = np.floor((x * inv).astype(np.float32) + u)
    fused = np.floor((x.astype(np.float64) * np.float64(inv) + u).astype(np.float32))
    diff = np.nonzero(twice != fused)[0]
    assert diff.size >= 1
    qt, _ = tq.quantize_int8(torch.from_numpy(x), rounding="stochastic",
                             uniform=torch.from_numpy(u))
    np.testing.assert_array_equal(qt.numpy()[diff], np.clip(fused[diff], -127, 127))

    def f(x, u):
        absmax = jnp.max(jnp.abs(x))
        inv = jnp.where(absmax > 0, 127.0 / jnp.maximum(absmax, 1e-30), 0.0)
        return jnp.floor(x * inv + u)

    np.testing.assert_array_equal(np.asarray(jax.jit(f)(x, u))[diff], fused[diff])


def test_torch_stochastic_rounding_is_unbiased():
    """E[deq(q(x))] = x: the mean error over 64 draws of a 1e5-element
    tensor lies within 4 standard errors of 0; nearest rounding's error
    does not average out."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.uniform(-1, 1, 100_000).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    errs = []
    for _ in range(64):
        q, s = tq.quantize_int8(x, rounding="stochastic", uniform=torch.rand(x.shape, generator=g))
        errs.append((tq.dequantize_int8(q, s) - x).double())
    e = torch.stack(errs)
    mean = e.mean()
    se = e.std() / np.sqrt(e.numel())
    assert abs(float(mean)) <= 4 * float(se)
    per_element = e.mean(0)
    q, s = tq.quantize_int8(x)
    nearest = (tq.dequantize_int8(q, s) - x).double()
    # averaged over draws, each element's error shrinks below nearest's
    assert float(per_element.abs().mean()) < 0.5 * float(nearest.abs().mean())


def test_torch_stochastic_quantize_refuses_missing_or_misshaped_draws():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="uniform draws"):
        tq.quantize_int8(x, rounding="stochastic")
    with pytest.raises(ValueError, match="do not match"):
        tq.quantize_int8(x, block_size=8, rounding="stochastic", uniform=torch.zeros(16))
    with pytest.raises(ValueError, match="unknown rounding"):
        tq.quantize_int8(x, rounding="up", uniform=torch.zeros(16))
