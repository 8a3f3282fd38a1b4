"""Port parity: ps_pytorch_tpu_torch.parallel.ring_attention (the stacked
sequence ring, naive and flash) and parallel/ulysses.py, against the JAX
package's rings under ``shard_map`` on the CPU mesh.

The same numpy q/k/v go through JAX's ``ring_attention`` /
``ring_flash_attention`` (its Pallas kernels in interpret mode) on an
n-device sequence mesh and through the port's stacked ring on the CPU
(the kernels' plain versions), at n in {1, 3, 4}, causal and not: the
output and the gradients of ``sum(o * cos(o))``. f32; tolerance 2e-5 on
values and 5e-5 on gradients (the JAX tests' own ring-vs-full bounds are
2e-5 / 5e-4): f32 sums over the same hops, in another order.
``WorkerAxis.ppermute`` is pinned against ``lax.ppermute``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.parallel.ring_attention import (
    SEQ_AXIS,
    make_seq_mesh,
)
from ps_pytorch_tpu.parallel.ring_attention import ring_attention as j_ring
from ps_pytorch_tpu.parallel.ring_attention import ring_flash_attention as j_ring_flash
from ps_pytorch_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from ps_pytorch_tpu_torch.parallel import ring_attention as tra
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from ps_pytorch_tpu_torch.parallel.ulysses import ulysses_attention

B, T_LOC, H, D = 2, 8, 2, 16


def _qkv(n, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, n * T_LOC, H, D).astype(dtype) for _ in range(3)]


def _jax_ring(fn, n, q, k, v, grads: bool):
    """JAX's ring ``fn`` under shard_map on an n-device sequence mesh:
    the global output and, with ``grads``, d/d(q, k, v) of sum(o cos o)."""
    mesh = make_seq_mesh(n)
    mapped = jax.shard_map(fn, mesh=mesh, in_specs=(P(None, SEQ_AXIS),) * 3,
                           out_specs=P(None, SEQ_AXIS), check_vma=False)

    def loss(a, b, c):
        o = mapped(a, b, c)
        return jnp.sum(o.astype(jnp.float32) * jnp.cos(o.astype(jnp.float32)))

    args = [jnp.asarray(x) for x in (q, k, v)]
    out = np.asarray(jax.jit(mapped)(*args)).astype(np.float32)
    if not grads:
        return out, None
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return out, [np.asarray(x).astype(np.float32) for x in g]


def _port_ring(fn, n, q, k, v, grads: bool):
    axis = WorkerAxis(n)
    xs = [torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if x.dtype != np.float32 else torch.float32
    ).requires_grad_(grads) for x in (q, k, v)]
    o = tra.unshard_sequence(fn(*(tra.shard_sequence(x, axis) for x in xs), axis=axis), axis)
    if grads:
        of = o.float()
        (of * torch.cos(of)).sum().backward()
    return (o.detach().float().numpy(),
            [x.grad.float().numpy() for x in xs] if grads else None)


def _check(jfn, tfn, n, seed, grads=True, tol=(2e-5, 5e-5), dtype=np.float32):
    q, k, v = _qkv(n, seed, dtype)
    want_o, want_g = _jax_ring(jfn, n, q, k, v, grads)
    got_o, got_g = _port_ring(tfn, n, q, k, v, grads)
    np.testing.assert_allclose(got_o, want_o, rtol=tol[0], atol=tol[0])
    for g, w in zip(got_g or [], want_g or []):
        np.testing.assert_allclose(g, w, rtol=tol[1], atol=tol[1])


def _jfn(name, causal, bidirectional=False):
    ring = {"ring_attention": j_ring, "ring_flash_attention": j_ring_flash}[name]

    def fn(q, k, v):
        return ring(q, k, v, SEQ_AXIS, causal=causal, bidirectional=bidirectional)

    return fn


def _tfn(name, causal, bidirectional=False):
    ring = getattr(tra, name)

    def fn(q, k, v, axis):
        return ring(q, k, v, axis, causal=causal, bidirectional=bidirectional)

    return fn


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("perm", ["fwd", "bwd", "home", "partial"])
def test_torch_ppermute_matches_lax_ppermute(n, perm):
    pairs = {
        "fwd": [(j, (j - 1) % n) for j in range(n)],   # the ring's rotation
        "bwd": [(j, (j + 1) % n) for j in range(n)],
        "home": [(j, (j + 2) % n) for j in range(n)],  # the bidirectional delivery
        "partial": [(0, 2), (2, 1)],                   # unreceived rows get zeros
    }[perm]
    x = np.random.RandomState(n).randn(n, 3, 5).astype(np.float32)
    mesh = make_seq_mesh(n)

    def permute(a):
        return lax.ppermute(a, SEQ_AXIS, pairs)

    want = jax.jit(jax.shard_map(permute, mesh=mesh, in_specs=P(SEQ_AXIS),
                                 out_specs=P(SEQ_AXIS), check_vma=False))(jnp.asarray(x))
    got = WorkerAxis(n).ppermute(torch.from_numpy(x), pairs)
    assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_torch_ring_attention_matches_jax(n, causal):
    _check(_jfn("ring_attention", causal), _tfn("ring_attention", causal), n, seed=n)


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_torch_ring_flash_attention_matches_jax(n, causal):
    _check(_jfn("ring_flash_attention", causal), _tfn("ring_flash_attention", causal),
           n, seed=10 + n)


@pytest.mark.parametrize("name", ["ring_attention", "ring_flash_attention"])
@pytest.mark.parametrize("n", [3, 4])
def test_torch_bidirectional_ring_matches_jax(name, n):
    """Odd n, and even n, where offset n/2 arrives on both streams (JAX
    masks the duplicate; the port does not compute it)."""
    _check(_jfn(name, True, True), _tfn(name, True, True), n, seed=20 + n)


def test_torch_ring_flash_bf16_matches_jax():
    """bf16 inputs, f32 ring statistics on both sides: outputs within one
    bf16 ulp of the largest value, no gradient check (bf16 cotangents)."""
    _check(_jfn("ring_flash_attention", True), _tfn("ring_flash_attention", True), 4,
           seed=31, grads=False, tol=(2e-2, 0), dtype=jnp.bfloat16)


def test_torch_ring_flash_launch_counts_on_cpu_follow_the_hops():
    """The plain versions run in place of the kernels on the CPU and count
    no launch; the hop structure is what the card counts (chip_smoke)."""
    from ps_pytorch_tpu_torch.ops.flash_attention import flash_partial

    before = flash_partial.launches
    q, k, v = _qkv(4, 0)
    _port_ring(_tfn("ring_flash_attention", True), 4, q, k, v, grads=True)
    assert flash_partial.launches == before
    assert tra._hop_shifts(4, False) == [(0, 0), (0, 1), (0, 2), (0, 3)]
    assert tra._hop_shifts(4, True) == [(0, 0), (0, 1), (1, -1), (0, 2)]
    assert tra._hop_shifts(5, True) == [(0, 0), (0, 1), (1, -1), (0, 2), (1, -2)]


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("causal", [True, False])
def test_torch_ulysses_matches_jax(monkeypatch, impl, causal):
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")  # JAX flash: its kernels

    def jfn(q, k, v):
        return j_ulysses(q, k, v, SEQ_AXIS, causal=causal, impl=impl)

    def tfn(q, k, v, axis):
        return ulysses_attention(q, k, v, axis, causal=causal, impl=impl)

    _check(jfn, tfn, 2, seed=40)


def test_torch_ring_rejects_bad_shards():
    axis = WorkerAxis(3)
    q = torch.zeros(2, 1, 4, 2, 16)
    with pytest.raises(ValueError, match="stacked shards"):
        tra.ring_flash_attention(q, q, q, axis)
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention(torch.zeros(3, 1, 4, 2, 16), *(torch.zeros(3, 1, 4, 2, 16),) * 2,
                          axis)

