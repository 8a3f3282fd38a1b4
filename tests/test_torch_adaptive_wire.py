"""Port parity: the adaptive PS wire (ps_pytorch_tpu_torch.parallel
.collectives) against the JAX package's ``aggregate_gradients`` on the
8-device CPU mesh, called under ``jax.jit`` as the train step calls it.

- stochastic rounding on the int8 and the two-round dequant wires, the
  port fed JAX's own ``jax.random.uniform`` draws through a draw source
  that folds the key as JAX does (worker, then the piece's key id: a
  leaf's index, or a bucket's start offset; then 1 for round 2);
- a traced aggregation count (``num_aggregate`` a device int32 tensor,
  a traced int32 in JAX) on the uncompressed, int8 and two-round wires,
  in both domains, both mask modes; at the full count, bit for bit the
  static unmasked wire;
- per-bucket lattice peaks (``bucket_peaks``, mixed tags) on the same
  wires;
- JAX's ValueErrors for the combinations it refuses.

Every output (the flat aggregate and the EF contribution) is held bit
for bit: the wires are exact functions of equal inputs and draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.ops.quantize import precision_peaks as jprecision_peaks
from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu.parallel import collectives as jc
from ps_pytorch_tpu_torch.ops.quantize import precision_peaks
from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_wires import KEY, N, jax_perm, torch_tree, wide_grads


QKEY = jax.random.key(7)


def _uniforms(qkey, pid, rnd, shape):
    """Every worker's draws for one piece: ``uniform(fold_in(fold_in(qkey,
    w), pid))``, round 2 (``rnd``) folding 1 more."""
    def one(w):
        k = jax.random.fold_in(jax.random.fold_in(qkey, w), pid)
        if rnd:
            k = jax.random.fold_in(k, 1)
        return jax.random.uniform(k, shape, jnp.float32)

    return jax.vmap(one)(jnp.arange(N))


_uniforms_jit = jax.jit(_uniforms, static_argnums=(2, 3))


def jax_draws(qkey):
    """The port's draw source holding JAX's draws: worker w's uniforms
    for piece ``pid`` come from ``fold_in(fold_in(qkey, w), pid)``, and
    round 2's from a further ``fold_in(., 1)``."""
    def draws(pid, rnd, shape):
        return torch.from_numpy(np.array(_uniforms_jit(qkey, pid, rnd, tuple(shape))))

    return draws


def jax_wire(mesh, grads, count=None, peaks=None, **kw):
    """JAX's flat aggregate and EF contribution in one compiled
    shard_map; ``count`` / ``peaks`` enter traced, as the step's
    ``agg_count`` and ``bucket_peaks``."""
    def fn(g, count, peaks):
        g = jax.tree.map(lambda a: a[0], g)
        agg, contrib = jc.aggregate_gradients(
            g, WORKER_AXIS, N, num_aggregate=count, mask_key=KEY, flat_output=True,
            return_contribution=True, bucket_peaks=peaks, **kw)
        return agg, jax.tree.map(lambda a: a[None], contrib)

    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(WORKER_AXIS), P(), P()),
                              out_specs=(P(), P(WORKER_AXIS)), check_vma=False))
    args = (jax.tree.map(jnp.asarray, grads),
            None if count is None else jnp.int32(count),
            None if peaks is None else jnp.asarray(peaks, jnp.float32))
    return jax.tree.map(np.asarray, f(*args))


def port_wire(grads, count=None, peaks=None, quant_key=None, **kw):
    tg = torch_tree(grads)
    return tc.aggregate_gradients(
        tg, WorkerAxis(N), N, perm=jax_perm(), flat_output=True, return_contribution=True,
        num_aggregate=None if count is None else torch.tensor(count, dtype=torch.int32),
        bucket_peaks=None if peaks is None else torch.from_numpy(np.asarray(peaks, np.float32)),
        quant_draws=None if quant_key is None else jax_draws(quant_key), **kw)


def assert_same(got, want, exact=True):
    """Bit for bit; ``exact=False`` (the uncompressed wire's f32 sum over
    the workers, which XLA adds in worker order and torch in its own)
    within 2 ulps of the largest value."""
    agg, contrib = got
    want_agg, want_c = want
    if exact:
        np.testing.assert_array_equal(agg.numpy(), want_agg)
    else:
        tol = 2 * np.spacing(np.abs(want_agg).max())
        assert np.abs(agg.numpy() - want_agg).max() <= tol
    for a, b in zip(tree_leaves(contrib), jax.tree_util.tree_leaves(want_c)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("compress,block,bucket_bytes", [
    ("int8", 0, None), ("int8", 128, 65536), ("int8_2round", 0, 65536),
    ("int8_2round", 128, None),
])
def test_torch_stochastic_wire_matches_jax_with_its_draws(mesh, compress, block, bucket_bytes):
    """Stochastic rounding with JAX's draws: the aggregate and the EF
    contribution bit for bit (on a bucketed wire a piece's draws fold its
    start offset, so two buckets' draws differ from a per-ordinal fold)."""
    kw = dict(compress=compress, quant_block_size=block, bucket_bytes=bucket_bytes,
              quant_rounding="stochastic")
    g = wide_grads(11)
    want = jax_wire(mesh, g, quant_key=QKEY, **kw)
    assert_same(port_wire(g, quant_key=QKEY, **kw), want)
    # the draws matter: nearest rounding gives another aggregate
    near = port_wire(g, compress=compress, quant_block_size=block, bucket_bytes=bucket_bytes)
    assert not np.array_equal(near[0].numpy(), want[0])


@pytest.mark.parametrize("compress,wire_domain,block", [
    (None, "dequant", 0), ("int8", "dequant", 0), ("int8", "homomorphic", 128),
    ("int8_2round", "dequant", 128), ("int8_2round", "homomorphic", 0),
])
@pytest.mark.parametrize("count,mask_mode", [(5, "random_k"), (8, "first_k")])
def test_torch_traced_count_wire_matches_jax(mesh, compress, wire_domain, block, count,
                                             mask_mode):
    """A device count, traced in JAX: the mask by rank in the
    permutation and the quotient by the count, bit for bit (the
    uncompressed wire within its f32 sum's order); at the full count bit
    for bit the static unmasked wire too."""
    kw = dict(compress=compress, wire_domain=wire_domain, quant_block_size=block,
              bucket_bytes=0, mask_mode=mask_mode)
    g = wide_grads(12)
    got = port_wire(g, count=count, **kw)
    assert_same(got, jax_wire(mesh, g, count=count, **kw), exact=compress is not None)
    if count == N:
        static = port_wire(g, **kw)
        np.testing.assert_array_equal(got[0].numpy(), static[0].numpy())


@pytest.mark.parametrize("compress,wire_domain,block,hi", [
    ("int8", "dequant", 0, 32767), ("int8", "homomorphic", 128, 4095),
    ("int8_2round", "dequant", 0, 127), ("int8_2round", "homomorphic", 128, 127),
])
def test_torch_bucket_peaks_wire_matches_jax(mesh, compress, wire_domain, block, hi):
    """Mixed tags over the 64 KiB buckets (skip, 4-bit, int8, hi), with
    a traced count: the lattice route, bit for bit."""
    g = wide_grads(13)
    n_buckets = len(tc.piece_stream(torch_tree(g), 65536, align=block or 1)[1])
    assert n_buckets >= 3
    tags = np.arange(n_buckets) % 4
    np.testing.assert_array_equal(precision_peaks(hi), jprecision_peaks(hi))
    peaks = precision_peaks(hi)[tags]
    kw = dict(compress=compress, wire_domain=wire_domain, quant_block_size=block,
              bucket_bytes=65536, mask_mode="random_k", lattice_hi_peak=hi)
    if compress == "int8_2round":
        kw.pop("lattice_hi_peak")
    assert_same(port_wire(g, count=6, peaks=peaks, **kw),
                jax_wire(mesh, g, count=6, peaks=peaks, **kw))
    assert_same(port_wire(g, peaks=peaks, **kw), jax_wire(mesh, g, peaks=peaks, **kw))


def test_torch_adaptive_wire_refuses_what_jax_refuses():
    """JAX's ValueErrors, message for message where they name the
    combination."""
    tg = torch_tree(wide_grads(14))
    axis = WorkerAxis(N)
    draws = jax_draws(QKEY)
    with pytest.raises(ValueError, match="homomorphic"):
        tc.aggregate_gradients(tg, axis, N, compress="int8", wire_domain="homomorphic",
                               quant_rounding="stochastic", quant_draws=draws)
    with pytest.raises(ValueError, match="adaptive precision"):
        tc.aggregate_gradients(tg, axis, N, compress="int8", bucket_bytes=0,
                               quant_rounding="stochastic", quant_draws=draws,
                               bucket_peaks=torch.ones(1))
    with pytest.raises(ValueError, match="adaptive precision"):
        tc.aggregate_gradients(tg, axis, N, bucket_bytes=0, bucket_peaks=torch.ones(1))
    with pytest.raises(ValueError, match="homomorphic wire"):
        tc.quantized_allreduce_2round(tg, axis, 8.0, N, wire_domain="homomorphic",
                                      rounding="stochastic", draws=draws)
    with pytest.raises(ValueError, match="needs a key"):
        tc.quantized_psum(tg, axis, 8.0, rounding="stochastic")
