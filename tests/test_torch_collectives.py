"""Port parity: the stacked worker backend's gradient aggregation
(ps_pytorch_tpu_torch.parallel.collectives, buckets.piece_stream, mesh)
against the JAX package's collectives inside ``shard_map`` on the
8-device CPU mesh.

The same numpy per-worker gradients go through JAX's
``aggregate_gradients`` (each device holds one worker's leaves) and
through the port's stacked version (every leaf ``[8, *shape]``). JAX's
random_k permutation is injected into the port. Pins:

- the int8 wire (per-tensor and block-128 scales, every mask) is
  bit-exact, aggregate and error-feedback contribution alike;
- the uncompressed wire agrees within 4 f32 ulps of the aggregate's
  magnitude (XLA's all-reduce and torch's sum add the 8 workers in
  different orders);
- the division by the aggregation count is XLA's: inside jit
  ``x / 5.0`` is ``x * f32(1/5)``, not the IEEE quotient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu.parallel import collectives as jc
from ps_pytorch_tpu.parallel.buckets import plan_buckets as jplan
from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel.buckets import piece_stream, tree_leaves
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis, make_mesh

N = 8
KEY = jax.random.key(42)


def _grads(seed=0):
    """Per-worker gradient tree, worker-stacked; magnitudes vary by
    worker and leaf so the shared absmax comes from different workers."""
    rng = np.random.RandomState(seed)
    scale = np.exp(rng.randn(N, 1) * 2).astype(np.float32)

    def leaf(*shape):
        x = rng.randn(N, *shape).astype(np.float32)
        return x * scale.reshape((N,) + (1,) * len(shape))

    return {
        "Conv_0": {"kernel": leaf(3, 3, 2, 5), "bias": leaf(5)},
        "Dense_0": {"kernel": leaf(40, 7)},
        "odd": leaf(301),
        "zero": np.zeros((N, 9), np.float32),
    }


def _torch_tree(g):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in g.items()}


def _jax_aggregate(mesh, grads, flat_output, return_contribution=False, **kw):
    def fn(g):
        g = jax.tree.map(lambda a: a[0], g)
        out = jc.aggregate_gradients(g, WORKER_AXIS, N, mask_key=KEY,
                                     flat_output=flat_output,
                                     return_contribution=return_contribution, **kw)
        if return_contribution:
            agg, contrib = out
            return agg, jax.tree.map(lambda a: a[None], contrib)
        return out

    out_specs = (P(), P(WORKER_AXIS)) if return_contribution else P()
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(WORKER_AXIS),
                              out_specs=out_specs, check_vma=False))
    return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, grads)))


def _jax_perm():
    return torch.from_numpy(np.asarray(jax.random.permutation(KEY, N)).astype(np.int64))


def _flat_np(tree):
    return np.concatenate([np.asarray(a).reshape(-1) for a in jax.tree_util.tree_leaves(tree)])


COMPRESS = [(None, 0), ("int8", 0), ("int8", 128)]
MASKS = [(None, "random_k"), (5, "first_k"), (5, "random_k")]


@pytest.mark.parametrize("flat_output", [False, True])
@pytest.mark.parametrize("num_aggregate,mask_mode", MASKS)
@pytest.mark.parametrize("compress,block", COMPRESS)
def test_torch_aggregate_gradients_matches_jax(mesh, compress, block, num_aggregate,
                                                mask_mode, flat_output):
    g = _grads()
    kw = dict(num_aggregate=num_aggregate, mask_mode=mask_mode, compress=compress,
              quant_block_size=block)
    want = _jax_aggregate(mesh, g, flat_output, **kw)
    got = tc.aggregate_gradients(_torch_tree(g), WorkerAxis(N), N, perm=_jax_perm(),
                                 flat_output=flat_output, **kw)
    got_np = got.numpy() if flat_output else _flat_np(_np_tree(got))
    want_np = want if flat_output else _flat_np(want)
    assert got_np.shape == want_np.shape
    if compress == "int8":
        np.testing.assert_array_equal(got_np, want_np)
    else:
        tol = 4 * np.finfo(np.float32).eps * np.abs(want_np).max()
        np.testing.assert_allclose(got_np, want_np, rtol=0, atol=tol)


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}


@pytest.mark.parametrize("block", [0, 128])
@pytest.mark.parametrize("num_aggregate,mask_mode", [(None, "random_k"), (5, "random_k")])
def test_torch_error_feedback_contribution_matches_jax(mesh, block, num_aggregate,
                                                      mask_mode):
    """What each worker transmitted after its shared-scale int8 round
    trip (the error-feedback residual's complement): bit-exact, masked
    workers transmit exactly 0."""
    g = _grads(1)
    kw = dict(num_aggregate=num_aggregate, mask_mode=mask_mode, compress="int8",
              quant_block_size=block)
    want_agg, want_c = _jax_aggregate(mesh, g, True, return_contribution=True, **kw)
    got_agg, got_c = tc.aggregate_gradients(_torch_tree(g), WorkerAxis(N), N,
                                            perm=_jax_perm(), flat_output=True,
                                            return_contribution=True, **kw)
    np.testing.assert_array_equal(got_agg.numpy(), want_agg)
    for a, b in zip(tree_leaves(got_c), jax.tree_util.tree_leaves(want_c)):
        np.testing.assert_array_equal(a.numpy(), b)
    # the standalone mirror gives the same contribution as the wire's own
    alone = tc.local_quantized_contribution(_torch_tree(g), WorkerAxis(N), block_size=block)
    if num_aggregate is None:
        for a, b in zip(tree_leaves(alone), tree_leaves(got_c)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("num_aggregate,mode", [(5, "first_k"), (5, "random_k"),
                                                (3, "random_k"), (None, "random_k"),
                                                (8, "first_k")])
def test_torch_aggregation_mask_matches_jax(mesh, num_aggregate, mode):
    def mask():
        return jc.aggregation_mask(WORKER_AXIS, N, num_aggregate, KEY, mode)[None]

    f = jax.jit(jax.shard_map(mask, mesh=mesh, in_specs=(), out_specs=P(WORKER_AXIS),
                              check_vma=False))
    want = np.asarray(f()).reshape(N)
    got = tc.aggregation_mask(WorkerAxis(N), N, num_aggregate, _jax_perm(), mode)
    np.testing.assert_array_equal(got.numpy(), want)
    expect = N if num_aggregate is None or num_aggregate >= N else num_aggregate
    assert float(got.sum()) == expect


@pytest.mark.parametrize("denominator", [5.0, 3.0, 7.0, 8.0])
def test_torch_division_by_the_count_is_xlas_reciprocal_multiply(mesh, denominator):
    """collectives.py:281 divides by a Python float; under jit XLA-CPU
    multiplies by the f32 reciprocal instead, and so must the port. A
    true division differs on many elements (for any count but a power
    of two), so this pins the choice."""
    rng = np.random.RandomState(3)
    x = (rng.randn(N, 20000) * np.exp(rng.randn(N, 1) * 3)).astype(np.float32)
    def divide(a):
        return a / denominator

    f = jax.jit(jax.shard_map(divide, mesh=mesh,
                              in_specs=P(WORKER_AXIS), out_specs=P(WORKER_AXIS),
                              check_vma=False))
    want = np.asarray(f(jnp.asarray(x)))
    got = (torch.from_numpy(x) * tc.reciprocal(denominator)).numpy()
    np.testing.assert_array_equal(got, want)
    true_div = (torch.from_numpy(x) / torch.tensor(denominator)).numpy()
    if denominator != 8.0:
        assert (true_div != want).sum() > 1000


@pytest.mark.parametrize("block", [0, 1, 128])
def test_torch_piece_stream_flat_geometry_matches_jax_plan(block):
    """The per-leaf wire's flat rebuild pads to the same plan as JAX's
    (plan_buckets(total, 0, align))."""
    g = _torch_tree(_grads())
    pieces, ids, rebuild = piece_stream(g, None, align=block or 1, flat_output=True)
    assert ids == tuple(range(len(pieces)))
    flat = rebuild([p[0] for p in pieces])
    total = sum(int(p[0].numel()) for p in pieces)
    assert flat.numel() == jplan(total, 0, align=block or 1).padded_total
    assert not flat[total:].any()
    tree = piece_stream(g, None)[2]([p[0] for p in pieces])
    assert [tuple(t.shape) for t in tree_leaves(tree)] == [tuple(p.shape[1:]) for p in pieces]


def test_torch_worker_axis_primitives():
    axis = make_mesh(4)
    x = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    assert axis.psum(x).dtype == torch.int32 and axis.psum(x).tolist() == [18, 22, 26]
    assert axis.pmax(x).tolist() == [9, 10, 11] and axis.pmin(x).tolist() == [0, 1, 2]
    assert axis.pmean(x.float()).tolist() == [4.5, 5.5, 6.5]
    assert axis.axis_index().tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        axis.psum(torch.zeros(3, 3))


def test_torch_collectives_refuse_unported_wires():
    """A tuple of axis names is not an axis: the hierarchical wire takes
    the hybrid grid (mesh.make_hybrid_mesh; tests/test_torch_hier.py holds
    it against JAX). The pipelined wire, refused here before its port,
    runs and gives the serial wire's values. Stochastic rounding, a device
    count and bucket peaks run too (tests/test_torch_adaptive_wire.py),
    and stochastic rounding without draws raises JAX's ValueError."""
    g = _torch_tree(_grads())
    with pytest.raises(TypeError, match="make_hybrid_mesh"):
        tc.aggregate_gradients(g, ("dcn", WORKER_AXIS), N, compress="int8_2round")
    serial = tc.aggregate_gradients(g, WorkerAxis(N), N, compress="int8", bucket_bytes=0,
                                    flat_output=True)
    assert torch.equal(serial, tc.aggregate_gradients(g, WorkerAxis(N), N, compress="int8",
                                                      bucket_bytes=0, flat_output=True,
                                                      pipelined=True))
    with pytest.raises(ValueError, match="stochastic rounding needs a key"):
        tc.quantized_psum(g, WorkerAxis(N), 8.0, rounding="stochastic")
    with pytest.raises(TypeError, match="make_hybrid_mesh"):
        tc.aggregate_gradients(g, ("dcn", WORKER_AXIS), N)
    agg = tc.aggregate_gradients(g, WorkerAxis(N), N, compress="int8", bucket_bytes=0,
                                 bucket_peaks=torch.full((1,), 127.0), flat_output=True)
    assert bool(torch.isfinite(agg).all())
    assert torch.equal(tc.aggregation_mask(WorkerAxis(N), N, torch.tensor(5), _jax_perm()),
                       tc.aggregation_mask(WorkerAxis(N), N, 5, _jax_perm()))
    with pytest.raises(ValueError, match="stochastic rounding needs a key"):
        tc.quantized_allreduce_2round(g, WorkerAxis(N), 8.0, N, rounding="stochastic")
