"""Port parity: the bucketed piece stream and the dequant-domain wires
(ps_pytorch_tpu_torch.parallel.buckets.piece_stream,
collectives.quantized_psum / quantized_allreduce_2round) against the JAX
package on the 8-device CPU mesh.

The same numpy per-worker gradients go through JAX's
``aggregate_gradients`` inside ``shard_map`` (called under ``jax.jit``,
as the train step calls it) and through the port's stacked version. The
tree holds odd and all-zero leaves and one wide leaf, so a 65536-byte
bucket plan cuts it into several buckets. Pins, all bit-exact:

- the bucket plans, pieces, key ids and the three rebuilds (tree, flat,
  bucket list) for bucket_bytes 0 / 4096 / 65536 and align 1 / 128;
- the int8 wire and the two-round wire (per-tensor and block-128 scales,
  per-leaf / fused / 64 KiB buckets, every mask): the aggregate, in its
  tree and its flat form, and the error-feedback contribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu.parallel import collectives as jc
from ps_pytorch_tpu.parallel.buckets import piece_stream as jpiece_stream
from ps_pytorch_tpu.parallel.buckets import plan_buckets as jplan
from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel.buckets import piece_stream, tree_leaves
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from tests.test_torch_one_thread import _one_thread  # noqa: F401


N = 8
KEY = jax.random.key(42)


def wide_grads(seed=0):
    """Per-worker gradient tree, worker-stacked: magnitudes vary by
    worker and leaf (the shared absmax comes from different workers), an
    odd leaf, an all-zero leaf and a 40100-element leaf (three 64 KiB
    buckets)."""
    rng = np.random.RandomState(seed)
    scale = np.exp(rng.randn(N, 1) * 2).astype(np.float32)

    def leaf(*shape):
        x = rng.randn(N, *shape).astype(np.float32)
        return x * scale.reshape((N,) + (1,) * len(shape))

    return {
        "Conv_0": {"kernel": leaf(3, 3, 2, 5), "bias": leaf(5)},
        "Dense_0": {"kernel": leaf(40, 7)},
        "odd": leaf(301),
        "wide": leaf(100, 401),
        "zero": np.zeros((N, 9), np.float32),
    }


def torch_tree(g):
    return {k: torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in g.items()}


def jax_perm():
    return torch.from_numpy(np.asarray(jax.random.permutation(KEY, N)).astype(np.int64))


def jax_wire(mesh, grads, **kw):
    """JAX's aggregate (flat and tree) and EF contribution in one
    compiled shard_map."""
    def fn(g):
        g = jax.tree.map(lambda a: a[0], g)
        agg_flat, contrib = jc.aggregate_gradients(
            g, WORKER_AXIS, N, mask_key=KEY, flat_output=True,
            return_contribution=True, **kw)
        agg_tree = jc.aggregate_gradients(g, WORKER_AXIS, N, mask_key=KEY, **kw)
        return agg_flat, agg_tree, jax.tree.map(lambda a: a[None], contrib)

    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(WORKER_AXIS),
                              out_specs=(P(), P(), P(WORKER_AXIS)), check_vma=False))
    return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, grads)))


def check_wire_matches_jax(mesh, grads, **kw):
    """Every output of the port's wire bit-equal to JAX's."""
    want_flat, want_tree, want_c = jax_wire(mesh, grads, **kw)
    tg = torch_tree(grads)
    axis = WorkerAxis(N)
    got_flat, got_c = tc.aggregate_gradients(tg, axis, N, perm=jax_perm(), flat_output=True,
                                             return_contribution=True, **kw)
    got_tree = tc.aggregate_gradients(tg, axis, N, perm=jax_perm(), **kw)
    np.testing.assert_array_equal(got_flat.numpy(), want_flat)
    for a, b in zip(tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tree_leaves(got_c), jax.tree_util.tree_leaves(want_c)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


MASKS = [(None, "random_k"), (5, "first_k"), (5, "random_k")]
BUCKETS = [None, 0, 65536]


@pytest.mark.parametrize("bucket_bytes", BUCKETS)
@pytest.mark.parametrize("num_aggregate,mask_mode", MASKS)
@pytest.mark.parametrize("block", [0, 128])
def test_torch_int8_dequant_wire_matches_jax(mesh, block, num_aggregate, mask_mode,
                                             bucket_bytes):
    check_wire_matches_jax(mesh, wide_grads(1), compress="int8", quant_block_size=block,
                           num_aggregate=num_aggregate, mask_mode=mask_mode,
                           bucket_bytes=bucket_bytes)


@pytest.mark.parametrize("bucket_bytes", BUCKETS)
@pytest.mark.parametrize("num_aggregate,mask_mode", MASKS)
@pytest.mark.parametrize("block", [0, 128])
def test_torch_2round_dequant_wire_matches_jax(mesh, block, num_aggregate, mask_mode,
                                               bucket_bytes):
    check_wire_matches_jax(mesh, wide_grads(2), compress="int8_2round",
                           quant_block_size=block, num_aggregate=num_aggregate,
                           mask_mode=mask_mode, bucket_bytes=bucket_bytes)


@pytest.mark.parametrize("align", [1, 128])
@pytest.mark.parametrize("bucket_bytes", [0, 4096, 65536])
def test_torch_bucketed_piece_stream_matches_jax(bucket_bytes, align):
    """Plans, pieces (row w == JAX's piece on worker w's tree), key ids
    and the tree / flat / bucket-list rebuilds, integer for integer."""
    g = wide_grads(3)
    tg = torch_tree(g)
    pieces, ids, rebuild = piece_stream(tg, bucket_bytes, align=align)
    per_worker = [jax.tree.map(lambda a, w=w: jnp.asarray(a[w]), g) for w in range(N)]
    jp0, jids, jrebuild = jpiece_stream(per_worker[0], bucket_bytes, align=align)
    assert ids == tuple(jids)
    total = sum(int(np.prod(a.shape[1:])) for a in jax.tree_util.tree_leaves(g))
    plan = jplan(total, bucket_bytes, align=align)
    assert ids == plan.starts
    assert [int(p.shape[1]) for p in pieces] == list(plan.sizes)
    for w in range(N):
        jpieces = jpiece_stream(per_worker[w], bucket_bytes, align=align)[0]
        assert len(jpieces) == len(pieces)
        for p, jp in zip(pieces, jpieces):
            np.testing.assert_array_equal(p[w].numpy(), np.asarray(jp))
    outs = [p[5] for p in pieces]  # results without the worker dimension
    want_tree = jrebuild([jnp.asarray(o.numpy()) for o in outs])
    for a, b in zip(tree_leaves(rebuild(outs)), jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, _, jflat = jpiece_stream(per_worker[0], bucket_bytes, align=align, flat_output=True)
    _, _, tflat = piece_stream(tg, bucket_bytes, align=align, flat_output=True)
    np.testing.assert_array_equal(tflat(outs).numpy(),
                                  np.asarray(jflat([jnp.asarray(o.numpy()) for o in outs])))
    _, _, tlist = piece_stream(tg, bucket_bytes, align=align, bucket_output=True)
    assert [tuple(b.shape) for b in tlist(outs)] == [(s,) for s in plan.sizes]
    # worker-stacked results rebuild worker-stacked: the stream round-trips
    for a, b in zip(tree_leaves(rebuild(pieces)), tree_leaves(tg)):
        assert torch.equal(a, b)


def test_torch_bucketed_error_feedback_mirror_equals_the_wire():
    """local_quantized_contribution on a bucketed, block-aligned stream
    gives exactly the contribution the int8 and 2round wires return."""
    tg = torch_tree(wide_grads(4))
    axis = WorkerAxis(N)
    alone = tc.local_quantized_contribution(tg, axis, block_size=128, bucket_bytes=65536)
    for compress in ("int8", "int8_2round"):
        _, c = tc.aggregate_gradients(tg, axis, N, compress=compress, quant_block_size=128,
                                      bucket_bytes=65536, return_contribution=True)
        for a, b in zip(tree_leaves(alone), tree_leaves(c)):
            assert torch.equal(a, b)
