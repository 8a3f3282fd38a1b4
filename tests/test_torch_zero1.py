"""Port parity: the ZeRO-1 sharded placement (ps_pytorch_tpu_torch.parallel.ps:
``wire_align`` / ``_sharded_plan`` / ``_zero1_shard_size`` / ``state_plan``,
the sharded ``init_ps_state`` and ``_sharded_ps_update``) against the JAX
package.

- The geometry (plans, shard sizes, state and residual shapes) equals
  JAX's, integer for integer.
- ``_sharded_ps_update`` on identical gradients, inside ``shard_map`` on
  the 8-device CPU mesh under ``jax.jit``: params and the per-worker
  momentum shards are bit-exact after one update, on the int8 and
  two-round wires, both wire domains, per-tensor and block-128 scales,
  fused and 64 KiB buckets, with and without a random_k mask. The EF
  residual rows agree within one f32 ulp of the sent gradient: XLA-CPU
  contracts ``g - q * scale`` into an FMA, the port rounds twice. What
  each worker transmits (the contribution) is bit-exact per bucket
  (``_shard_reduce_bucket``).
- A LeNet 3-step trajectory of the sharded two-round wire with EF, within
  tests/test_torch_ps.py's stated tolerance of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.models import build_model as jbuild
from ps_pytorch_tpu.optim import sgd_flat as jsgd_flat
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu.parallel import init_ps_state as jinit_state
from ps_pytorch_tpu.parallel import ps as jps
from ps_pytorch_tpu.parallel import shard_batch
from ps_pytorch_tpu.parallel.buckets import to_flat_vector as jto_flat_vector
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import ps as tps
from ps_pytorch_tpu_torch.parallel.buckets import (
    pad_flat,
    to_flat_vector,
    tree_leaves,
    tree_to_flat,
)
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_ps import KEY as STEP_KEY
from tests.test_torch_ps import LR, MOMENTUM, _batches, _check, _jax_perm, _pair
from tests.test_torch_wires import jax_perm, torch_tree, wide_grads


N = 8
KEY = jax.random.key(42)  # the mask key of tests/test_torch_wires.py


WIRES = [dict(), dict(compress="int8"), dict(compress="int8", quant_block_size=128),
         dict(compress="int8_2round"), dict(compress="int8_2round", quant_block_size=128)]


@pytest.mark.parametrize("bucket_bytes", [None, 0, 65536])
@pytest.mark.parametrize("wire", WIRES)
def test_torch_zero1_geometry_matches_jax(wire, bucket_bytes):
    kw = dict(opt_placement="sharded", bucket_bytes=bucket_bytes, **wire)
    j, t = JPSConfig(num_workers=N, **kw), PSConfig_(kw)
    assert tps.wire_align(t) == jps.wire_align(j)
    for total in (431080, 62006, 40785, 1):
        tp, jp = tps.state_plan(t, total), jps.state_plan(j, total)
        assert (tp.padded_total, tp.align, tp.starts, tp.sizes) == (
            jp.padded_total, jp.align, jp.starts, jp.sizes)
        assert tps._zero1_shard_size(total, t) == jps._zero1_shard_size(total, j)


def PSConfig_(kw):
    return tps.PSConfig(num_workers=N, **kw)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("compress,block", [("int8", 0), ("int8_2round", 128)])
def test_torch_zero1_init_state_matches_jax(compress, block, ef):
    kw = dict(opt_placement="sharded", compress=compress, quant_block_size=block,
              error_feedback=ef)
    js = jinit_state(jbuild("LeNet"), jsgd_flat(LR, momentum=MOMENTUM),
                     JPSConfig(num_workers=N, **kw), jax.random.key(0), (28, 28, 1))
    ts = tps.init_ps_state(build_model("LeNet"), build_optimizer("sgd", LR, momentum=MOMENTUM),
                           PSConfig_(kw), torch.Generator().manual_seed(0), device="cpu")
    assert tuple(ts.params.flat.shape) == js.params.flat.shape
    assert tuple(ts.opt_state.momentum_buffer.shape) == js.opt_state.momentum_buffer.shape
    assert not ts.opt_state.momentum_buffer.any()
    if ef:
        assert tuple(ts.comm_state.shape) == js.comm_state.shape
        assert not ts.comm_state.any()
    else:
        assert ts.comm_state is None and js.comm_state is None


def _params_tree(seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (rng.randn(*a.shape[1:]) * 0.1).astype(np.float32),
                        wide_grads(0))


def _jax_sharded_updates(mesh, jcfg, params, grads_seq, ef):
    """Two ZeRO-1 updates in JAX, each inside shard_map under jit."""
    jtx = jsgd_flat(LR, momentum=MOMENTUM)
    total = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(params))
    plan = jps.state_plan(jcfg, total)
    shard = plan.padded_total // N
    p = jto_flat_vector(jax.tree.map(jnp.asarray, params), plan)
    opt = jax.tree.map(lambda a: jnp.broadcast_to(a, (N,) + a.shape),
                       jtx.init(jnp.zeros((shard,), jnp.float32)))
    err = jnp.zeros((N, plan.padded_total), jnp.float32)

    def fn(p, opt, g, err):
        opt = jax.tree.map(lambda a: a[0], opt)
        g = jax.tree.map(lambda a: a[0], g)
        new_p, new_opt, new_err = jps._sharded_ps_update(
            p, opt, g, jtx, jcfg, KEY, err=err[0] if ef else None)
        if new_err is None:
            new_err = err[0]
        return new_p, jax.tree.map(lambda a: a[None], new_opt), new_err[None]

    f = jax.jit(jax.shard_map(fn, mesh=mesh,
                              in_specs=(P(), P(WORKER_AXIS), P(WORKER_AXIS), P(WORKER_AXIS)),
                              out_specs=(P(), P(WORKER_AXIS), P(WORKER_AXIS)),
                              check_vma=False))
    out = []
    for g in grads_seq:
        p, opt, err = f(p, opt, jax.tree.map(jnp.asarray, g), err)
        out.append((np.asarray(p.flat), np.asarray(opt.momentum_buffer), np.asarray(err)))
    return out


@pytest.mark.parametrize("num_aggregate", [None, 5])
@pytest.mark.parametrize("bucket_bytes", [0, 65536])
@pytest.mark.parametrize("block", [0, 128])
@pytest.mark.parametrize("domain", ["dequant", "homomorphic"])
@pytest.mark.parametrize("compress", ["int8", "int8_2round"])
def test_torch_sharded_ps_update_matches_jax(mesh, compress, domain, block, bucket_bytes,
                                             num_aggregate):
    ef = num_aggregate is not None  # EF where the mask leaves residuals
    kw = dict(opt_placement="sharded", compress=compress, wire_domain=domain,
              quant_block_size=block, bucket_bytes=bucket_bytes, error_feedback=ef,
              num_aggregate=num_aggregate)
    jcfg, tcfg = JPSConfig(num_workers=N, **kw), PSConfig_(kw)
    params = _params_tree()
    grads_seq = [wide_grads(10), wide_grads(11)]
    want = _jax_sharded_updates(mesh, jcfg, params, grads_seq, ef)

    ttx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    total = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(params))
    plan = tps.state_plan(tcfg, total)
    p = to_flat_vector(torch_tree(params), plan)
    opt = ttx.init(torch.zeros((N, plan.padded_total // N)))
    err = torch.zeros((N, plan.padded_total)) if ef else None
    axis = WorkerAxis(N)
    sel = (tps.aggregation_mask(axis, N, num_aggregate, jax_perm(), "random_k")
           if num_aggregate else None)
    for i, (g, (wp, wbuf, werr)) in enumerate(zip(grads_seq, want)):
        g = torch_tree(g)
        sent = pad_flat(tree_to_flat(g, stacked=True), plan) + (err if ef else 0.0)
        p, opt, err = tps._sharded_ps_update(p, opt, g, ttx, tcfg, axis, sel=sel, err=err)
        if i:
            # later steps differ in the last bits: XLA-CPU contracts the
            # momentum update's a*b + c and the residual's g - q*scale into
            # FMAs, which the port rounds twice (the LeNet trajectory below
            # holds several steps to tests/test_torch_ps.py's tolerance)
            continue
        np.testing.assert_array_equal(p.flat.numpy(), wp)
        np.testing.assert_array_equal(opt.momentum_buffer.numpy(), wbuf)
        if ef:
            # XLA-CPU contracts the residual g - q * scale into one FMA;
            # the port rounds the product q * scale (~ g) first, so the two
            # differ by at most one ulp of g (the contribution itself is
            # bit-exact: test_torch_shard_reduce_bucket_matches_jax)
            gap = np.abs(err.numpy() - werr)
            assert (gap <= np.spacing(np.abs(sent.numpy()))).all(), gap.max()
    assert int(opt.count) == 2


def _jax_shard_reduce(bucket, jcfg, mesh):
    size = bucket.shape[1]

    def fn(b):
        w = jax.lax.axis_index(WORKER_AXIS)
        g, c = jps._shard_reduce_bucket(b[0], size, WORKER_AXIS, N, w,
                                        jcfg.effective_aggregate, jcfg, None,
                                        want_contrib=True)
        return g[None], c[None]

    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(WORKER_AXIS),
                              out_specs=(P(WORKER_AXIS), P(WORKER_AXIS)), check_vma=False))
    return [np.asarray(v) for v in f(jnp.asarray(bucket))]


@pytest.mark.parametrize("num_aggregate", [None, 5])
@pytest.mark.parametrize("block", [0, 128])
@pytest.mark.parametrize("domain", ["dequant", "homomorphic"])
@pytest.mark.parametrize("compress", ["int8", "int8_2round"])
def test_torch_shard_reduce_bucket_matches_jax(mesh, compress, domain, block, num_aggregate):
    """One bucket of the ZeRO-1 wire: every worker's reduced shard and
    its transmitted value (the EF contribution), bit-exact; a masked-out
    worker (its bucket zeroed, as the mask leaves it) transmits 0."""
    kw = dict(opt_placement="sharded", compress=compress, wire_domain=domain,
              quant_block_size=block, num_aggregate=num_aggregate)
    jcfg, tcfg = JPSConfig(num_workers=N, **kw), PSConfig_(kw)
    size = N * 128 * 5
    rng = np.random.RandomState(block + len(compress))
    bucket = (rng.randn(N, size) * np.exp(rng.randn(N, 1) * 2)).astype(np.float32)
    if num_aggregate:
        bucket[[0, 3, 6]] = 0.0
    want_g, want_c = _jax_shard_reduce(bucket, jcfg, mesh)
    got_g, got_c = tps._shard_reduce_bucket(torch.from_numpy(bucket), size, WorkerAxis(N), N,
                                            tcfg.effective_aggregate, tcfg, want_contrib=True)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    if num_aggregate:
        assert not got_c[[0, 3, 6]].any()


def test_torch_sharded_tree_layout_equals_flat():
    """state_layout="tree" under ZeRO-1 takes the same update as "flat"."""
    kw = dict(opt_placement="sharded", compress="int8_2round", quant_block_size=128)
    params = torch_tree(_params_tree(1))
    g = torch_tree(wide_grads(12))
    ttx = build_optimizer("sgd", LR, momentum=MOMENTUM)
    axis = WorkerAxis(N)
    outs = {}
    for layout in ("flat", "tree"):
        cfg = PSConfig_(dict(kw, state_layout=layout))
        total = sum(int(a.numel()) for a in tree_leaves(params))
        plan = tps.state_plan(cfg, total)
        p = to_flat_vector(params, plan) if layout == "flat" else params
        opt = ttx.init(torch.zeros((N, plan.padded_total // N)))
        p, _, _ = tps._sharded_ps_update(p, opt, g, ttx, cfg, axis)
        outs[layout] = p.flat[:total] if layout == "flat" else torch.cat(
            [a.reshape(-1) for a in tree_leaves(p)])
    assert torch.equal(outs["flat"], outs["tree"])


def test_torch_zero1_lenet_trajectory_matches_jax(mesh):
    """Sharded int8_2round with EF and random_k (5 of 8), 3 steps."""
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, dict(
        opt_placement="sharded", compress="int8_2round", error_feedback=True,
        num_aggregate=5))
    for i, batch in enumerate(_batches(3)):
        js, jm = jstep(js, shard_batch(batch, mesh, jcfg), STEP_KEY)
        ts, tm = tstep(ts, batch, tps.StepDraws(perm=_jax_perm(i)))
        _check(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, "int8", i == 0)
        assert float(tm["skipped_steps"]) == 0.0
    assert tuple(ts.comm_state.shape) == js.comm_state.shape
    assert tuple(ts.opt_state.momentum_buffer.shape) == js.opt_state.momentum_buffer.shape
