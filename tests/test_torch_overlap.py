"""The pipelined bucket wire of the port (``--overlap on``:
ps_pytorch_tpu_torch.parallel.buckets / collectives / overlap / ps)
against the JAX package's (tests/test_overlap.py), on the CPU:

- ``bucket_leaf_segments`` / ``assemble_bucket`` / ``leaves_from_buckets``
  / ``readiness_bucket_order`` and the pipelined ``piece_stream`` equal
  JAX's on the same tree, bit for bit (a pure reorder of the serial
  stream);
- the hooks fire in readiness order: the step's bucket stream dispatches
  each bucket when its last leaf's gradient exists, in the order
  ``readiness_bucket_order`` gives for the ranks ``grad_leaf_readiness``
  measures, on LeNet, a narrow ResNet and a narrow VGG;
- the pipelined wire (``aggregate_gradients(pipelined=True)``, and the
  ``pipelined=`` keyword of psum_mean, quantized_psum and the two-round
  wire) is bit for bit the serial wire and JAX's pipelined wire on the
  same gradients;
- the pipelined step is bit for bit the port's serial step on the
  uncompressed, int8 (dequant and homomorphic, EF), two-round (dequant,
  homomorphic + EF), ZeRO-1 and tree-layout wires, its guard rollback
  too, and with the adaptive count; and within tests/test_torch_ps.py's
  tolerances of JAX's pipelined step, with a traced count too (the conv
  gradients differ in their last bits);
- the config's validation and the CLI flag.

LeNet, N=8 (4 for the port-only pins), 2 steps.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.parallel import WORKER_AXIS, shard_batch
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.parallel import buckets as jb
from ps_pytorch_tpu.parallel import collectives as jc
from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
from ps_pytorch_tpu_torch.models import apply_model, build_model, draw_dropout, init_model
from ps_pytorch_tpu_torch.ops.metrics import cross_entropy_loss
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import buckets as tb
from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel import ps as tps
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from ps_pytorch_tpu_torch.parallel.overlap import grad_leaf_readiness
from ps_pytorch_tpu_torch.parallel.ps import PSConfig, StepDraws, init_ps_state, make_ps_train_step
from ps_pytorch_tpu_torch.resilience.faults import FaultPlan
from ps_pytorch_tpu_torch.utils.serialization import to_state_dict
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_ps import KEY, _batches, _check, _jax_perm, _pair
from tests.test_torch_wires import N, torch_tree, wide_grads


def _rand_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(37, 5).astype(np.float32), "b": rng.randn(3).astype(np.float32),
            "c": {"d": rng.randn(101).astype(np.float32), "e": np.zeros((0,), np.float32),
                  "f": rng.randn(64).astype(np.float32)}}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_torch_bucket_geometry_matches_jax():
    tree = _rand_tree(1)
    jlay, tlay = jb.tree_layout(tree), tb.tree_layout(_t(tree))
    for bb, align in [(256, 16), (128, 8), (40, 1)]:
        jplan, tplan = jb.plan_buckets(jlay.total, bb, align), tb.plan_buckets(tlay.total, bb,
                                                                                align)
        assert tb.bucket_leaf_segments(tlay, tplan) == jb.bucket_leaf_segments(jlay, jplan)
        assert tb.readiness_bucket_order(tplan) == jb.readiness_bucket_order(jplan)
        rank = tuple(np.random.RandomState(bb).permutation(len(tlay.shapes)).tolist())
        assert (tb.readiness_bucket_order(tplan, tlay, rank)
                == jb.readiness_bucket_order(jplan, jlay, rank))
        segs = tb.bucket_leaf_segments(tlay, tplan)
        jleaves = jax.tree_util.tree_leaves(tree)
        tleaves = tb.tree_leaves(_t(tree))
        # stacked: each worker's row is its own tree's bucket
        stacked = [torch.stack([x, 2 * x]) for x in tleaves]
        got = [tb.assemble_bucket(tleaves, s) for s in segs]
        for b, s in enumerate(segs):
            _eq(got[b], jb.assemble_bucket(jleaves, jb.bucket_leaf_segments(jlay, jplan)[b]))
            _eq(tb.assemble_bucket(stacked, s, stacked=True)[1], 2 * got[b])
        back = tb.leaves_from_buckets(tlay, tplan, got)
        for x, y in zip(tb.tree_leaves(back), tleaves):
            _eq(x, y)


def test_torch_pipelined_piece_stream_is_a_pure_reorder_like_jax():
    g = wide_grads(3)
    tg = torch_tree(g)
    s_pieces, s_ids, _ = tb.piece_stream(tg, 65536, align=128)
    p_pieces, p_ids, p_rebuild = tb.piece_stream(tg, 65536, align=128, pipelined=True)
    j0 = jax.tree.map(lambda a: a[0], g)
    jp, jids, _ = jb.piece_stream(j0, 65536, align=128, pipelined=True)
    assert p_ids == tuple(jids)
    order = tb.readiness_bucket_order(tb.plan_buckets(tb.tree_layout(tg, stacked=True).total,
                                                      65536, 128))
    assert p_ids == tuple(s_ids[b] for b in order)
    for pos, b in enumerate(order):
        _eq(p_pieces[pos], s_pieces[b])
        _eq(p_pieces[pos][0], jp[pos])
    for x, y in zip(tb.tree_leaves(p_rebuild(p_pieces)), tb.tree_leaves(tg)):
        _eq(x, y)
    canon = tb.piece_stream(tg, 65536, align=128, pipelined=True, bucket_output=True)[2](p_pieces)
    for b in range(len(s_pieces)):
        _eq(canon[b], s_pieces[b])
    with pytest.raises(ValueError, match="bucket_output"):
        tb.piece_stream(tg, None, bucket_output=True)


# ---------------------------------------------------------- readiness hooks

def _narrow(name):
    if name == "ResNet":
        from ps_pytorch_tpu_torch.models import BasicBlock, ResNet

        return ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1)), (1, 32, 32, 3)
    if name == "VGG":
        from ps_pytorch_tpu_torch.models.vgg import VGG

        return VGG(cfg=(8, "M", 16, "M"), batch_norm=True), (4, 32, 32, 3)
    return build_model("LeNet"), (4, 28, 28, 1)


@pytest.mark.parametrize("name", ["LeNet", "ResNet", "VGG"])
def test_torch_hooks_dispatch_buckets_in_readiness_order(name):
    model, shape = _narrow(name)
    params, bs = init_model(model, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(shape, generator=g), torch.randint(0, 10, (shape[0],), generator=g)
    masks = (draw_dropout(model, shape[0], torch.Generator().manual_seed(2))
             if getattr(model, "draw_dropout", None) is not None else None)

    def loss(p):
        return cross_entropy_loss(apply_model(model, p, bs, x, train=True, dropout=masks)[0], y)

    ranks = grad_leaf_readiness(loss, params)
    layout = tb.tree_layout(params)
    plan = tb.plan_buckets(layout.total, 4096, 1)
    assert plan.n_buckets > 2
    # the stream the pipelined step builds, driven by the same hooks
    stream = tps._BucketStream(layout, plan, lambda b, piece: (piece.sum(),))
    leaves, skel = tb.tree_flatten(params)
    inputs = [leaf.detach().requires_grad_(True) for leaf in leaves]
    for i, leaf in enumerate(inputs):
        leaf.register_hook(lambda t, i=i: stream.leaf_ready(i, t[None]))
    with torch.enable_grad():
        torch.autograd.grad(loss(tb.tree_unflatten(skel, inputs)), inputs)
    stream.finish()
    assert tuple(stream.order) == tb.readiness_bucket_order(plan, layout, ranks)
    assert sorted(stream.order) == list(range(plan.n_buckets))


# ------------------------------------------------------------ the wire alone

WIRES = [dict(compress="int8", quant_block_size=128, bucket_bytes=65536),
         dict(compress="int8_2round", bucket_bytes=65536, wire_domain="homomorphic"),
         dict(compress="int8_2round", quant_block_size=128, bucket_bytes=65536),
         dict(bucket_bytes=65536)]


@pytest.mark.parametrize("kw", WIRES, ids=["int8_b128", "2round_hom", "2round_b128", "none"])
def test_torch_pipelined_wire_matches_jax_pipelined_wire(mesh, kw):
    grads = wide_grads(5)

    def fn(g):
        g = jax.tree.map(lambda a: a[0], g)
        agg, contrib = jc.aggregate_gradients(g, WORKER_AXIS, N, num_aggregate=5, mask_key=KEY,
                                              flat_output=True, return_contribution=True,
                                              pipelined=True, **kw)
        return agg, jax.tree.map(lambda a: a[None], contrib)

    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(WORKER_AXIS),
                              out_specs=(P(), P(WORKER_AXIS)), check_vma=False))
    want_agg, want_c = jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, grads)))
    perm = torch.from_numpy(np.asarray(jax.random.permutation(KEY, N)).astype(np.int64))
    got_agg, got_c = tc.aggregate_gradients(torch_tree(grads), WorkerAxis(N), N,
                                            num_aggregate=5, perm=perm, flat_output=True,
                                            return_contribution=True, pipelined=True, **kw)
    if kw.get("compress"):
        _eq(got_agg, want_agg)
    else:  # the f32 sum over workers: XLA's order and torch's, within 2 ulps
        assert np.abs(got_agg.numpy() - want_agg).max() <= 2 * np.spacing(np.abs(want_agg).max())
    for a, b in zip(tb.tree_leaves(got_c), jax.tree_util.tree_leaves(want_c)):
        _eq(a, b)


FUNCTION_WIRES = {
    "psum_mean": (lambda t, a, **k: tc.psum_mean(t, a, 5.0, **k),
                  lambda t, a, **k: jc.psum_mean(t, a, 5.0, **k)),
    "quantized_psum_b128": (
        lambda t, a, **k: tc.quantized_psum(t, a, 5.0, block_size=128, **k),
        lambda t, a, **k: jc.quantized_psum(t, a, 5.0, block_size=128, **k)),
    "2round_homomorphic": (
        lambda t, a, **k: tc.quantized_allreduce_2round(t, a, 5.0, N, wire_domain="homomorphic",
                                                        **k),
        lambda t, a, **k: jc.quantized_allreduce_2round(t, a, 5.0, N, wire_domain="homomorphic",
                                                        **k)),
}


@pytest.mark.parametrize("name", sorted(FUNCTION_WIRES))
def test_torch_pipelined_keyword_of_each_wire_matches_serial_and_jax(mesh, name):
    """``pipelined=`` on psum_mean, quantized_psum and the two-round wire
    (the one pipelined implementation, ``_bucket_reduce``): bit for bit
    the serial wire, and JAX's pipelined wire (the f32 sum within 2 ulps
    of XLA's order)."""
    tfn, jfn = FUNCTION_WIRES[name]
    grads = wide_grads(6)
    wire = dict(bucket_bytes=65536, flat_output=True)
    f = jax.jit(jax.shard_map(
        lambda g: jfn(jax.tree.map(lambda a: a[0], g), WORKER_AXIS, pipelined=True, **wire),
        mesh=mesh, in_specs=P(WORKER_AXIS), out_specs=P(), check_vma=False))
    want = np.asarray(f(jax.tree.map(jnp.asarray, grads)))
    got = tfn(torch_tree(grads), WorkerAxis(N), pipelined=True, **wire)
    _eq(got, tfn(torch_tree(grads), WorkerAxis(N), **wire))
    if name == "psum_mean":
        assert np.abs(got.numpy() - want).max() <= 2 * np.spacing(np.abs(want).max())
    else:
        _eq(got, want)


# ------------------------------------------------------------ the step

def _run(kw, steps=2, faults=None, agg_count=None, n=4):
    cfg = PSConfig(num_workers=n, **kw)
    model = build_model("LeNet")
    tx = build_optimizer("sgd", 0.05, momentum=0.9)
    st = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_ps_train_step(model, tx, cfg, device="cpu", faults=faults)
    m = None
    for i, batch in enumerate(_batches(steps, seed=2)):
        extra = {} if agg_count is None else {"agg_count": torch.tensor(agg_count)}
        st, m = step(st, {k: v[:n * 4] for k, v in batch.items()}, **extra)
    return to_state_dict(st), {k: float(v) for k, v in m.items()}


def _bits_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8))


STEP_WIRES = {
    "none_flat": dict(bucket_bytes=4096),
    "int8_ef": dict(compress="int8", quant_block_size=64, error_feedback=True, bucket_bytes=4096),
    "int8_homomorphic_ef": dict(compress="int8", quant_block_size=64, error_feedback=True,
                                bucket_bytes=4096, wire_domain="homomorphic"),
    "2round": dict(compress="int8_2round", quant_block_size=32, bucket_bytes=8192),
    "2round_homomorphic_ef": dict(compress="int8_2round", bucket_bytes=8192,
                                  error_feedback=True, wire_domain="homomorphic"),
    "zero1_int8_ef": dict(opt_placement="sharded", compress="int8", quant_block_size=64,
                          error_feedback=True, bucket_bytes=4096),
    "zero1_none": dict(opt_placement="sharded", bucket_bytes=4096),
    "tree_int8": dict(state_layout="tree", compress="int8", quant_block_size=64,
                      bucket_bytes=4096),
    "static_mask": dict(num_aggregate=3, mask_mode="first_k", bucket_bytes=4096),
}


@pytest.mark.parametrize("name", sorted(STEP_WIRES))
def test_torch_pipelined_step_bit_for_bit_serial(name):
    s, ms = _run(dict(STEP_WIRES[name], overlap="serial"))
    p, mp = _run(dict(STEP_WIRES[name], overlap="pipelined"))
    _bits_equal(s, p)
    assert ms["loss"] == mp["loss"]


def test_torch_pipelined_guard_rollback_bit_for_bit():
    kw = dict(compress="int8", quant_block_size=64, error_feedback=True, bucket_bytes=4096)
    s, ms = _run(dict(kw, overlap="serial"), steps=3, faults=FaultPlan(nan_grads=(2,)))
    p, mp = _run(dict(kw, overlap="pipelined"), steps=3, faults=FaultPlan(nan_grads=(2,)))
    _bits_equal(s, p)
    assert mp["skipped_steps"] == 1.0


def test_torch_pipelined_adaptive_count_within_jax_envelope(mesh):
    """The traced count rides the pipelined stream: bit for bit the
    port's serial step (the same ops on the same device count; JAX's
    schedules differ by an ulp only through XLA's spelling of the
    division), and within the PS parity rule of JAX's pipelined step
    with its traced count on the int8 wire with EF."""
    kw = dict(num_aggregate_min=2, num_aggregate_max=4, mask_mode="first_k", bucket_bytes=4096)
    s, ms = _run(dict(kw, overlap="serial"), agg_count=3)
    p, mp = _run(dict(kw, overlap="pipelined"), agg_count=3)
    _bits_equal(s, p)
    assert ms["loss"] == mp["loss"]
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, dict(
        compress="int8", quant_block_size=64, error_feedback=True, num_aggregate_min=2,
        num_aggregate_max=N, mask_mode="first_k", bucket_bytes=65536, overlap="pipelined"))
    for i, batch in enumerate(_batches(2, seed=1)):
        js, jm = jstep(js, shard_batch(batch, mesh, jcfg), KEY, jnp.int32(3))
        ts, tm = tstep(ts, batch, StepDraws(perm=_jax_perm(i)),
                       agg_count=torch.tensor(3, dtype=torch.int32))
        _check(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, "int8", i == 0)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-4 * abs(float(jm["loss"]))


def test_torch_pipelined_step_matches_jax_pipelined_step(mesh):
    kw = dict(compress="int8", quant_block_size=64, error_feedback=True, bucket_bytes=65536,
              overlap="pipelined", num_aggregate=5)
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, kw)
    for i, batch in enumerate(_batches(2, seed=1)):
        js, jm = jstep(js, shard_batch(batch, mesh, jcfg), KEY)
        ts, tm = tstep(ts, batch, StepDraws(perm=_jax_perm(i)))
        _check(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, "int8", i == 0)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-4 * abs(float(jm["loss"]))


def test_torch_overlap_config_validation_and_cli_flag():
    with pytest.raises(ValueError, match="overlap"):
        PSConfig(num_workers=N, overlap="sometimes")
    with pytest.raises(ValueError, match="bucketed wire"):
        PSConfig(num_workers=N, overlap="pipelined")
    for kw in (dict(opt_placement="sharded"), dict(bucket_bytes=0)):
        assert PSConfig(num_workers=N, overlap="pipelined", **kw).overlap == "pipelined"
        JPSConfig(num_workers=N, overlap="pipelined", **kw)
    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    cfg = ps_config_from(parser.parse_args(["--overlap", "on", "--bucket-bytes", "4096"]), N)
    assert (cfg.overlap, cfg.bucket_bytes) == ("pipelined", 4096)
