"""pscheck on the port, the walker (ps_pytorch_tpu_torch/check/walker.py):
the recorded step's collectives with their axes, dtype and per-device
bytes, beside what JAX's jaxpr walker finds for the same step
(tests/test_check.py:52-126); mixed dtypes split; ``feeds_params``
telling the gradient psum from the metrics psum; the liveness pass
staying conservative through views and in-place writes; a recorded step
giving the bits of an unrecorded one; the tape keeping no tensor alive.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import ps_pytorch_tpu  # noqa: F401  (installs the jax.shard_map alias)
from ps_pytorch_tpu.check import collect_collectives as jcollect
from ps_pytorch_tpu.parallel.mesh import WORKER_AXIS as JWORKER_AXIS
from ps_pytorch_tpu_torch.check import walker
from ps_pytorch_tpu_torch.check.axes import RecordingWorkerAxis
from ps_pytorch_tpu_torch.check.contracts import _ps_spec
from ps_pytorch_tpu_torch.parallel.mesh import WORKER_AXIS
from tests.test_torch_one_thread import _one_thread  # noqa: F401

N = 8


def _jax_rows(f, in_specs, out_specs, *shapes, params=None):
    mesh = Mesh(np.array(jax.devices()[:N]), (JWORKER_AXIS,))
    mapped = jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                           check_vma=False)
    closed = jax.make_jaxpr(jax.jit(mapped))(*shapes)
    return sorted((c.kind, c.axes, c.dtype, c.bytes, c.feeds_params)
                  for c in jcollect(closed, param_out_indices=params))


def _rows(tape, params=None):
    return sorted((c.kind, c.axes, c.dtype, c.bytes, c.feeds_params)
                  for c in walker.collect_collectives(tape, params))


def test_torch_walker_finds_collectives_with_axes_dtype_bytes():
    """A psum of a worker-stacked f32 [8, 4] and a tiled all_gather of
    its int8 cast: per-device bytes 16 and 4, as JAX's walker counts the
    same shard_map step's equations."""
    ax = RecordingWorkerAxis(N)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((N, 4)).astype(np.float32))

    def step(x):
        return ax.psum(x), ax.all_gather(x.to(torch.int8).reshape(N, 1, 4))

    tape, _ = walker.record_step(step, x, devices=N)

    def f(x):
        return (lax.psum(x, JWORKER_AXIS),
                lax.all_gather(x.astype(jnp.int8), JWORKER_AXIS, tiled=True))

    want = _jax_rows(f, P(JWORKER_AXIS), (P(), P()), jax.ShapeDtypeStruct((N, 4), jnp.float32))
    assert _rows(tape) == want == [("all_gather", (WORKER_AXIS,), "int8", 4, True),
                                   ("psum", (WORKER_AXIS,), "float32", 16, True)]


def test_torch_walker_splits_mixed_dtype_collectives():
    """A collective over a tree of an int32 and an f32 leaf records one
    row a dtype, each its own bytes (walker.py:81-104 there)."""
    ax = RecordingWorkerAxis(N)
    x = torch.ones((N, 4))
    tree = {"a": x.to(torch.int8).to(torch.int32), "b": x * 2.0}

    def psum_tree(t):
        return {k: v.sum(0, dtype=v.dtype) for k, v in t.items()}

    with walker.recording(N) as tape:
        walker.collective_call("psum", ax.names, psum_tree, (tree,), {}, list(tree.values()),
                               lambda t: t.numel() * t.element_size() // N, "workers.psum")
    got = walker.collect_collectives(tape)
    assert sorted(c.dtype for c in got) == ["float32", "int32"]
    assert all(c.bytes == 16 for c in got)
    assert len(tape.nodes[-1].payloads) == 2  # one node, two records


def test_torch_walker_dataflow_distinguishes_param_and_metric_psums():
    """feeds_params: the gradient psum reaches the updated params, the
    metrics pmean does not. The rows are JAX's for the same step; JAX's
    walker marks both (it is conservative through the jit / shard_map
    nesting of this jax version), the tape's exact dataflow only the
    gradient's."""
    ax = RecordingWorkerAxis(N)
    p = torch.ones(4)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((N, 4)).astype(np.float32))

    def step(p, x):
        g = ax.psum(x.sum(1, keepdim=True) * torch.ones_like(p))
        metric = ax.pmean(x.sum(1))
        return p - g, metric

    tape, out = walker.record_step(step, p, x, devices=N)

    def f(p, x):
        g = lax.psum(x.sum() * jnp.ones_like(p), JWORKER_AXIS)
        return p - g, lax.pmean(x.sum(), JWORKER_AXIS)

    want = _jax_rows(f, (P(), P(JWORKER_AXIS)), (P(), P()),
                     jax.ShapeDtypeStruct((4,), jnp.float32),
                     jax.ShapeDtypeStruct((N, 4), jnp.float32), params=[0])
    got = _rows(tape, tape.producers(out[0]))
    assert [c[:4] for c in got] == [c[:4] for c in want]
    assert [(c[3], c[4]) for c in got] == [(4, False), (16, True)]
    assert all(c[4] for c in want if c[3] == 16)


@pytest.mark.parametrize("how", ["view_copy", "inplace_base", "out_kwarg"])
def test_torch_walker_is_conservative_through_views_and_inplace(how):
    """A psum whose result reaches the params only through a write into a
    view of a buffer, an in-place update of the buffer, or an ``out=``
    argument still feeds the params: a write into a storage is a parent of
    every later read of it (the tape may add edges, never lose one)."""
    ax = RecordingWorkerAxis(N)
    p = torch.ones(8)
    x = torch.ones((N, 4))

    def step(p, x):
        buf = torch.zeros(8)
        s = ax.psum(x)
        if how == "view_copy":
            buf[:4].copy_(s)
        elif how == "inplace_base":
            buf.add_(torch.cat([s, s]))
        else:
            torch.add(s, 1.0, out=buf[4:])
        return p - buf.view(2, 4).reshape(8)

    tape, out = walker.record_step(step, p, x, devices=N)
    (c,) = walker.collect_collectives(tape, tape.producers(out))
    assert c.kind == "psum" and c.feeds_params


def _lenet_step(overlap="serial", bucket_bytes=0):
    spec = _ps_spec("int8", "replicated", bucket_bytes=bucket_bytes, overlap=overlap,
                    bucket_tag="64k" if bucket_bytes else "")
    return spec.build(torch.device("cpu"))


def _bits(tree):
    from ps_pytorch_tpu_torch.check.core import leaves_with_paths

    return [(p, t.numpy().tobytes()) for p, t in leaves_with_paths(tree)
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("overlap", ["serial", "pipelined"])
def test_torch_recorded_step_gives_the_unrecorded_bits(overlap):
    """The LeNet int8 step (64 KiB buckets) recorded and not recorded, from
    the same state and inputs: the same state and metrics, bit for bit
    (the dispatch mode and the decorators change no value); the recorded
    pipelined step has one K2 node and one int32 psum a bucket, each psum
    after its bucket's quantize."""
    a, b = _lenet_step(overlap, 64 << 10), _lenet_step(overlap, 64 << 10)
    plain = a.step(*a.args)
    with walker.recording(N) as tape:
        rec = b.step(*b.args)
    assert _bits(plain) == _bits(rec)
    k2 = [n.index for n in tape.nodes if n.kernel == "K2"]
    psums = [n.index for n in tape.nodes
             if any(p.kind == "psum" and p.dtype == "int32" for p in n.payloads)]
    assert len(psums) == 27
    if overlap == "pipelined":
        assert len(k2) == 27
        assert all(q < s for q, s in zip(k2, psums))
        assert all(q in walker.ancestors(tape, [s]) for q, s in zip(k2, psums))
    else:
        assert len(k2) == 1 and k2[0] < min(psums)


def test_torch_tape_keeps_no_tensor_alive():
    """The recorder holds ints, names and shapes only: a step's gradients
    are freed while the recorder is still on, and no node holds a
    tensor."""
    ax = RecordingWorkerAxis(N)
    held = []

    def step(p, x):
        leaf = p.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = (leaf[None] * x).sum()
            (g,) = torch.autograd.grad(loss, leaf)
        held.append(weakref.ref(g))
        stacked = torch.stack([g * (w + 1) for w in range(N)])
        held.append(weakref.ref(stacked))
        return p - 0.1 * ax.psum(stacked)

    gc.collect()
    gc.disable()
    try:
        with walker.recording(N) as tape:
            out = step(torch.ones(4), torch.ones((N, 4)))
            assert all(r() is None for r in held), "the tape keeps a step's gradients alive"
            assert len(tape._vals) < len(tape.nodes)
    finally:
        gc.enable()
    assert out.shape == (4,)
    for node in tape.nodes:
        for value in vars(node).values():
            assert not isinstance(value, torch.Tensor)
            assert not any(isinstance(v, torch.Tensor) for v in
                           (value if isinstance(value, tuple) else ()))


def test_torch_tape_records_no_node_without_a_recording():
    """With no tape the decorators and the recording axes run the plain
    call: nothing records, and a second recording is refused while one
    is on."""
    from ps_pytorch_tpu_torch.ops.quantize import quantize_tensors

    ax = RecordingWorkerAxis(N)
    assert walker.active() is None
    ax.psum(torch.ones((N, 2)))
    quantize_tensors([torch.ones((N, 3))])
    with walker.recording(N):
        with pytest.raises(RuntimeError, match="already recording"):
            with walker.recording(N):
                pass
    assert walker.active() is None


def test_torch_process_axis_records_its_collectives(tmp_path):
    """A ``ProcessWorkerAxis`` (one gloo process holding the 8 workers)
    records as the stacked axis does: the psum's per-device bytes are a
    local row's, the shared scale's ``absmax_max`` is a pmax, the guard's
    ``all_true`` an int32 pmin; its inner ``gather_rows`` folds into the
    call that made it."""
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.check.axes import RecordingProcessAxis, recording_axis
    from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        ax = recording_axis(ProcessWorkerAxis(N))
        assert isinstance(ax, RecordingProcessAxis) and isinstance(ax, ProcessWorkerAxis)
        x = torch.ones((N, 4))

        def step(x):
            return (ax.psum(x), ax.pmean(x[:, 0]), ax.absmax_max(x.abs().amax()),
                    ax.all_true(torch.isfinite(x).all()))

        tape, out = walker.record_step(step, x, devices=N)
    finally:
        dist.destroy_process_group()
    assert torch.equal(out[0], torch.full((4,), float(N)))
    assert _rows(tape) == [("pmax", (WORKER_AXIS,), "float32", 4, True),
                           ("pmin", (WORKER_AXIS,), "int32", 4, True),
                           ("psum", (WORKER_AXIS,), "float32", 4, True),
                           ("psum", (WORKER_AXIS,), "float32", 16, True)]
    assert [n.name for n in tape.nodes if n.op == "collective"] == [
        "workers.psum", "workers.pmean", "workers.absmax_max", "workers.all_true"]
