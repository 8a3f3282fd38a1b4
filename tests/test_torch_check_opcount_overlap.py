"""pscheck on the port, the cost-model probes over a recorded step
(check/opcount.py, parallel/overlap.py): the update-path op count (the
serving decode step's is 0; the flat state layout's is below the tree's
on every ``layout_parity_pairs`` twin, in the direction JAX's counts go;
the pipelined ZeRO-1 step's is positive) and the overlap headroom (the
toy serial / pipelined pair of tests/test_overlap.py:204-237, and the
LeNet 64 KiB int8 twins, ordered as JAX's ``jaxpr_overlap_headroom``
orders the same configs).
"""

import torch

import ps_pytorch_tpu  # noqa: F401  (installs the jax.shard_map alias)
from ps_pytorch_tpu.check import contracts as jcontracts
from ps_pytorch_tpu.check.opcount import update_path_op_count as j_update_path_op_count
from ps_pytorch_tpu.parallel.overlap import jaxpr_overlap_headroom
from ps_pytorch_tpu_torch.check import contracts, trace_spec
from ps_pytorch_tpu_torch.check.axes import RecordingWorkerAxis
from ps_pytorch_tpu_torch.check.opcount import (
    device_kernel_count,
    update_path_op_count,
    update_path_ops_from,
)
from ps_pytorch_tpu_torch.parallel.overlap import overlap_headroom_from, tape_overlap_headroom
from tests.test_torch_one_thread import _one_thread  # noqa: F401

N = 8


def _tape(spec):
    return trace_spec(spec, keep_tape=True, device="cpu").tape


def test_torch_serve_decode_has_no_update_path():
    for int8 in (False, True):
        assert update_path_ops_from(_tape(contracts._serve_spec(int8))) == 0


def test_torch_flat_state_update_path_is_below_the_trees_as_in_jax():
    """Each layout twin: the same wire rows, and fewer update-path nodes
    for the flat state than for the tree, the direction JAX's equation
    counts take on the same configs."""
    jpairs = jcontracts.layout_parity_pairs()
    for (flat, tree), (jflat, jtree) in zip(contracts.layout_parity_pairs(), jpairs):
        assert flat.name == jflat.name and tree.name == jtree.name
        rf, rt = (trace_spec(s, keep_tape=True, device="cpu") for s in (flat, tree))
        assert rf.summary == rt.summary
        port = (update_path_ops_from(rf.tape), update_path_ops_from(rt.tape))
        bf, bt = jflat.build(), jtree.build()
        jx = (j_update_path_op_count(bf.step, *bf.args), j_update_path_op_count(bt.step, *bt.args))
        assert port[0] < port[1], (flat.name, port)
        assert jx[0] < jx[1], (flat.name, jx)


def test_torch_pipelined_zero1_has_an_update_path():
    assert update_path_ops_from(_tape(contracts._ps_spec("int8", "sharded",
                                                         overlap="pipelined"))) > 0


def test_torch_update_path_op_count_records_one_call():
    ax = RecordingWorkerAxis(N)

    def step(p, g):
        s = ax.psum(g)
        return (p - 0.1 * s) * 0.5

    # 0.1 * s, p - ..., ... * 0.5: every op after the reduce; on the CPU
    # the device count is the tape's aten nodes (the psum is a collective)
    assert update_path_op_count(step, torch.ones(4), torch.ones((N, 4)), devices=N) == 3
    assert device_kernel_count(step, torch.ones(4), torch.ones((N, 4))) == 3


def _toy(pipelined: bool):
    ax = RecordingWorkerAxis(N)

    def step(p, x):
        leaves = [torch.sin(p[i * 8:(i + 1) * 8][None] * x[:, :1]) for i in range(4)]
        if pipelined:
            parts = [ax.psum(leaf) for leaf in leaves]
        else:
            flat = torch.cat(leaves, dim=1)
            parts = [ax.psum(flat[:, i * 8:(i + 1) * 8]) for i in range(4)]
        return p - 0.1 * torch.cat(parts)

    return step


def test_torch_overlap_headroom_discriminates_schedules():
    """Per-bucket reduces over per-bucket assembly have strictly more
    independent work and a strictly smaller first-launch prefix than the
    same math spelled as slices of one global concat (JAX's toy pair)."""
    args = (torch.linspace(0.0, 1.0, 32), torch.ones((N, 4)))
    reps = {name: tape_overlap_headroom(_toy(name == "pipe"), *args, devices=N)
            for name in ("serial", "pipe")}
    assert reps["serial"]["n_collectives"] == reps["pipe"]["n_collectives"] == 4
    assert reps["pipe"]["overlap_headroom"] > reps["serial"]["overlap_headroom"]
    assert reps["pipe"]["first_dispatch_prefix"] < reps["serial"]["first_dispatch_prefix"]
    assert reps["pipe"]["overlap_headroom"] > 0


def test_torch_lenet_64k_twins_order_as_jaxs_headroom():
    """The LeNet int8 64 KiB serial / pipelined twins: the pipelined step
    has more headroom and a smaller first-dispatch prefix on the port's
    tape, as it has on JAX's jaxpr of the same configs."""
    port, jx = {}, {}
    for ov in ("serial", "pipelined"):
        kw = dict(bucket_bytes=64 << 10, bucket_tag="64k", overlap=ov)
        port[ov] = overlap_headroom_from(_tape(contracts._ps_spec("int8", "replicated", **kw)))
        built = jcontracts._ps_spec("int8", "replicated", **kw).build()
        jx[ov] = jaxpr_overlap_headroom(built.step, *built.args)
    for rep in (port, jx):
        assert rep["pipelined"]["overlap_headroom"] > rep["serial"]["overlap_headroom"], rep
        assert (rep["pipelined"]["first_dispatch_prefix"]
                < rep["serial"]["first_dispatch_prefix"]), rep
    assert port["serial"]["n_collectives"] == port["pipelined"]["n_collectives"]


def test_torch_headroom_of_a_tape_without_reduce():
    ax = RecordingWorkerAxis(N)

    def step(x):
        return ax.pmax(x) * 2

    rep = tape_overlap_headroom(step, torch.ones((N, 2)), devices=N)
    assert rep["n_collectives"] == 0 and rep["overlap_headroom"] is None
