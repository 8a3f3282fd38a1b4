"""Port parity: the multi-process worker backend
(ps_pytorch_tpu_torch.parallel.mesh.ProcessWorkerAxis, the split K1 / K2
routes of ops/quantize.py, the trainer's multi-process points) on gloo
over two CPU processes.

- Every collective of the process axis, at N=2 (one worker a process) and
  N=4 (two), bit for bit against the stacked ``WorkerAxis`` on the same
  numpy inputs: float sums, means, maxima and minima (NaN rows
  included), integer sums in int32 and in int16 (the homomorphic wire's
  accumulator, widened to int32 for the hop), psum_scatter, all_to_all,
  all_gather, ppermute, the mask, the agreed finite flag; K2's and K1's
  split quantize routes; and the three int8 wires (per-tensor, block 128,
  the two-round homomorphic fused wire) with their EF contributions. At
  N=2 the integer collectives and the three wires are also held against
  JAX's collectives inside ``shard_map``.
- The cross-process NaN rule: one process holds a NaN-only piece, the
  other finite rows of it; both split routes give every process scale
  NaN and an all-zero payload.
- ``cli.train --device cpu`` as two processes (LeNet, 4 workers, the int8
  wire with error feedback, 3 steps) writes the 1-process stacked run's
  ``model_step_3`` byte for byte; a SIGTERM on process 1 stops both at
  the same step; a ``--resume`` of both restores the same step.
- The resume-reshape over processes: a 4-worker ZeRO-1 + EF checkpoint
  the stacked trainer wrote, resumed by two processes of one worker each
  on another carving, restores the stacked trainer's reshape of the same
  file bit for bit (every field gathered), the EF sum kept.

Every process is spawned with a free port and a timeout, single-threaded
(the 1-process reference too, so their CPU convolutions add alike).
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.parallel import WORKER_AXIS
from ps_pytorch_tpu.parallel import collectives as jc
from ps_pytorch_tpu.parallel.mesh import make_mesh as jmake_mesh
from ps_pytorch_tpu_torch import checkpoint as tckpt
from ps_pytorch_tpu_torch.ops import quantize as tq
from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel.buckets import tree_flatten
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis, batch_sharding
from tools.mp_util import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
WIRES = {
    "int8": dict(compress="int8"),
    "block128": dict(compress="int8", quant_block_size=128),
    "2round_hom": dict(compress="int8_2round", bucket_bytes=0, wire_domain="homomorphic"),
}


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


def _spawn(argv_per_rank):
    procs = [subprocess.Popen(argv, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argv_per_rank]
    outs, deadline = [], time.monotonic() + TIMEOUT
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(5, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a process hung; output:\n{p.communicate()[0][-3000:]}")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


# ------------------------------------------------------- the collectives


def _inputs(n):
    """Every worker's rows, ``[n, ...]`` numpy, from one seed."""
    rng = np.random.RandomState(7 + n)
    x = rng.randn(n, 5, 3).astype(np.float32)
    xn = x.copy()
    xn[n - 1, 2, 1] = np.nan
    grads = {"conv": rng.randn(n, 3, 3, 2, 5).astype(np.float32),
             "dense": (rng.randn(n, 40, 7) * np.exp(rng.randn(n, 1, 1))).astype(np.float32),
             "bias": rng.randn(n, 7).astype(np.float32)}
    nanp = rng.randn(n, 300).astype(np.float32)
    nanp[n - 1] = np.nan  # NaN-only on the last worker (the last process)
    return {
        "x": x, "xn": xn, "grads": grads,
        "i32": rng.randint(-2 ** 20, 2 ** 20, size=(n, 4 * n)).astype(np.int32),
        # near int16's edge: the sum of all n rows still fits, as
        # accum_dtype guarantees for the homomorphic wire
        "i16": rng.randint(-32767 // n, 32767 // n, size=(n, 4 * n)).astype(np.int16),
        "i8": rng.randint(-127, 128, size=(n, n, 3)).astype(np.int8),
        "pieces": [rng.randn(n, 37).astype(np.float32), nanp,
                   np.zeros((n, 5), np.float32), rng.randn(n, 2, 130).astype(np.float32)],
        "finite": np.array([True] * (n - 1) + [False]),
        "perm": np.random.RandomState(n).permutation(n),
    }


def _rows(tree, sl):
    if isinstance(tree, dict):
        return {k: _rows(v, sl) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, sl) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree[sl]))


def _cases(axis, inp):
    """name -> ("whole" | "local", tensor) over ``axis`` on this
    process's rows ``inp`` (torch)."""
    n = axis.size
    out = {}
    whole = lambda name, t: out.__setitem__(name, ("whole", t))
    local = lambda name, t: out.__setitem__(name, ("local", t))
    for name in ("x", "xn"):
        whole(f"psum_{name}", axis.psum(inp[name]))
        whole(f"pmax_{name}", axis.pmax(inp[name]))
        whole(f"pmin_{name}", axis.pmin(inp[name]))
        whole(f"pmean_{name}", axis.pmean(inp[name]))
        local(f"psum_scatter_{name}", axis.psum_scatter(inp[name].reshape(-1, 15)[:, :15 // n * n]
                                                        .contiguous()))
        whole(f"all_gather_{name}", axis.all_gather(inp[name]))
        local(f"ppermute_{name}", axis.ppermute(inp[name], [(j, (j - 1) % n) for j in range(n)]))
    for name in ("i32", "i16"):
        whole(f"psum_{name}", axis.psum(inp[name]))
        local(f"psum_scatter_{name}", axis.psum_scatter(inp[name]))
    local("all_to_all_i8", axis.all_to_all(inp["i8"]))
    local("axis_index", axis.axis_index())
    local("mask_random_k", tc.aggregation_mask(axis, n, n - 1, torch.from_numpy(inp["perm"])))
    local("mask_first_k", tc.aggregation_mask(axis, n, 1, mode="first_k"))
    # each process's own verdict over its workers, agreed by all
    whole("all_true", axis.all_true(torch.tensor(bool(inp["finite"].all()))))
    for block in (0, 8):
        for i, (q, scale, absmax) in enumerate(tq.quantize_int8_many(inp["pieces"], axis,
                                                                     block)):
            local(f"q{block}_{i}", q)
            whole(f"scale{block}_{i}", scale)
            whole(f"absmax{block}_{i}", absmax)
    for wire, kw in WIRES.items():
        agg, contrib = tc.aggregate_gradients(inp["grads"], axis, n, flat_output=True,
                                              return_contribution=True, **kw)
        whole(f"wire_{wire}", agg)
        for j, leaf in enumerate(tree_flatten(contrib)[0]):
            local(f"contrib_{wire}_{j}", leaf)
    return out


def _local_inputs(axis, n):
    inp = _inputs(n)
    sl = slice(axis.local(torch.arange(n))[0].item(), axis.local(torch.arange(n))[-1].item() + 1)
    out = {k: _rows(v, sl) for k, v in inp.items() if k not in ("finite", "perm")}
    out["finite"] = inp["finite"][sl]
    out["perm"] = inp["perm"]
    return out


def _child_collectives(rank, world, port, n, path):
    """One process of the collectives pin: its results as an npz."""
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        axis = ProcessWorkerAxis(int(n))
        res = _cases(axis, _local_inputs(axis, int(n)))
        np.savez(path, **{f"{kind}:{k}": t.numpy() for k, (kind, t) in res.items()})
    finally:
        dist.destroy_process_group()


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.tobytes()


@pytest.mark.parametrize("n", [2, 4])
def test_torch_process_axis_collectives_match_stacked(tmp_path, n):
    port = free_port()
    paths = [str(tmp_path / f"r{r}.npz") for r in range(2)]
    _spawn([[sys.executable, "-c",
             "import sys; from tests.test_torch_distributed import _child_collectives as c; "
             "c(*sys.argv[1:])", str(r), "2", str(port), str(n), paths[r]] for r in range(2)])
    got = [dict(np.load(p)) for p in paths]
    want = _cases(WorkerAxis(n), _local_inputs(WorkerAxis(n), n))
    assert {k.split(":", 1)[1] for k in got[0]} == set(want)
    for name, (kind, t) in want.items():
        parts = [g[f"{kind}:{name}"] for g in got]
        if kind == "whole":
            for part in parts:
                assert _bits(part) == _bits(t.numpy()), name
        else:
            assert _bits(np.concatenate(parts)) == _bits(t.numpy()), name
    # the cross-process NaN rule: every process, scale NaN and payload 0
    for g in got:
        for block in (0, 8):
            assert np.isnan(g[f"whole:scale{block}_1"]).all()
            assert not g[f"local:q{block}_1"].any()
            assert np.isfinite(g[f"whole:scale{block}_0"]).all()
    # the int16 sum kept its type and its (stacked) integers
    assert got[0]["whole:psum_i16"].dtype == np.int16
    assert np.array_equal(got[1]["whole:psum_i16"],
                          _inputs(n)["i16"].astype(np.int64).sum(0).astype(np.int16))
    if n == 2:
        _check_against_jax(want, n)


def _jax_wire(mesh, n, kw):
    """JAX's aggregate (flat) and EF contribution of one wire, jitted
    around ``shard_map`` as the train step runs it."""
    def fn(g):
        g = jax.tree.map(lambda a: a[0], g)
        agg, contrib = jc.aggregate_gradients(g, WORKER_AXIS, n, flat_output=True,
                                              return_contribution=True, **kw)
        return agg, jax.tree.map(lambda a: a[None], contrib)

    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(WORKER_AXIS),
                                 out_specs=(P(), P(WORKER_AXIS)), check_vma=False))


def _check_against_jax(want, n):
    """At N=2: the integer collectives and the three int8 wires against
    JAX's inside ``shard_map`` on a 2-device mesh (the stacked results
    equal the processes', so the processes equal JAX)."""
    inp = _inputs(n)
    mesh = jmake_mesh(num_workers=n)

    def ints(i32, i16, i8):
        i32, i16, i8 = i32[0], i16[0], i8[0]
        return (jax.lax.psum(i32, WORKER_AXIS), jax.lax.psum(i16, WORKER_AXIS),
                jax.lax.psum_scatter(i32, WORKER_AXIS, tiled=True)[None],
                jax.lax.psum_scatter(i16, WORKER_AXIS, tiled=True)[None],
                jax.lax.all_to_all(i8, WORKER_AXIS, 0, 0, tiled=True)[None])

    f = jax.jit(jax.shard_map(ints, mesh=mesh, in_specs=P(WORKER_AXIS),
                              out_specs=(P(), P(), P(WORKER_AXIS), P(WORKER_AXIS),
                                         P(WORKER_AXIS)), check_vma=False))
    j = [np.asarray(a) for a in f(jnp.asarray(inp["i32"]), jnp.asarray(inp["i16"]),
                                   jnp.asarray(inp["i8"]))]
    assert _bits(j[0]) == _bits(want["psum_i32"][1].numpy())
    assert _bits(j[1]) == _bits(want["psum_i16"][1].numpy())
    assert _bits(j[2]) == _bits(want["psum_scatter_i32"][1].numpy())
    assert _bits(j[3]) == _bits(want["psum_scatter_i16"][1].numpy())
    # JAX's all_to_all gives worker w [N(sender), s] of its region: the
    # stacked [n(region), N(sender), s]
    assert _bits(j[4]) == _bits(want["all_to_all_i8"][1].numpy())
    for wire, kw in WIRES.items():
        agg, contrib = _jax_wire(mesh, n, kw)(jax.tree.map(jnp.asarray, inp["grads"]))
        assert _bits(np.asarray(agg)) == _bits(want[f"wire_{wire}"][1].numpy()), wire
        for j_, leaf in enumerate(jax.tree_util.tree_leaves(contrib)):
            assert _bits(np.asarray(leaf)) == _bits(want[f"contrib_{wire}_{j_}"][1].numpy())


def test_torch_process_axis_batch_sharding_and_refusals():
    assert list(batch_sharding(WorkerAxis(4))) == [0, 1, 2, 3]
    with pytest.raises(TypeError, match="make_hybrid_mesh"):
        tc.aggregate_gradients({"w": torch.zeros(2, 3)}, ("dcn", WORKER_AXIS), 2)
    from ps_pytorch_tpu_torch.parallel.mesh import initialize_multihost

    assert initialize_multihost(None) is False
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="one process per card"):
            initialize_multihost("localhost:1", 2, 0, device="cuda")
    # a one-process gloo group: the axis over it; synced BN and the
    # hierarchical grid build their steps over it
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.mesh import ProcessHybridAxis, ProcessWorkerAxis
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, make_ps_train_step

    assert initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cpu") is True
    try:
        axis = ProcessWorkerAxis(2)
        assert list(batch_sharding(axis)) == [0, 1] and axis.local_size == 2
        cfg = PSConfig(num_workers=2, bn_mode="synced")
        model = build_model("ResNet18", bn_axis_name=cfg.axis_name)
        assert callable(make_ps_train_step(model, build_optimizer("sgd", 0.1), cfg, axis,
                                           device="cpu"))
        # the hierarchical grid over processes: both hosts in this process
        assert callable(make_ps_train_step(
            build_model("LeNet"), build_optimizer("sgd", 0.1),
            PSConfig(num_workers=2, dcn_hosts=2, compress="int8_2round"),
            ProcessHybridAxis(2, 2), device="cpu"))
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- the trainer


def _train_argv(train_dir, extra=(), rank=None, port=None, world=2):
    argv = [sys.executable, "-m", "ps_pytorch_tpu_torch.cli.train", "--device", "cpu",
            "--network", "LeNet", "--dataset", "MNIST", "--num-workers", "4",
            "--batch-size", "8", "--test-batch-size", "32", "--lr", "0.05",
            "--momentum", "0.9", "--compress-grad", "compress", "--error-feedback",
            "--log-interval", "1", "--eval-freq", "3", "--train-dir", str(train_dir),
            *extra]
    if rank is not None:
        argv += ["--coordinator-address", f"localhost:{port}", "--num-processes", str(world),
                 "--process-id", str(rank)]
    return argv


def test_torch_two_process_cli_train_writes_the_stacked_bytes(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    _spawn([_train_argv(one, ["--max-steps", "3"])])
    port = free_port()
    outs = _spawn([_train_argv(two, ["--max-steps", "3"], rank=r, port=port) for r in range(2)])
    assert tckpt.available_steps(str(two)) == [3]
    with open(one / "model_step_3", "rb") as f, open(two / "model_step_3", "rb") as g:
        assert f.read() == g.read()
    raw = tckpt.load_checkpoint_raw(str(two), 3)
    ef = tree_flatten(raw["comm_state"])[0]
    assert ef and all(np.asarray(e).shape[0] == 4 for e in ef)  # every worker's residual
    for out in outs:
        assert "Step: 3" in out and "Validation Step: 3" in out


def test_torch_two_process_sigterm_stops_both_then_resume_agrees(tmp_path):
    d = tmp_path / "ckpt"
    port = free_port()
    outs = _spawn([_train_argv(d, ["--max-steps", "6"] + (
        ["--fault-plan", '{"sigterm": 2}'] if r == 1 else []), rank=r, port=port)
        for r in range(2)])
    for out in outs:
        assert "graceful stop at step 2" in out and "Step: 3" not in out, out[-2000:]
    assert tckpt.available_steps(str(d)) == [2]
    port = free_port()
    outs = _spawn([_train_argv(d, ["--max-steps", "3", "--resume"], rank=r, port=port)
                   for r in range(2)])
    for out in outs:
        assert "model_step_2 (agreed by the processes)" in out and "Step: 3" in out
    assert tckpt.available_steps(str(d)) == [2, 3]


RESHAPE = ["--opt-placement", "sharded", "--compress-grad", "compress", "--error-feedback"]


def _child_resume(rank, world, port, train_dir, path):
    """One process of the resume-reshape pin: a 2-worker trainer over two
    processes resumes ``train_dir``; its gathered checkpoint form as an
    npz."""
    import argparse

    from ps_pytorch_tpu_torch.cli._flags import (
        add_ps_flags,
        add_train_flags,
        ps_config_from,
        train_config_from,
    )
    from ps_pytorch_tpu_torch.parallel.mesh import initialize_multihost
    from ps_pytorch_tpu_torch.trainer import Trainer
    from ps_pytorch_tpu_torch.utils.serialization import to_state_dict

    args = add_ps_flags(add_train_flags(argparse.ArgumentParser())).parse_args(
        _train_argv(train_dir, RESHAPE + ["--num-workers", "2", "--bucket-bytes", "0",
                                          "--resume"])[3:])
    initialize_multihost(f"localhost:{port}", int(world), int(rank), device="cpu")
    import torch.distributed as dist

    try:
        trainer = Trainer(train_config_from(args), ps_config_from(args, 2), device="cpu")
        step = trainer.try_resume()
        flat = _flat_dict(to_state_dict(trainer.checkpoint_state()))
        np.savez(path, resumed_step=np.asarray(step), **flat)
    finally:
        dist.destroy_process_group()


def _flat_dict(sd, prefix=""):
    """A state dict's leaves by path (None leaves dropped)."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flat_dict(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


def test_torch_two_process_resume_reshapes_as_the_stacked_trainer(tmp_path):
    """A 4-worker ZeRO-1 + EF checkpoint (stacked, 2 steps) resumed on 2
    processes x 1 worker with ``--bucket-bytes 0``: every rank reshapes
    the bytes rank 0 verified and keeps its own rows; gathered, the state
    equals the stacked 2-worker trainer's resume of the same file bit for
    bit, and the EF residuals' sum is the file's."""
    import argparse

    from ps_pytorch_tpu_torch.cli._flags import (
        add_ps_flags,
        add_train_flags,
        ps_config_from,
        train_config_from,
    )
    from ps_pytorch_tpu_torch.trainer import Trainer
    from ps_pytorch_tpu_torch.utils.serialization import to_state_dict

    d = tmp_path / "ckpt"
    _spawn([_train_argv(d, RESHAPE + ["--max-steps", "2", "--bucket-bytes", "4096"])])
    assert tckpt.available_steps(str(d)) == [2]
    port = free_port()
    paths = [str(tmp_path / f"r{r}.npz") for r in range(2)]
    _spawn([[sys.executable, "-c",
             "import sys; from tests.test_torch_distributed import _child_resume as c; "
             "c(*sys.argv[1:])", str(r), "2", str(port), str(d), paths[r]] for r in range(2)])
    args = add_ps_flags(add_train_flags(argparse.ArgumentParser())).parse_args(
        _train_argv(d, RESHAPE + ["--num-workers", "2", "--bucket-bytes", "0", "--resume"])[3:])
    stacked = Trainer(train_config_from(args), ps_config_from(args, 2), device="cpu")
    assert stacked.try_resume() == 2
    want = _flat_dict(to_state_dict(stacked.checkpoint_state()))
    assert want["opt_state/momentum_buffer"].shape[0] == 2  # the 2-worker ZeRO-1 rows
    for path in paths:
        got = dict(np.load(path))
        assert int(got.pop("resumed_step")) == 2
        assert sorted(got) == sorted(want)
        for k in want:
            assert _bits(got[k]) == _bits(want[k]), k
    raw = tckpt.load_checkpoint_raw(str(d), 2)
    assert _bits(want["comm_state"].sum(0)) == _bits(np.asarray(raw["comm_state"]).sum(0))
