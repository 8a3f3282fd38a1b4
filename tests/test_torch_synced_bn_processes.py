"""Synced BatchNorm across processes (a model built with ``bn_axis_name``
on ``ProcessWorkerAxis``): each gloo process runs its own workers' rows,
the per-worker statistics combine over every process's workers
(``models.common._WorkerMean``, its backward carrying the other
processes' losses in), on two CPU processes, one thread each.

- Against JAX: two processes of one worker run
  tests/test_torch_synced_bn.py's synced step (the ``(1, 1, 1, 1)``
  ResNet at N=2 on JAX's weights), held to JAX's jitted step at that
  file's bounds (1e-3 of the update, loss rtol 1e-5, stats 2e-5 of the
  largest); two processes of two workers run its two ``bn_mode="local"``
  int8 steps at N=4, held at its local-mode bounds, each process's stats
  rows JAX's rows of its workers.
- Against the stacked port: both runs are the stacked run's bit for bit
  (params, loss, stats): every per-worker op runs on one worker's rows
  in both, and the statistics and their gradients reduce in worker order
  in both.
- Controls, over processes: local statistics (the pmean mode, a model
  without ``bn_axis_name``) and the synced forward with each process's
  gradient from its own loss alone (the cross-process terms dropped)
  both land outside the bound.
- ``cli.train --bn-mode synced`` (ResNet18, 2 workers, 2 steps, then a
  planned SIGTERM: the checkpoint without the validation pass) as two
  gloo processes writes the one-process stacked run's checkpoint byte
  for byte.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_synced_bn import B, N, NL, jax_step, local_steps  # noqa: F401


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(data, prefix):
    out = {}
    for k, v in data.items():
        if not k.startswith(prefix):
            continue
        node = out
        *path, leaf = k[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _steps(axis, p0, bs0, batches, bn_mode, synced, compress=None, rows=None):
    """The port's steps over ``axis`` (stacked or this process's) from
    JAX's weights: each step's flat params, loss and stats leaves (this
    process's rows under bn_mode local)."""
    from ps_pytorch_tpu_torch.data import make_preprocessor
    from ps_pytorch_tpu_torch.models import BasicBlock, ResNet, cnn_from_jax
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves, tree_map
    from ps_pytorch_tpu_torch.parallel.mesh import WORKER_AXIS
    from ps_pytorch_tpu_torch.parallel.ps import (
        PSConfig,
        StepDraws,
        init_ps_state,
        make_ps_train_step,
    )

    n = axis.size
    model = ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1),
                   bn_axis_name=WORKER_AXIS if synced else None)
    cfg = PSConfig(num_workers=n, bn_mode=bn_mode, compress=compress)
    tx = build_optimizer("sgd", 0.02, momentum=0.9)
    params, bs = cnn_from_jax(p0, bs0, device="cpu")
    st = init_ps_state(model, tx, cfg, params=params, batch_stats=bs, device="cpu", mesh=axis)
    if rows is not None:
        st.batch_stats = tree_map(lambda r: axis.local(r).clone(),
                                  cnn_from_jax(p0, rows, device="cpu")[1])
    step = make_ps_train_step(model, tx, cfg, axis, preprocess=make_preprocessor("Cifar10", False),
                              device="cpu")
    lo, nl = axis.first * B, axis.local_size * B
    out = []
    for batch in batches:
        st, m = step(st, {k: v[lo:lo + nl] for k, v in batch.items()}, StepDraws())
        out.append((st.params.flat.numpy().copy(), m["loss"].numpy().copy(),
                    [t.numpy().copy() for t in tree_leaves(st.batch_stats)]))
    return out


def _own_loss_backward(ctx, g):
    """The statistics' backward with this process's losses alone: the
    cross-process terms dropped."""
    return (g / ctx.n), None


def _save(res, path):
    flat = {}
    for name, steps in res.items():
        for i, (params, loss, stats) in enumerate(steps):
            flat[f"{name}:{i}:params"], flat[f"{name}:{i}:loss"] = params, loss
            for j, s in enumerate(stats):
                flat[f"{name}:{i}:stats{j}"] = s
    np.savez(path, **flat)


def _child(rank, world, port, inp_path, out_path):
    """One process: the synced N=2 step and its two controls on one worker
    a process, then the bn_mode local steps on two."""
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.models import common
    from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        data = dict(np.load(inp_path))
        p0, bs0, rows = _nest(data, "p0/"), _nest(data, "bs0/"), _nest(data, "rows/")
        batch = {"image": data["batch:image"], "label": data["batch:label"]}
        local = [{"image": data[f"local{i}:image"], "label": data[f"local{i}:label"]}
                 for i in range(2)]
        axis = ProcessWorkerAxis(N)
        res = {"synced": _steps(axis, p0, bs0, [batch], "synced", True),
               "pmean": _steps(axis, p0, bs0, [batch], "pmean", False)}
        real = common._WorkerMean.backward
        common._WorkerMean.backward = staticmethod(_own_loss_backward)
        try:
            res["own_loss"] = _steps(axis, p0, bs0, [batch], "synced", True)
        finally:
            common._WorkerMean.backward = real
        res["local"] = _steps(ProcessWorkerAxis(NL), p0, bs0, local, "local", True,
                              compress="int8", rows=rows)
        _save(res, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(jax_step, local_steps, tmp_path_factory):  # noqa: F811
    """The two processes' runs and the stacked port's of the same inputs."""
    from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
    from tests.test_torch_distributed import _spawn
    from tools.mp_util import free_port

    p0, bs0, _, batch, _, _ = jax_step
    tmp = tmp_path_factory.mktemp("synced_proc")
    inp = str(tmp / "inputs.npz")
    arrays = {**_flat(p0, "p0/"), **_flat(bs0, "bs0/"), **_flat(local_steps["rows"], "rows/"),
              "batch:image": batch["image"], "batch:label": batch["label"]}
    for i, b in enumerate(local_steps["batches"]):
        arrays[f"local{i}:image"], arrays[f"local{i}:label"] = b["image"], b["label"]
    np.savez(inp, **arrays)
    port = free_port()
    paths = [str(tmp / f"r{r}.npz") for r in range(2)]
    _spawn([[sys.executable, "-c",
             "import sys; from tests.test_torch_synced_bn_processes import _child as c; "
             "c(*sys.argv[1:])", str(r), "2", str(port), inp, paths[r]] for r in range(2)])
    stacked = _steps(WorkerAxis(N), p0, bs0, [batch], "synced", True)
    return dict(got=[dict(np.load(p)) for p in paths], stacked=stacked)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.tobytes()


def test_torch_synced_bn_processes_step_matches_jax(jax_step, runs):
    _, _, flat0, _, js, jm = jax_step
    jflat = np.asarray(js.params.flat)
    moved = np.abs(jflat - flat0).max()
    jstats = [np.asarray(b) for b in jax.tree_util.tree_leaves(js.batch_stats)]
    for g in runs["got"]:
        assert np.abs(jflat - g["synced:0:params"]).max() <= 1e-3 * moved
        assert float(g["synced:0:loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        for j, b in enumerate(jstats):
            assert np.abs(g[f"synced:0:stats{j}"] - b).max() <= 2e-5 * max(np.abs(b).max(), 1e-6)


def test_torch_synced_bn_processes_step_bit_for_bit_stacked(runs):
    params, loss, stats = runs["stacked"][0]
    for g in runs["got"]:
        assert _bits(g["synced:0:params"]) == _bits(params)
        assert _bits(g["synced:0:loss"]) == _bits(loss)
        for j, s in enumerate(stats):
            assert _bits(g[f"synced:0:stats{j}"]) == _bits(s)


@pytest.mark.parametrize("control", ["pmean", "own_loss"])
def test_torch_synced_bn_processes_controls_land_outside(jax_step, runs, control):
    """Local statistics, and the cross-process terms of the gradient
    dropped: both move the params far outside the bound (the own-loss
    control keeps JAX's loss: its forward is the synced one)."""
    _, _, flat0, _, js, jm = jax_step
    jflat = np.asarray(js.params.flat)
    moved = np.abs(jflat - flat0).max()
    for g in runs["got"]:
        assert np.abs(jflat - g[f"{control}:0:params"]).max() > 1e-2 * moved
        if control == "own_loss":
            assert float(g["own_loss:0:loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)


def test_torch_synced_bn_processes_local_two_int8_steps_match_jax(local_steps, runs):
    """bn_mode local at N=4 over two processes of two workers: the
    params and losses within tests/test_torch_synced_bn.py's local-mode
    bounds of JAX's two steps, each process's stats rows JAX's rows of
    its workers within 2e-5 of the largest; and the stacked port's local
    steps bit for bit."""
    flat0 = local_steps["flat0"]
    for i, ((jflat, jloss, jbs), (tflat, tloss, tbs)) in enumerate(
            zip(local_steps["jout"], local_steps["tout"])):
        moved = np.abs(jflat - flat0).max()
        for r, g in enumerate(runs["got"]):
            d = np.abs(jflat - g[f"local:{i}:params"])
            assert d.max() <= 1e-2 * moved, (i, d.max(), moved)
            if i == 0:
                assert (d > 1e-6).mean() <= 0.01
            assert float(g[f"local:{i}:loss"]) == pytest.approx(jloss, rel=1e-5)
            assert _bits(g[f"local:{i}:params"]) == _bits(tflat.numpy())
            assert _bits(g[f"local:{i}:loss"]) == _bits(np.float32(tloss))
            for j, (b, t) in enumerate(zip(jbs, tbs)):
                mine = g[f"local:{i}:stats{j}"]
                assert mine.shape[0] == NL // 2
                rows = slice(r * NL // 2, (r + 1) * NL // 2)
                assert np.abs(mine - b[rows]).max() <= 2e-5 * max(np.abs(b).max(), 1e-6)
                assert _bits(mine) == _bits(t.numpy()[rows])


def _cli_argv(train_dir, rank=None, port=None):
    argv = [sys.executable, "-m", "ps_pytorch_tpu_torch.cli.train", "--device", "cpu",
            "--network", "ResNet18", "--dataset", "Cifar10", "--num-workers", "2",
            "--bn-mode", "synced", "--batch-size", "4", "--test-batch-size", "8",
            "--lr", "0.05", "--log-interval", "1", "--max-steps", "3", "--eval-freq", "2",
            "--train-dir", str(train_dir),
            # a stop at step 2 writes model_step_2 and skips the validation pass
            "--fault-plan", '{"sigterm": 2}']
    if rank is not None:
        argv += ["--coordinator-address", f"localhost:{port}", "--num-processes", "2",
                 "--process-id", str(rank)]
    return argv


def test_torch_synced_bn_processes_cli_train_writes_the_stacked_bytes(tmp_path):
    from tests.test_torch_distributed import _spawn
    from tools.mp_util import free_port

    one, two = tmp_path / "one", tmp_path / "two"
    port = free_port()
    outs = _spawn([_cli_argv(one)] + [_cli_argv(two, r, port) for r in range(2)])
    for out in outs:
        assert "Step: 2" in out and "graceful stop at step 2" in out, out[-2000:]
    with open(one / "model_step_2", "rb") as f, open(two / "model_step_2", "rb") as g:
        assert f.read() == g.read()
