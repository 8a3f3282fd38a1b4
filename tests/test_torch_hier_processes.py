"""The hierarchical DCN x ICI wire over processes
(ps_pytorch_tpu_torch.parallel.mesh.ProcessHybridAxis: each gloo process
holds whole hosts of the grid, as JAX's multi-process make_hybrid_mesh
maps one host to one process) against the stacked grid
(``HybridWorkerAxis``), on two CPU processes:

- ``aggregate_gradients`` with ``int8_2round`` (the hierarchical wire)
  on the 2 x 4 grid (one host a process) and the 4 x 2 grid (two hosts a
  process), bit for bit the stacked grid's aggregate and EF
  contributions: the dequant and homomorphic domains, per leaf, fused
  (``bucket_bytes`` 0) and bucketed (4096), block 0 and 128, nearest
  rounding and stochastic rounding on JAX's draws (the stacked run's
  calls recorded from JAX's key folds and replayed by the processes),
  at the full count, a masked count and the adaptive device count. The
  stacked grid is JAX's bit for bit (tests/test_torch_hier.py at 2 x 4);
  two 4 x 2 cases are held to JAX's shard_map here too;
- two LeNet PS steps over the process grid, bit for bit the stacked
  steps (params, loss, this process's EF and ZeRO-1 rows): the block-128
  hierarchical wire with error feedback, ZeRO-1 on the int8 wire over the
  grid's tuple axis, and the pipelined schedule on the homomorphic
  hierarchical wire;
- the balanced-per-host rule: 3 hosts over 2 processes raise;
- ``cli.train --dcn-hosts 2 --num-workers 8 --compress-grad 2round`` as
  two gloo processes writes the one-process stacked run's
  ``model_step_3`` byte for byte, and JAX's ``cli.evaluate --once``
  reads it (the mirror of tests/test_multihost.py:131-172); a
  ``--resume`` of both to step 4 gives the same bytes again.

Every process is spawned as tests/test_torch_distributed.py does (a free
port, a timeout, one thread), and so is the stacked reference's CLI run.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel.buckets import tree_flatten
from ps_pytorch_tpu_torch.parallel.mesh import make_hybrid_mesh
from tests.test_torch_one_thread import _one_thread  # noqa: F401

N = 8
LAYOUTS = (2, 4)  # hosts: one host a process, two hosts a process
# random_k's permutation: JAX's jax.random.permutation(key(1), 8)
PERM = np.array([7, 6, 3, 2, 0, 1, 5, 4])
CASES = {
    "dequant_b0_leaf_ef": dict(wire_domain="dequant", ef=True),
    "dequant_b128_fused_ef": dict(wire_domain="dequant", quant_block_size=128, bucket_bytes=0,
                                  ef=True),
    "dequant_b0_4096_k5": dict(wire_domain="dequant", bucket_bytes=4096, num_aggregate=5),
    "dequant_b128_4096_count_ef": dict(wire_domain="dequant", quant_block_size=128,
                                       bucket_bytes=4096, count=5, ef=True),
    "homomorphic_b0_leaf_ef": dict(wire_domain="homomorphic", ef=True),
    "homomorphic_b128_fused_k5": dict(wire_domain="homomorphic", quant_block_size=128,
                                      bucket_bytes=0, num_aggregate=5),
    "homomorphic_b0_4096_count_ef": dict(wire_domain="homomorphic", bucket_bytes=4096, count=6,
                                         ef=True),
    "homomorphic_b128_4096": dict(wire_domain="homomorphic", quant_block_size=128,
                                  bucket_bytes=4096),
    "stochastic_b0_4096_ef": dict(quant_rounding="stochastic", bucket_bytes=4096, ef=True),
    "stochastic_b128_leaf_ef": dict(quant_rounding="stochastic", quant_block_size=128, ef=True),
    "stochastic_b0_fused_count": dict(quant_rounding="stochastic", bucket_bytes=0, count=7),
}
# the cases held to JAX's shard_map at 4 x 2 here (2 x 4: test_torch_hier.py)
JAX_CASES = ("dequant_b128_fused_ef", "homomorphic_b0_4096_count_ef")


def grads_np(seed=5):
    """Every worker's gradient tree: magnitudes vary by worker, an odd
    leaf, an all-zero leaf and two leaves past one 4096-byte bucket."""
    rng = np.random.RandomState(seed)
    scale = np.exp(rng.randn(N, 1) * 1.5).astype(np.float32)

    def leaf(*shape):
        x = rng.randn(N, *shape).astype(np.float32)
        return x * scale.reshape((N,) + (1,) * len(shape))

    return {"conv": leaf(3, 3, 4, 8), "dense": leaf(300, 10), "bias": leaf(10),
            "odd": leaf(37), "zero": np.zeros((N, 5), np.float32), "big": leaf(2000)}


def _draw_key(hosts, pid, rnd, shape) -> str:
    return f"draw:{hosts}:{pid}:{rnd}:{'x'.join(str(int(d)) for d in shape)}"


def table_draws(table, hosts):
    """A draw source replaying recorded draws (every worker's, ``[N,
    ...]``)."""
    def draws(pid, rnd, shape):
        return torch.from_numpy(np.array(table[_draw_key(hosts, pid, rnd, shape)]))

    return draws


def wire_cases(axis, hosts, grads, draws_for):
    """name -> ("whole" | "local", array) of every case on ``axis`` (the
    stacked grid or this process's ``ProcessHybridAxis``), ``grads`` the
    numpy trees of every worker."""
    tree = {k: axis.local(torch.from_numpy(v)) for k, v in grads.items()}
    out = {}
    for name, kw in CASES.items():
        kw = dict(kw)
        ef, count = kw.pop("ef", False), kw.pop("count", None)
        stochastic = kw.get("quant_rounding") == "stochastic"
        res = tc.aggregate_gradients(
            tree, axis, N,
            num_aggregate=(torch.tensor(count, dtype=torch.int32) if count is not None
                           else kw.pop("num_aggregate", None)),
            perm=torch.from_numpy(PERM), compress="int8_2round", flat_output=True,
            return_contribution=ef, quant_draws=draws_for(hosts) if stochastic else None,
            **kw)
        agg, contrib = res if ef else (res, None)
        out[f"{hosts}:{name}:agg"] = ("whole", agg.numpy())
        if ef:
            for j, leaf in enumerate(tree_flatten(contrib)[0]):
                out[f"{hosts}:{name}:c{j}"] = ("local", leaf.numpy())
    return out


# the PS step on the 2 x 4 grid: the hierarchical wire with EF; ZeRO-1 on
# the int8 wire (the tuple axis; JAX fences only int8_2round x sharded x
# dcn); the pipelined schedule on the homomorphic hierarchical wire
LENET_CFGS = {
    "hier_b128_ef": dict(compress="int8_2round", quant_block_size=128, error_feedback=True,
                         bucket_bytes=0),
    "zero1_int8_ef": dict(compress="int8", opt_placement="sharded", error_feedback=True,
                          bucket_bytes=4096),
    "pipelined_hom": dict(compress="int8_2round", wire_domain="homomorphic", bucket_bytes=4096,
                          overlap="pipelined"),
}
LENET_B = 2


def lenet_steps(axis, steps=2):
    """Two LeNet PS steps of each ``LENET_CFGS`` config on the 2 x 4 grid
    from one seed: flat params, this process's EF rows and the losses,
    after each step."""
    from ps_pytorch_tpu_torch.data import make_synthetic
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.ps import (
        PSConfig,
        StepDraws,
        init_ps_state,
        make_ps_train_step,
    )

    d = make_synthetic("MNIST", train_size=N * LENET_B * steps, test_size=8, seed=2)
    lo, nl = axis.first * LENET_B, axis.local_size * LENET_B
    out = {}
    for name, kw in LENET_CFGS.items():
        cfg = PSConfig(num_workers=N, dcn_hosts=2, **kw)
        model, tx = build_model("LeNet"), build_optimizer("sgd", 0.05, momentum=0.9)
        st = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(0), device="cpu",
                           mesh=axis)
        step = make_ps_train_step(model, tx, cfg, axis, device="cpu")
        for i in range(steps):
            rows = slice(i * N * LENET_B + lo, i * N * LENET_B + lo + nl)
            st, m = step(st, {"image": d.train_images[rows], "label": d.train_labels[rows]},
                         StepDraws())
            key = f"lenet:{name}:{i}"
            out[f"{key}:params"] = ("whole", st.params.flat.numpy().copy())
            out[f"{key}:loss"] = ("whole", m["loss"].numpy().copy())
            for j, t in enumerate(tree_flatten(st.comm_state)[0] + tree_flatten(
                    dataclasses.asdict(st.opt_state))[0]):
                if isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == axis.local_size:
                    out[f"{key}:rows{j}"] = ("local", t.numpy().copy())
    return out


def _child(rank, world, port, inp_path, out_path):
    """One process: every case on its ProcessHybridAxis at each layout,
    the LeNet steps, and the refusal's message, as an npz."""
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.parallel.mesh import ProcessHybridAxis

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        data = dict(np.load(inp_path))
        grads = {k[5:]: v for k, v in data.items() if k.startswith("grad:")}
        res = {}
        for hosts in LAYOUTS:
            grid = ProcessHybridAxis(N, hosts)
            assert grid.local_size == N // int(world) and grid.dcn.local_size == hosts // 2
            res.update(wire_cases(grid, hosts, grads, lambda h: table_draws(data, h)))
        res.update(lenet_steps(ProcessHybridAxis(N, 2)))
        try:
            ProcessHybridAxis(6, 3)
            msg = ""
        except ValueError as e:
            msg = str(e)
        np.savez(out_path, refusal=np.array(msg),
                 **{f"{kind}:{k}": v for k, (kind, v) in res.items()})
    finally:
        dist.destroy_process_group()


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.tobytes()


def _uniform_hier_jax(qkey, per, pid, rnd, shape):
    """Worker (h, c)'s JAX draws for one piece of the hierarchical wire
    (tests/test_torch_hier.py ``_uniform_hier`` at ``per`` workers a
    host)."""
    import jax
    import jax.numpy as jnp

    def one(w):
        k = jax.random.fold_in(jax.random.fold_in(qkey, w // per), w % per)
        k = jax.random.fold_in(k, pid)
        if rnd >= 2:
            k = jax.random.fold_in(k, 2)
        if rnd == 3:
            k = jax.random.fold_in(k, 1)
        return jax.random.uniform(k, shape, jnp.float32)

    return jax.vmap(one)(jnp.arange(N))


@pytest.fixture(scope="module")
def stacked_and_processes(tmp_path_factory):
    """The stacked grid's results (its JAX draws recorded), and the two
    processes' results on the same inputs."""
    import jax

    from tests.test_torch_distributed import _spawn
    from tools.mp_util import free_port

    qkey = jax.random.key(91)
    uniform = jax.jit(_uniform_hier_jax, static_argnums=(1, 2, 3, 4))
    table = {}

    def recording(hosts):
        def draws(pid, rnd, shape):
            key = _draw_key(hosts, pid, rnd, shape)
            if key not in table:
                table[key] = np.array(uniform(qkey, N // hosts, int(pid), rnd,
                                              tuple(int(d) for d in shape)))
            return torch.from_numpy(table[key])

        return draws

    grads = grads_np()
    want = {}
    for hosts in LAYOUTS:
        want.update(wire_cases(make_hybrid_mesh(hosts, N // hosts), hosts, grads, recording))
    want.update(lenet_steps(make_hybrid_mesh(2, N // 2)))
    tmp = tmp_path_factory.mktemp("hier_proc")
    inp = str(tmp / "inputs.npz")
    np.savez(inp, **{f"grad:{k}": v for k, v in grads.items()}, **table)
    port = free_port()
    paths = [str(tmp / f"r{r}.npz") for r in range(2)]
    _spawn([[sys.executable, "-c",
             "import sys; from tests.test_torch_hier_processes import _child as c; "
             "c(*sys.argv[1:])", str(r), "2", str(port), inp, paths[r]] for r in range(2)])
    return dict(want=want, got=[dict(np.load(p)) for p in paths], grads=grads, qkey=qkey,
                table=table)


def _held(res, prefix):
    want, got = res["want"], res["got"]
    names = [k for k in want if k.startswith(prefix)]
    assert names
    for name in names:
        kind, w = want[name]
        parts = [g[f"{kind}:{name}"] for g in got]
        if kind == "whole":
            for part in parts:
                assert _bits(part) == _bits(w), name
        else:
            assert _bits(np.concatenate(parts)) == _bits(w), name


@pytest.mark.parametrize("hosts", LAYOUTS, ids=["1_host_a_process", "2_hosts_a_process"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_hier_processes_wire_bit_for_bit_stacked(stacked_and_processes, hosts, name):
    _held(stacked_and_processes, f"{hosts}:{name}:")


@pytest.mark.parametrize("name", sorted(LENET_CFGS))
def test_torch_hier_processes_lenet_steps_bit_for_bit_stacked(stacked_and_processes, name):
    _held(stacked_and_processes, f"lenet:{name}:")
    want = stacked_and_processes["want"]
    assert np.isfinite(want[f"lenet:{name}:1:loss"][1]).all()
    assert not np.array_equal(want[f"lenet:{name}:0:params"][1],
                              want[f"lenet:{name}:1:params"][1])


def test_torch_hier_processes_refuse_unbalanced_hosts(stacked_and_processes):
    for g in stacked_and_processes["got"]:
        msg = str(g["refusal"])
        assert "3 hosts do not split over 2 processes" in msg and "whole hosts" in msg, msg


@pytest.mark.parametrize("name", JAX_CASES)
def test_torch_hier_processes_4x2_stacked_is_jax(stacked_and_processes, name):
    """At 4 x 2 the stacked grid (which the processes gave bit for bit)
    against JAX's hierarchical wire inside shard_map."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ps_pytorch_tpu.parallel import DCN_AXIS, WORKER_AXIS
    from ps_pytorch_tpu.parallel import collectives as jc
    from ps_pytorch_tpu.parallel import make_hybrid_mesh as jmake_hybrid_mesh

    hosts, axes = 4, (DCN_AXIS, WORKER_AXIS)
    kw = dict(CASES[name])
    ef, count = kw.pop("ef", False), kw.pop("count", None)
    key = jax.random.key(1)
    assert np.array_equal(np.asarray(jax.random.permutation(key, N)), PERM)

    def body(g, c):
        g = jax.tree.map(lambda a: a[0], g)
        out = jc.aggregate_gradients(
            g, axes, N, num_aggregate=c if count is not None else kw.get("num_aggregate"),
            mask_key=key, compress="int8_2round", axis_sizes=(hosts, N // hosts),
            flat_output=True, return_contribution=ef,
            **{k: v for k, v in kw.items() if k != "num_aggregate"})
        if ef:
            return out[0], jax.tree.map(lambda a: a[None], out[1])
        return out, None

    mesh = jmake_hybrid_mesh(num_hosts=hosts, per_host=N // hosts)
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(axes), P()),
                              out_specs=(P(), P(axes)), check_vma=False))
    want_agg, want_c = f(jax.tree.map(jnp.asarray, stacked_and_processes["grads"]),
                         None if count is None else jnp.int32(count))
    want = stacked_and_processes["want"]
    assert _bits(want[f"{hosts}:{name}:agg"][1]) == _bits(np.asarray(want_agg))
    if ef:
        for j, b in enumerate(jax.tree_util.tree_leaves(want_c)):
            assert _bits(want[f"{hosts}:{name}:c{j}"][1]) == _bits(np.asarray(b))


def _cli_argv(train_dir, rank=None, port=None, extra=("--max-steps", "3")):
    argv = [sys.executable, "-m", "ps_pytorch_tpu_torch.cli.train", "--device", "cpu",
            "--network", "LeNet", "--dataset", "MNIST", "--num-workers", "8",
            "--dcn-hosts", "2", "--compress-grad", "2round", "--batch-size", "16",
            "--test-batch-size", "32", "--lr", "0.05", "--momentum", "0.9",
            "--log-interval", "1", "--eval-freq", "3", "--train-dir", str(train_dir),
            *extra]
    if rank is not None:
        argv += ["--coordinator-address", f"localhost:{port}", "--num-processes", "2",
                 "--process-id", str(rank)]
    return argv


def test_torch_hier_processes_cli_train_writes_the_stacked_bytes_jax_evaluates(tmp_path):
    import subprocess

    from tests.test_torch_distributed import REPO, _env, _spawn
    from tools.mp_util import free_port

    one, two = tmp_path / "one", tmp_path / "two"
    port = free_port()
    outs = _spawn([_cli_argv(one)] + [_cli_argv(two, r, port) for r in range(2)])
    for out in outs:
        assert "Step: 3" in out, out[-2000:]
    with open(one / "model_step_3", "rb") as f, open(two / "model_step_3", "rb") as g:
        assert f.read() == g.read()
    ev = subprocess.run([sys.executable, "-m", "ps_pytorch_tpu.cli.evaluate", "--model-dir",
                         str(two), "--network", "LeNet", "--dataset", "MNIST", "--once"],
                        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert ev.returncode == 0, ev.stderr[-2000:]
    assert "Prec@1" in ev.stdout + ev.stderr
    # both resume the grid's checkpoint to step 4: the same bytes again
    resume = ("--max-steps", "4", "--resume")
    port = free_port()
    outs = _spawn([_cli_argv(one, extra=resume)]
                  + [_cli_argv(two, r, port, extra=resume) for r in range(2)])
    for out in outs:
        assert "Step: 4" in out and "Step: 3," not in out, out[-2000:]
    with open(one / "model_step_4", "rb") as f, open(two / "model_step_4", "rb") as g:
        assert f.read() == g.read()
