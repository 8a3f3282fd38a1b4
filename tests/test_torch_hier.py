"""The hierarchical DCN x ICI wire of the port (``--dcn-hosts``:
ps_pytorch_tpu_torch.parallel.mesh.HybridWorkerAxis and
collectives.quantized_allreduce_2round_hier) against the JAX package's
(make_hybrid_mesh, collectives.py:513), on the CPU:

- the grid numbers worker (h, c) as ``h * per_host + c``, and a
  sum / max / min / mean over its tuple axis is the flat axis's, bit for
  bit (tests/test_hybrid_mesh.py:60); over one axis it is JAX's;
- ``aggregate_gradients`` on the 2 x 4 grid (the hierarchical two-round
  wire) bit for bit JAX's on the same gradients, in both domains, with
  nearest rounding and with stochastic rounding on JAX's draws, with and
  without EF contributions and buckets, at the full and a masked count,
  the adaptive (device) count too;
- one hierarchical PS step (LeNet, 2 x 4, block 128, and the homomorphic
  wire) against JAX's within tests/test_torch_ps.py's int8 tolerance
  (the gradients differ in their last bits), and the hierarchical
  aggregate within JAX's stated bound of the exact mean
  (tests/test_compression.py:613: 3.5 * max|g| * 1.5 / 127);
- over processes the grid is ``ProcessHybridAxis`` (whole hosts a
  process), whose sizes ``hier_sizes`` takes; the flat process axis is
  refused for a hierarchical config (tests/test_torch_hier_processes.py
  holds the process grid's wire to this file's stacked one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.parallel import DCN_AXIS, WORKER_AXIS, shard_batch
from ps_pytorch_tpu.parallel import collectives as jc
from ps_pytorch_tpu.parallel import make_hybrid_mesh as jmake_hybrid_mesh
from ps_pytorch_tpu_torch.parallel import collectives as tc
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
from ps_pytorch_tpu_torch.parallel.mesh import HybridWorkerAxis, WorkerAxis, make_hybrid_mesh
from ps_pytorch_tpu_torch.parallel.ps import PSConfig, StepDraws, hier_sizes
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_ps import KEY, _batches, _check, _jax_perm, _pair
from tests.test_torch_wires import N, torch_tree, wide_grads


HOSTS, PER = 2, 4
AXES = (DCN_AXIS, WORKER_AXIS)


@pytest.fixture(scope="module")
def hmesh():
    return jmake_hybrid_mesh(num_hosts=HOSTS, per_host=PER)


def test_torch_grid_numbering_and_tuple_reductions(hmesh):
    grid = make_hybrid_mesh(HOSTS, PER)
    assert isinstance(grid, WorkerAxis) and grid.size == N and grid.names == AXES
    assert grid.worker_ids().tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert hmesh.devices.shape == (HOSTS, PER)
    x = torch.from_numpy(np.random.RandomState(0).randn(N, 3, 5).astype(np.float32))
    flat = WorkerAxis(N)
    # the tuple axis is the flat axis, bit for bit
    for op in ("psum", "pmax", "pmin", "pmean"):
        np.testing.assert_array_equal(getattr(grid, op)(x).numpy(),
                                      getattr(flat, op)(x).numpy())

    def body(v):
        v = v[0]
        return (jax.lax.psum(v, DCN_AXIS)[None], jax.lax.pmax(v, WORKER_AXIS)[None],
                jax.lax.pmax(v, AXES))

    f = jax.jit(jax.shard_map(body, mesh=hmesh, in_specs=P(AXES),
                              out_specs=(P(AXES), P(AXES), P()), check_vma=False))
    jd, ji, jall = (np.asarray(a) for a in f(jnp.asarray(x.numpy())))
    xg = x.reshape(HOSTS, PER, 3, 5)
    # over DCN: one value per ICI index; over ICI: one per host
    np.testing.assert_array_equal(grid.dcn.psum(xg).numpy(), jd.reshape(HOSTS, PER, 3, 5)[0])
    np.testing.assert_array_equal(grid.ici.pmax(xg.transpose(0, 1)).numpy(),
                                  ji.reshape(HOSTS, PER, 3, 5)[:, 0])
    np.testing.assert_array_equal(grid.pmax(x).numpy(), jall)
    with pytest.raises(ValueError):
        HybridWorkerAxis(8, hosts=3, per_host=4)


def _uniform_hier(qkey, pid, rnd, shape):
    """Worker (h, c)'s draws for one piece of the hierarchical wire:
    ``fold(fold(fold(qkey, h), c), pid)``, round 2 a further fold 2,
    round 3 fold 2 then 1."""
    def one(w):
        k = jax.random.fold_in(jax.random.fold_in(qkey, w // PER), w % PER)
        k = jax.random.fold_in(k, pid)
        if rnd >= 2:
            k = jax.random.fold_in(k, 2)
        if rnd == 3:
            k = jax.random.fold_in(k, 1)
        return jax.random.uniform(k, shape, jnp.float32)

    return jax.vmap(one)(jnp.arange(N))


_uniform_hier_jit = jax.jit(_uniform_hier, static_argnums=(2, 3))


def hier_draws(qkey):
    def draws(pid, rnd, shape):
        return torch.from_numpy(np.array(_uniform_hier_jit(qkey, pid, rnd, tuple(shape))))

    return draws


QKEY = jax.random.key(77)
CASES = {
    "dequant_b0_leaf": dict(wire_domain="dequant"),
    "dequant_b128_64k_ef": dict(wire_domain="dequant", quant_block_size=128,
                                bucket_bytes=65536, ef=True),
    "dequant_b0_fused_k5": dict(wire_domain="dequant", bucket_bytes=0, num_aggregate=5,
                                ef=True),
    "homomorphic_b0_fused": dict(wire_domain="homomorphic", bucket_bytes=0, ef=True),
    "homomorphic_b128_leaf_k5": dict(wire_domain="homomorphic", quant_block_size=128,
                                     num_aggregate=5),
    "homomorphic_64k_count5": dict(wire_domain="homomorphic", bucket_bytes=65536, count=5,
                                   ef=True),
    "stochastic_b0_64k_ef": dict(quant_rounding="stochastic", bucket_bytes=65536, ef=True),
    "stochastic_b128_leaf": dict(quant_rounding="stochastic", quant_block_size=128, ef=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_hier_2round_bit_for_bit_jax(hmesh, name):
    kw = dict(CASES[name])
    ef, count = kw.pop("ef", False), kw.pop("count", None)
    stochastic = kw.get("quant_rounding") == "stochastic"
    grads = wide_grads(11)

    def body(g, c):
        g = jax.tree.map(lambda a: a[0], g)
        out = jc.aggregate_gradients(
            g, AXES, N, num_aggregate=c if count is not None else kw.get("num_aggregate"),
            mask_key=KEY, compress="int8_2round", axis_sizes=(HOSTS, PER), flat_output=True,
            return_contribution=ef, quant_key=QKEY if stochastic else None,
            **{k: v for k, v in kw.items() if k != "num_aggregate"})
        if ef:
            return out[0], jax.tree.map(lambda a: a[None], out[1])
        return out, None

    f = jax.jit(jax.shard_map(body, mesh=hmesh, in_specs=(P(AXES), P()),
                              out_specs=(P(), P(AXES)), check_vma=False))
    want_agg, want_c = f(jax.tree.map(jnp.asarray, grads),
                         None if count is None else jnp.int32(count))
    perm = torch.from_numpy(np.asarray(jax.random.permutation(KEY, N)).astype(np.int64))
    out = tc.aggregate_gradients(
        torch_tree(grads), make_hybrid_mesh(HOSTS, PER), N,
        num_aggregate=(torch.tensor(count, dtype=torch.int32) if count is not None
                       else kw.get("num_aggregate")),
        perm=perm, compress="int8_2round", flat_output=True, return_contribution=ef,
        quant_draws=hier_draws(QKEY) if stochastic else None,
        **{k: v for k, v in kw.items() if k != "num_aggregate"})
    got_agg, got_c = out if ef else (out, None)
    np.testing.assert_array_equal(got_agg.numpy(), np.asarray(want_agg))
    if ef:
        for a, b in zip(tree_leaves(got_c), jax.tree_util.tree_leaves(want_c)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_torch_hier_aggregate_within_jax_bound_of_exact_mean():
    """tests/test_compression.py:613's envelope, both domains: round 1 and
    two rescales, at most 3 lattice steps of the shared scale."""
    rng = np.random.RandomState(4)
    g = {"a": rng.randn(N, 57, 5).astype(np.float32), "b": rng.randn(N, 301).astype(np.float32)}
    g = {k: v * (1.0 + 0.05 * np.arange(N, dtype=np.float32)).reshape((N,) + (1,) * (v.ndim - 1))
         for k, v in g.items()}
    grid = make_hybrid_mesh(HOSTS, PER)
    for domain in ("homomorphic", "dequant"):
        got = tc.quantized_allreduce_2round_hier(torch_tree(g), grid, float(N),
                                                 wire_domain=domain)
        for k in g:
            bound = 3.5 * float(np.abs(g[k]).max()) * 1.5 / 127.0
            err = float(np.abs(got[k].numpy() - g[k].mean(0)).max())
            assert err <= bound, (domain, k, err, bound)


@pytest.mark.parametrize("kw", [
    dict(compress="int8_2round", quant_block_size=128),
    dict(compress="int8_2round", bucket_bytes=0, wire_domain="homomorphic", num_aggregate=5),
], ids=["dequant_b128", "homomorphic_k5"])
def test_torch_hier_ps_step_matches_jax(hmesh, kw):
    jcfg, js, jstep, ts, tstep, flat0 = _pair(hmesh, dict(kw, dcn_hosts=HOSTS))
    assert jcfg.axis_name == AXES and ts is not None
    for i, batch in enumerate(_batches(2, seed=3)):
        js, jm = jstep(js, shard_batch(batch, hmesh, jcfg), KEY)
        ts, tm = tstep(ts, batch, StepDraws(perm=_jax_perm(i)))
        _check(np.asarray(js.params.flat), ts.params.flat.numpy(), flat0, "int8", i == 0)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-4 * abs(float(jm["loss"]))


def test_torch_hier_config_and_refusal_over_processes():
    cfg = PSConfig(num_workers=N, dcn_hosts=HOSTS, compress="int8_2round")
    assert cfg.axis_name == AXES and cfg.hierarchical
    assert hier_sizes(cfg, make_hybrid_mesh(HOSTS, PER)) == (HOSTS, PER)
    with pytest.raises(ValueError, match="hybrid grid"):
        hier_sizes(cfg, WorkerAxis(N))
    with pytest.raises(ValueError, match="unsupported"):
        PSConfig(num_workers=N, dcn_hosts=HOSTS, compress="int8_2round",
                 opt_placement="sharded")
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.parallel.mesh import (
        ProcessHybridAxis,
        ProcessWorkerAxis,
        initialize_multihost,
    )
    from tools.mp_util import free_port

    assert initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cpu")
    try:
        # over processes: the grid with every host in this one process
        grid = ProcessHybridAxis(N, HOSTS)
        assert hier_sizes(cfg, grid) == (HOSTS, PER)
        assert grid.local_size == N and grid.dcn.local_size == HOSTS
        # pscheck's recording twin keeps the grid and names its sub-axes
        from ps_pytorch_tpu_torch.check.axes import recording_axis

        rec = recording_axis(grid)
        assert isinstance(rec, ProcessHybridAxis) and hier_sizes(cfg, rec) == (HOSTS, PER)
        assert rec.names == AXES and rec.dcn.names == (DCN_AXIS,)
        assert rec.ici.names == (WORKER_AXIS,)
        with pytest.raises(ValueError, match="hybrid grid"):
            hier_sizes(cfg, ProcessWorkerAxis(N))
    finally:
        dist.destroy_process_group()
