"""The resume-reshape of the port (ps_pytorch_tpu_torch.resilience.elastic,
trainer._restore_step) against the JAX package's (resilience/elastic.py,
tests/test_elastic.py), on the CPU:

- ``needs_reshape`` over the JAX test's matrix of geometry pairs, equal;
- the ZeRO-1 region carving: the port's host-side inversion round-trips
  multi-bucket plans and equals the step's own ``_worker_region``, and
  both packages carve the same bits;
- EF redistribution (sum kept over a power-of-two M) and local BN
  mean / broadcast, bit for bit JAX's;
- ``reshape_raw_state`` of ONE raw dict by both packages, equal bit for
  bit in every field, across a replicated -> sharded shrink, a sharded
  grow with a new carving, a carving-only change with EF (residuals pass
  through) and a bn-only change on a hand-built state;
- a JAX-written 8-worker ZeRO-1 checkpoint resumed by the port on 4
  workers: the state equals JAX's own resume of it;
- the SIGTERM drill through ``cli.train``: ZeRO-1 on 8 workers stopped
  at step 3, resumed on 4 with another ``--bucket-bytes``, then on 8
  again; each resume reshapes, writes a ``resume_reshape`` record and
  continues the step count.

The tolerance is zero everywhere (the reshape is numpy on both sides).
LeNet, batch 8, at most 6 steps.
"""

import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from ps_pytorch_tpu import checkpoint as jckpt
from ps_pytorch_tpu.data import make_synthetic as jmake_synthetic
from ps_pytorch_tpu.models import build_model as jbuild_model
from ps_pytorch_tpu.optim import build_optimizer as jbuild_optimizer
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.parallel import init_ps_state as jinit_ps_state
from ps_pytorch_tpu.parallel.buckets import tree_layout as jtree_layout
from ps_pytorch_tpu.resilience import elastic as jelastic
from ps_pytorch_tpu.trainer import TrainConfig as JTrainConfig
from ps_pytorch_tpu.trainer import Trainer as JTrainer
from ps_pytorch_tpu_torch import checkpoint as ckpt
from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.data import make_synthetic
from ps_pytorch_tpu_torch.parallel.buckets import tree_layout
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from ps_pytorch_tpu_torch.parallel.ps import PSConfig, PSTrainState, _worker_region
from ps_pytorch_tpu_torch.resilience import elastic
from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer
from ps_pytorch_tpu_torch.utils.serialization import to_state_dict
from tests.test_torch_one_thread import _one_thread  # noqa: F401


def _assert_dicts_equal(a, b, path="."):
    """Two state dicts, key for key, leaf for leaf, bit for bit."""
    if isinstance(a, dict) or isinstance(b, dict):
        assert isinstance(a, dict) and isinstance(b, dict), path
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_dicts_equal(a[k], b[k], f"{path}/{k}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.shape == y.shape and x.dtype == y.dtype, (path, x.shape, y.shape, x.dtype, y.dtype)
    assert np.array_equal(x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8)), path


GEOMS = [
    dict(num_workers=8), dict(num_workers=4), dict(num_workers=8, opt_placement="sharded"),
    dict(num_workers=4, opt_placement="sharded"), dict(num_workers=8, bucket_bytes=65536),
    dict(num_workers=8, opt_placement="sharded", bucket_bytes=65536),
    dict(num_workers=8, opt_placement="sharded", compress="int8", quant_block_size=32),
    dict(num_workers=8, compress="int8", error_feedback=True),
    dict(num_workers=4, compress="int8", error_feedback=True),
    dict(num_workers=8, bn_mode="local"), dict(num_workers=4, bn_mode="local"),
]


def test_torch_needs_reshape_matrix_matches_jax():
    for a in GEOMS:
        for b in GEOMS:
            got = elastic.needs_reshape(elastic.MeshGeometry(**a), elastic.MeshGeometry(**b))
            want = jelastic.needs_reshape(jelastic.MeshGeometry(**a),
                                          jelastic.MeshGeometry(**b))
            assert got == want, (a, b)


def test_torch_worker_region_roundtrip_matches_jax_and_the_step():
    geom = elastic.MeshGeometry(num_workers=4, opt_placement="sharded", compress="int8",
                                quant_block_size=8, bucket_bytes=512)
    jgeom = jelastic.MeshGeometry(**{k: v for k, v in geom.to_json().items() if k != "version"})
    total = 301
    plan, jplan = elastic._sharded_plan(geom, total), jelastic._sharded_plan(jgeom, total)
    assert plan.n_buckets > 1 and (plan.starts, plan.sizes) == (jplan.starts, jplan.sizes)
    flat = np.random.RandomState(0).randn(plan.padded_total).astype(np.float32)
    stacked = elastic._flat_to_regions(flat, plan, 4)
    _assert_dicts_equal(stacked, jelastic._flat_to_regions(flat, jplan, 4))
    _assert_dicts_equal(elastic._regions_to_flat(stacked, plan, 4), flat)
    _assert_dicts_equal(jelastic._regions_to_flat(stacked, jplan, 4), flat)
    # the host carving is the step's _worker_region, row for row
    got = _worker_region(torch.from_numpy(flat), plan, 4, WorkerAxis(4)).numpy()
    _assert_dicts_equal(got, stacked)


def test_torch_ef_and_bn_redistribution_match_jax():
    rng = np.random.RandomState(2)
    raw = {"w": rng.randn(8, 5, 3).astype(np.float32), "b": rng.randn(8, 3).astype(np.float32)}
    tree = {"w": torch.zeros(5, 3), "b": torch.zeros(3)}
    layout = tree_layout(tree)
    jlayout = jtree_layout({k: np.zeros(v.shape, np.float32) for k, v in tree.items()})
    for src, dst in [(dict(num_workers=8), dict(num_workers=4)),
                     (dict(num_workers=8), dict(num_workers=4, opt_placement="sharded"))]:
        kw = dict(compress="int8", error_feedback=True)
        s, d = elastic.MeshGeometry(**src, **kw), elastic.MeshGeometry(**dst, **kw)
        js, jd = jelastic.MeshGeometry(**src, **kw), jelastic.MeshGeometry(**dst, **kw)
        out = elastic._ef_from_canonical(elastic._ef_to_canonical(raw, s, layout), d, layout)
        want = jelastic._ef_from_canonical(jelastic._ef_to_canonical(raw, js, jlayout), jd,
                                           jlayout)
        _assert_dicts_equal(out, want)
        if d.opt_placement != "sharded":
            # power-of-two M: the sum is kept exactly
            for k in raw:
                np.testing.assert_array_equal(out[k].sum(0), raw[k].sum(0))
    stats = {"bn": {"mean": rng.randn(8, 16).astype(np.float32)}}
    out = elastic._bn_from_canonical(elastic._bn_to_canonical(stats, True), True, 4)
    _assert_dicts_equal(out, jelastic._bn_from_canonical(jelastic._bn_to_canonical(stats, True),
                                                          True, 4))
    assert out["bn"]["mean"].shape == (4, 16)


# ------------------------------------------------- one raw dict, both reshapes

def _fill(node, rng):
    """Random f32 values in every float leaf of a state dict."""
    if isinstance(node, dict):
        return {k: _fill(v, rng) for k, v in node.items()}
    if node is None:
        return None
    arr = np.asarray(node)
    if arr.dtype == np.float32:
        return rng.randn(*arr.shape).astype(np.float32)
    return node


def _jax_raw(kw, seed):
    """A raw checkpoint dict in ``kw``'s geometry with random moments and
    residuals (the reshape reads only shapes and values)."""
    cfg = JPSConfig(**kw)
    model = jbuild_model("LeNet", num_classes=10)
    tx = jbuild_optimizer("sgd", 0.05, momentum=0.9, flat=cfg.state_layout == "flat")
    st = jax.device_get(jinit_ps_state(model, tx, cfg, jax.random.key(seed), (1, 28, 28, 1)))
    raw = serialization.msgpack_restore(serialization.to_bytes(st))
    rng = np.random.RandomState(seed)
    for k in ("opt_state", "comm_state"):
        raw[k] = _fill(raw[k], rng)
    return raw


def _jax_target(kw):
    cfg = JPSConfig(**kw)
    model = jbuild_model("LeNet", num_classes=10)
    tx = jbuild_optimizer("sgd", 0.05, momentum=0.9, flat=cfg.state_layout == "flat")
    return jax.device_get(jinit_ps_state(model, tx, cfg, jax.random.key(99), (1, 28, 28, 1)))


def _port_trainer(kw, tmp_path=None, resume=False):
    ds = make_synthetic("MNIST", train_size=64, test_size=32, seed=1)
    tcfg = TrainConfig(network="LeNet", dataset="MNIST", batch_size=8, test_batch_size=32,
                       max_steps=4, lr=0.05, momentum=0.9, eval_freq=2, log_interval=1,
                       save_checkpoints=tmp_path is not None, resume=resume,
                       train_dir=str(tmp_path) if tmp_path is not None else "unused")
    return Trainer(tcfg, PSConfig(**kw), dataset=ds, device="cpu")


EF = dict(compress="int8", quant_block_size=32, error_feedback=True)
CASES = {
    "replicated_to_sharded_shrink": (dict(num_workers=8, **EF),
                                     dict(num_workers=4, opt_placement="sharded",
                                          bucket_bytes=4096, **EF)),
    "sharded_grow_recarve": (dict(num_workers=4, opt_placement="sharded", bucket_bytes=4096),
                             dict(num_workers=8, opt_placement="sharded")),
    "carving_only_ef_passes": (dict(num_workers=4, opt_placement="sharded",
                                    bucket_bytes=4096, **EF),
                               dict(num_workers=4, opt_placement="sharded", bucket_bytes=0,
                                    **EF)),
    "sharded_to_replicated_tree": (dict(num_workers=8, opt_placement="sharded", **EF),
                                   dict(num_workers=2, state_layout="tree", **EF)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_reshape_raw_state_bit_for_bit_jax(case):
    src_kw, dst_kw = CASES[case]
    raw = _jax_raw(src_kw, seed=len(case))
    src = elastic.geometry_of(PSConfig(**src_kw))
    assert elastic.needs_reshape(src, elastic.geometry_of(PSConfig(**dst_kw)))
    want = jelastic.reshape_raw_state(
        dict(raw), jelastic.geometry_of(JPSConfig(**src_kw)), JPSConfig(**dst_kw),
        _jax_target(dst_kw))
    target = _port_trainer(dst_kw).checkpoint_state()
    got = elastic.reshape_raw_state(dict(raw), src, PSConfig(**dst_kw), target)
    _assert_dicts_equal(got, want)
    # and it restores into the port's target
    restored = ckpt.restore_from_raw(target, got, 0)
    _assert_dicts_equal(to_state_dict(restored.params), raw["params"])
    if case == "carving_only_ef_passes":
        _assert_dicts_equal(got["comm_state"], raw["comm_state"])


def test_torch_reshape_bn_only_passes_and_shrinks_like_jax():
    """Local BN stats pass through a carving-only change and are
    averaged and broadcast on a shrink (hand-built states, as JAX's test:
    no small BN model)."""
    from ps_pytorch_tpu.parallel.ps import PSTrainState as JPSTrainState

    kw = dict(opt_placement="sharded", bn_mode="local")
    rng = np.random.RandomState(13)
    params = {"w": rng.randn(8).astype(np.float32)}

    def jstate(n, bucket_bytes, seed):
        r = np.random.RandomState(seed)
        shard = jelastic._sharded_plan(
            jelastic.geometry_of(JPSConfig(num_workers=n, bucket_bytes=bucket_bytes, **kw)),
            8).padded_total // n
        return JPSTrainState(step=np.int32(1), params=dict(params),
                             opt_state={"count": np.zeros((n,), np.int32),
                                        "momentum_buffer": r.randn(n, shard).astype(np.float32)},
                             batch_stats={"bn": {"mean": r.randn(n, 5).astype(np.float32)}},
                             comm_state=None, guard_state=None)

    def pstate(js):
        return PSTrainState(step=js.step, params={"w": torch.from_numpy(js.params["w"])},
                            opt_state=js.opt_state, batch_stats=js.batch_stats)

    raw = serialization.msgpack_restore(serialization.to_bytes(jstate(4, 4096, 1)))
    src_cfg = dict(num_workers=4, bucket_bytes=4096, **kw)
    for dst in (dict(num_workers=4, bucket_bytes=0, **kw), dict(num_workers=2, **kw)):
        tgt = jstate(dst["num_workers"], dst.get("bucket_bytes"), 2)
        want = jelastic.reshape_raw_state(dict(raw), jelastic.geometry_of(JPSConfig(**src_cfg)),
                                          JPSConfig(**dst), tgt)
        got = elastic.reshape_raw_state(dict(raw), elastic.geometry_of(PSConfig(**src_cfg)),
                                        PSConfig(**dst), pstate(tgt))
        _assert_dicts_equal(got, want)
    _assert_dicts_equal(got["batch_stats"]["bn"]["mean"][1],
                        np.asarray(raw["batch_stats"]["bn"]["mean"]).mean(0))


def test_torch_resumes_a_jax_zero1_checkpoint_on_4_workers_as_jax_does(tmp_path):
    """A checkpoint the JAX trainer's own writer and manifest wrote on 8
    ZeRO-1 workers (random moments and EF rows: no step is compiled),
    resumed on 4 workers with another carving by both packages."""
    d = str(tmp_path / "m")
    wire = dict(opt_placement="sharded", bucket_bytes=4096, **EF)
    jcfg = dict(network="LeNet", dataset="MNIST", batch_size=8, max_steps=2, eval_freq=100,
                log_interval=1, lr=0.05, momentum=0.9, train_dir=d)
    jds = jmake_synthetic("MNIST", train_size=64, test_size=32, seed=1)
    j8 = JTrainer(JTrainConfig(**jcfg), JPSConfig(num_workers=8, **wire), dataset=jds)
    host = jax.device_get(j8.state)
    sd = serialization.to_state_dict(host)
    rng = np.random.RandomState(3)
    sd["opt_state"], sd["comm_state"] = _fill(sd["opt_state"], rng), _fill(sd["comm_state"], rng)
    sd["step"] = np.asarray(2, np.int32)
    jckpt.save_checkpoint(serialization.from_state_dict(host, sd), d, 2)
    j8._record_geometry(2)
    j4 = JTrainer(JTrainConfig(**dict(jcfg, resume=True)),
                  JPSConfig(num_workers=4, **dict(wire, bucket_bytes=0)), dataset=jds)
    assert j4.try_resume() == 2
    t4 = _port_trainer(dict(num_workers=4, **dict(wire, bucket_bytes=0)), tmp_path / "m",
                       resume=True)
    assert t4.try_resume() == 2 and t4.state.step == 2
    want = serialization.to_state_dict(jax.device_get(j4.state))
    _assert_dicts_equal(to_state_dict(t4.checkpoint_state()), want)


def test_torch_sigterm_drill_shrink_then_grow(tmp_path):
    d = str(tmp_path / "m")
    common = ["--device", "cpu", "--network", "LeNet", "--dataset", "MNIST", "--batch-size",
              "8", "--opt-placement", "sharded", "--compress-grad", "compress",
              "--error-feedback", "--eval-freq", "100", "--log-interval", "1",
              "--train-dir", d, "--test-batch-size", "64"]
    out = cli_train.main(common + ["--num-workers", "8", "--max-steps", "30",
                                   "--bucket-bytes", "4096",
                                   "--fault-plan", '{"sigterm": 3}'])
    assert out["trainer"].stop_requested and ckpt.latest_valid_step(d) == 3
    assert elastic.load_geometry(d).num_workers == 8
    mf4 = str(tmp_path / "shrink.jsonl")
    out = cli_train.main(common + ["--num-workers", "4", "--max-steps", "5", "--resume",
                                   "--bucket-bytes", "0", "--metrics-file", mf4])
    assert np.isfinite(out["train"]["loss"]) and ckpt.latest_valid_step(d) == 5
    events = [json.loads(x) for x in open(mf4)]
    rr = next(e for e in events if e["kind"] == "resume_reshape")
    assert (rr["step"], rr["from"]["num_workers"], rr["to"]["num_workers"]) == (3, 8, 4)
    assert rr["from"]["bucket_bytes"] == 4096 and rr["to"]["bucket_bytes"] == 0
    assert next(e for e in events if e["kind"] == "train")["step"] == 4
    assert elastic.load_geometry(d).num_workers == 4
    mf8 = str(tmp_path / "grow.jsonl")
    out = cli_train.main(common + ["--num-workers", "8", "--max-steps", "6", "--resume",
                                   "--metrics-file", mf8])
    assert np.isfinite(out["train"]["loss"]) and ckpt.latest_valid_step(d) == 6
    rr8 = next(json.loads(x) for x in open(mf8) if json.loads(x)["kind"] == "resume_reshape")
    assert (rr8["from"]["num_workers"], rr8["to"]["num_workers"]) == (4, 8)
