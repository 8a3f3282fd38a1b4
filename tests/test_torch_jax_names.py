"""The JAX package's last public names on the port, each against its JAX
function: ``utils.PhaseTimer``, ``models.decode.make_generate``,
``parallel.ulysses.make_ulysses_attention``, ``data.augment.
preprocess_batch``, ``checkpoint.restore_sharded`` (with
``parallel.mesh.place_on_mesh`` and the tp / moe / pp specs),
``ops.codec.native_available``, ``parallel.dp_tp_pp.DP_AXIS`` and
``resilience.retry`` (``DEFAULT_JITTER``, ``retry_io(jitter=, rng=)``).

And the names comparison: every public top-level name of every JAX
module (a def, class or assignment; an ``__init__``'s imports) is an
attribute of its port module, or ROADMAP.md's list of names declared
away names it.
"""

import ast
import importlib
import os
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu import checkpoint as jckpt
from ps_pytorch_tpu.data import augment as jaug
from ps_pytorch_tpu.models import decode as jdec
from ps_pytorch_tpu.models import transformer as jtr
from ps_pytorch_tpu.ops import codec as jcodec
from ps_pytorch_tpu.parallel import dp_tp_pp as jdtp
from ps_pytorch_tpu.parallel import moe as jmoe
from ps_pytorch_tpu.parallel import pp as jpp
from ps_pytorch_tpu.parallel import tp as jtp
from ps_pytorch_tpu.parallel.ring_attention import make_seq_mesh
from ps_pytorch_tpu.parallel.ulysses import make_ulysses_attention as j_make_ulysses
from ps_pytorch_tpu.resilience import retry as jretry
from ps_pytorch_tpu.utils import PhaseTimer as JPhaseTimer
from ps_pytorch_tpu_torch import checkpoint as ckpt
from ps_pytorch_tpu_torch.data import CropFlipDraws, preprocess_batch
from ps_pytorch_tpu_torch.data import datasets as tds
from ps_pytorch_tpu_torch.data import _native
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models import decode as tdec
from ps_pytorch_tpu_torch.models import transformer as ttr
from ps_pytorch_tpu_torch.ops import codec
from ps_pytorch_tpu_torch.parallel import dp_tp_pp, moe, place_on_mesh, pp, tp
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from ps_pytorch_tpu_torch.parallel.ulysses import make_ulysses_attention
from ps_pytorch_tpu_torch.resilience import retry
from ps_pytorch_tpu_torch.utils import PhaseTimer
from tests.test_torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=37, dim=32, depth=2, heads=8, max_seq_len=16)
ROADMAP_SECTION = "**Names of the JAX package with no counterpart**"


def _jax_public_names(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.endswith("__init__.py")
              and node.module not in ("typing", "__future__")):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _declared_away() -> set:
    """The backticked names of ROADMAP.md's section of names declared away."""
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    start = text.index(ROADMAP_SECTION)
    end = re.search(r"\n(\*\*|#)", text[start + len(ROADMAP_SECTION):])
    section = text[start:start + len(ROADMAP_SECTION) + (end.start() if end else len(text))]
    return set(re.findall(r"`([A-Za-z_][A-Za-z0-9_]*)`", section))


def test_torch_every_public_jax_name_has_a_counterpart_or_a_declared_deviation():
    root = os.path.join(REPO, "ps_pytorch_tpu")
    declared = _declared_away()
    missing = {}
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py") or f == "_compat.py":
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3].replace(os.sep, ".")
            rel = rel[: -len(".__init__")] if rel.endswith("__init__") else rel
            port = importlib.import_module("ps_pytorch_tpu_torch" + (f".{rel}" if rel else ""))
            gone = sorted(n for n in _jax_public_names(os.path.join(dirpath, f))
                          if not hasattr(port, n) and n not in declared)
            if gone:
                missing[rel] = gone
    assert not missing, missing
    # each declared name is really missing somewhere (no stale entry)
    assert "restore_sharded" not in declared and "place_on_mesh" not in declared


def test_torch_phase_timer_is_jaxs():
    for cls in (PhaseTimer, JPhaseTimer):
        t = cls()
        for _ in range(2):
            with t.phase("fetch"):
                pass
            with t.phase("step"):
                sum(range(1000))
        assert sorted(t.durations) == ["fetch", "step"]
        assert all(v >= 0 for v in t.durations.values())
        assert t.total >= sum(t.durations.values())
        t.reset()
        assert t.durations == {} and t.total < 1.0


@pytest.fixture(scope="module")
def lm_weights():
    jcfg = jtr.TransformerConfig(**SHAPE)
    jparams = jtr.init_transformer(jcfg, jax.random.key(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, ttr.TransformerConfig(**SHAPE), tparams


def test_torch_make_generate_is_jaxs(lm_weights):
    jcfg, jparams, tcfg, tparams = lm_weights
    prompt = np.random.RandomState(3).randint(0, SHAPE["vocab_size"], (2, 5)).astype(np.int32)
    want = np.asarray(jdec.make_generate(jcfg, 6)(jparams, jnp.asarray(prompt),
                                                   jax.random.key(0)))
    got = tdec.make_generate(tcfg, 6, device="cpu")(tparams, torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)
    sample = tdec.make_generate(tcfg, 4, temperature=0.7, device="cpu")
    a, b = (sample(tparams, torch.from_numpy(prompt), torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (2, 9)


@pytest.mark.parametrize("causal", [False, True])
def test_torch_make_ulysses_attention_is_jaxs(causal):
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3))
    want = np.asarray(j_make_ulysses(make_seq_mesh(4), causal=causal)(
        *(jnp.asarray(x) for x in (q, k, v))))
    got = make_ulysses_attention(WorkerAxis(4), causal=causal)(
        *(torch.from_numpy(x) for x in (q, k, v)))
    assert got.shape == (2, 16, 4, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name,augment", [("Cifar10", True), ("SVHN", True), ("MNIST", False)])
def test_torch_preprocess_batch_is_jitted_jaxs_on_jaxs_draws(name, augment):
    images = tds.make_synthetic(name, train_size=16, test_size=2).train_images
    mean, std = tds.NORM_STATS[name]
    pad_mode = tds.PAD_MODE.get(name, "reflect")
    key = jax.random.key(11)

    def jfn(k, x):
        return jaug.preprocess_batch(k, x, mean, std, augment, pad_mode)

    want = np.asarray(jax.jit(jfn)(key, jnp.asarray(images)))
    draws = None
    if augment:  # JAX's own draws, as augment.py:31-41 makes them
        kc, kf = jax.random.split(key)
        offs = np.asarray(jax.random.randint(kc, (16, 2), 0, 9)).astype(np.int64)
        flips = np.array(jax.random.bernoulli(kf, 0.5, (16,)))
        draws = CropFlipDraws(torch.from_numpy(offs), torch.from_numpy(flips))
    got = preprocess_batch(torch.from_numpy(images), mean, std, augment, draws, pad_mode)
    # XLA-CPU contracts normalize's x / 255 - mean into an FMA where the
    # port rounds twice: half an ulp of x / 255 (<= 1) and of the
    # difference, times 1 / std, plus the last product's half ulp
    eps = np.finfo(np.float32).eps
    bound = eps * (float(np.max(1.0 / np.asarray(std))) + np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)
    if augment:
        with pytest.raises(ValueError, match="draws"):
            preprocess_batch(torch.from_numpy(images), mean, std, True)


def _shards(arr, dim: int) -> np.ndarray:
    """A JAX array's addressable shards stacked in the order of their
    slice of ``dim``."""
    parts = sorted(arr.addressable_shards, key=lambda s: s.index[dim].start or 0)
    return np.stack([np.asarray(s.data) for s in parts])


def _port_tree(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def test_torch_restore_sharded_places_jaxs_tp_checkpoint_as_jax_does(tmp_path, lm_weights):
    jcfg, jparams, tcfg, _ = lm_weights
    ptp = jtp.shard_params_tp(jcfg, jtp.to_tp_layout(jcfg, jparams), jtp.make_tp_mesh(8))
    jckpt.save_checkpoint({"params": ptp}, str(tmp_path), 1)
    jspecs = jtp.tp_param_specs(jcfg)
    zeros = jax.tree.map(jnp.zeros_like, jtp.to_tp_layout(jcfg, jparams))
    want = jckpt.restore_sharded({"params": zeros}, str(tmp_path), 1, jtp.make_tp_mesh(4),
                                 {"params": jspecs})["params"]
    target = {"params": _port_tree(jax.tree.map(np.asarray, zeros))}
    got = ckpt.restore_sharded(target, str(tmp_path), 1, WorkerAxis(4),
                               {"params": tp.tp_param_specs(tcfg)})["params"]
    dims = tp.tp_param_specs(tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g, d = got, dims
        for p in path:
            key = p.key if hasattr(p, "key") else p.idx
            g, d = g[key], d[key]
        if d is None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(leaf))
        else:
            assert g.shape[0] == 4
            np.testing.assert_array_equal(g.numpy(), _shards(leaf, d))
    # the placement is shard_params_tp's
    loaded = ckpt.load_checkpoint(target, str(tmp_path), 1)["params"]
    again = tp.shard_params_tp(tcfg, loaded, WorkerAxis(4))
    for a, b in zip(jax.tree.leaves(_np(again)), jax.tree.leaves(_np(got))):
        np.testing.assert_array_equal(a, b)


def _np(tree):
    return jax.tree.map(lambda x: x.numpy(), tree)


def test_torch_restore_sharded_places_jaxs_moe_and_pp_checkpoints(tmp_path, lm_weights):
    jcfg, jparams, tcfg, _ = lm_weights
    mcfg = jmoe.MoEConfig(num_experts=4)
    mparams = jmoe.init_moe_params(jcfg, mcfg, jax.random.key(2))
    jckpt.save_checkpoint({"params": mparams}, str(tmp_path / "moe"), 3)
    zeros = jax.tree.map(jnp.zeros_like, mparams)
    want = jckpt.restore_sharded({"params": zeros}, str(tmp_path / "moe"), 3,
                                 jmoe.make_ep_mesh(2), {"params": jmoe.moe_param_specs(jcfg)})
    got = ckpt.restore_sharded({"params": _port_tree(zeros)}, str(tmp_path / "moe"), 3,
                               WorkerAxis(2), {"params": moe.moe_param_specs(tcfg)})
    for b, (jb, tb) in enumerate(zip(want["params"]["blocks"], got["params"]["blocks"])):
        for k, leaf in jb.items():
            if k in moe.EXPERT_LEAVES:
                np.testing.assert_array_equal(tb[k].numpy(), _shards(leaf, 0))
                # shard_params_moe's views hold the same values
                view = moe.shard_params_moe(tcfg, _port_tree(mparams), WorkerAxis(2))
                assert torch.equal(view["blocks"][b][k], tb[k])
            else:
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(leaf))
    ppl = jpp.to_pp_layout(jcfg, jparams)
    jckpt.save_checkpoint({"params": ppl}, str(tmp_path / "pp"), 5)
    zeros = jax.tree.map(jnp.zeros_like, ppl)
    want = jckpt.restore_sharded({"params": zeros}, str(tmp_path / "pp"), 5,
                                 jpp.make_pp_mesh(2), {"params": jpp.pp_param_specs(jcfg)})
    got = ckpt.restore_sharded({"params": _port_tree(zeros)}, str(tmp_path / "pp"), 5,
                               WorkerAxis(2), {"params": pp.pp_param_specs(tcfg)})
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(_np(got))):
        np.testing.assert_array_equal(g, np.asarray(w))  # the stage grid's [depth, ...] tree


def test_torch_place_on_mesh_refuses_what_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        place_on_mesh({"w": torch.zeros(6, 5)}, WorkerAxis(4), {"w": 0})
    out = place_on_mesh({"w": torch.arange(8.0).reshape(2, 4), "b": None, "s": 3},
                        WorkerAxis(2), {"w": 1, "b": 0, "s": None})
    assert out["w"].tolist() == [[[0.0, 1.0], [4.0, 5.0]], [[2.0, 3.0], [6.0, 7.0]]]
    assert out["b"] is None and out["s"] == 3


def test_torch_native_available_is_jaxs(monkeypatch):
    assert codec.native_available() == jcodec.native_available() is True

    def fail(*a, **kw):
        raise _native.NativeBuildError("no compiler")

    monkeypatch.setattr(codec, "_lib", None)
    monkeypatch.setattr(_native, "build", fail)
    assert codec.native_available() is False


def test_torch_dp_axis_is_jaxs():
    assert dp_tp_pp.DP_AXIS == jdtp.DP_AXIS


@pytest.mark.parametrize("jitter", [0.0, 0.25, 1.5])
def test_torch_retry_io_sleeps_jaxs_schedule(monkeypatch, jitter):
    assert retry.DEFAULT_JITTER == jretry.DEFAULT_JITTER
    sleeps = {}
    for name, mod in (("port", retry), ("jax", jretry)):
        got = sleeps.setdefault(name, [])
        monkeypatch.setattr(mod.time, "sleep", got.append)
        calls = iter(range(10))

        def flaky():
            if next(calls) < 3:
                raise OSError("EIO")
            return "ok"

        assert mod.retry_io(flaky, "x", attempts=5, base_delay_s=0.01, jitter=jitter,
                            rng=random.Random(9)) == "ok"
    assert sleeps["port"] == sleeps["jax"] and len(sleeps["port"]) == 3
    if jitter == 0.0:
        assert sleeps["port"] == [0.01, 0.02, 0.04]
    for mod in (retry, jretry):
        with pytest.raises(ValueError, match="jitter"):
            mod.retry_io(lambda: 1, "x", jitter=-0.1)


def test_torch_retry_io_default_rng_spreads_within_the_bound(monkeypatch):
    got = []
    monkeypatch.setattr(retry.time, "sleep", got.append)
    with pytest.raises(OSError):
        retry.retry_io(lambda: (_ for _ in ()).throw(OSError("EIO")), "x", attempts=4,
                       base_delay_s=0.1)
    base = [0.1, 0.2, 0.4]
    assert all(b <= g <= b * (1 + retry.DEFAULT_JITTER) for g, b in zip(got, base))


def test_torch_restore_sharded_spec_tree_of_the_jax_specs_has_the_same_cut_dims(lm_weights):
    """The port's spec trees name the dims JAX's PartitionSpecs cut."""
    jcfg, _, tcfg, _ = lm_weights

    def dims(spec):
        return None if spec == P() else next(i for i, a in enumerate(spec) if a is not None)

    for jspec, tspec in ((jtp.tp_param_specs(jcfg), tp.tp_param_specs(tcfg)),
                         (jmoe.moe_param_specs(jcfg), moe.moe_param_specs(tcfg))):
        jl = jax.tree.leaves(jspec, is_leaf=lambda x: isinstance(x, P))
        tl = jax.tree.leaves(tspec, is_leaf=lambda x: x is None)
        assert [dims(s) for s in jl] == tl
