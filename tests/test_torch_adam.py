"""Port parity: Adam / AMSGrad (ps_pytorch_tpu_torch.optim.adam) against the
JAX package's ``adam`` / ``adam_flat`` on the CPU.

- The update alone: 5 steps of one gradient stream made from a numpy
  seed (magnitudes spread over 1e-6..10, so eps and the bias corrections
  matter), with weight decay and a linear LR schedule, tree and flat
  state, Adam and AMSGrad, the JAX side under ``jax.jit``. XLA-CPU
  contracts ``b1*m + (1-b1)*g`` and ``g + wd*p`` into FMAs, where PyTorch
  rounds each product, and its f32 ``pow`` is its own: so the moments are
  held to 4 ulps of their tensor's largest element, the params to 64 ulps
  each (measured: 107 ulps at most on an element of m that cancels, 3e-8
  of the largest; 26 ulps on a param).
- One LeNet PS step with ``--optimizer adam`` / ``amsgrad``, replicated
  and ZeRO-1, against JAX's ``make_ps_train_step`` on the 8-device CPU
  mesh. The two frameworks' f32 convolutions add in different orders, and
  Adam's first step is ``lr * g / (|g| + eps')``: where ``|g|`` is near
  eps a gradient's last bits move the element's update by a visible part
  of ``lr``. So at most 0.1% of the params may lie beyond 1e-5 of the
  largest move, and none beyond 5% of it (measured: 179 of 431080, 0.04%,
  the largest 1.8%).
- Adam / AMSGrad state JAX -> port -> JAX through ``checkpoint.py``, byte
  for byte, flat replicated and tree ZeRO-1 (JAX's ``count`` per worker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser

from ps_pytorch_tpu import checkpoint as jckpt
from ps_pytorch_tpu.data import make_preprocessor as jpreprocessor
from ps_pytorch_tpu.data import make_synthetic as jmake_synthetic
from ps_pytorch_tpu.models import build_model as jbuild
from ps_pytorch_tpu.optim import adam as jadam
from ps_pytorch_tpu.optim import adam_flat as jadam_flat
from ps_pytorch_tpu.optim import build_optimizer as jbuild_optimizer
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.parallel import init_ps_state as jinit_state
from ps_pytorch_tpu.parallel import make_ps_train_step as jmake_step
from ps_pytorch_tpu.parallel import shard_batch, shard_state, tree_view
from ps_pytorch_tpu.trainer import TrainConfig as JTrainConfig
from ps_pytorch_tpu.trainer import Trainer as JTrainer
from ps_pytorch_tpu_torch import checkpoint as tckpt
from ps_pytorch_tpu_torch.data import make_preprocessor
from ps_pytorch_tpu_torch.models import build_model, cnn_from_jax
from ps_pytorch_tpu_torch.optim import Adam, AdamState, build_optimizer
from ps_pytorch_tpu_torch.optim.schedules import linear_schedule
from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step
from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer
from ps_pytorch_tpu_torch.utils.serialization import to_state_dict
from tests.test_torch_checkpoint import _assert_same, _cfg, _dataset, _file
from tests.test_torch_ps import KEY, N, _batches

SHAPES = {"b": (33,), "w": (64, 33)}
STEPS = 5
MOMENT_ULPS = 4
PARAM_ULPS = 64


def _stream(seed=0):
    rng = np.random.RandomState(seed)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.uniform(-6, 1, size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return p0, grads


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _close_moment(want, got):
    want, got = np.asarray(want), np.asarray(got)
    bound = MOMENT_ULPS * np.spacing(np.float32(np.abs(want).max()))
    assert float(np.abs(want - got).max()) <= bound


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("amsgrad", [False, True])
def test_torch_adam_update_matches_jax(amsgrad, flat):
    p0, grads = _stream()
    kw = dict(weight_decay=1e-2, amsgrad=amsgrad)
    if flat:
        # adam_flat takes one bare vector: the tree's leaves concatenated
        vec = lambda d: np.concatenate([d[k].reshape(-1) for k in SHAPES])
        p0, grads = vec(p0), [vec(g) for g in grads]
        jtx = jadam_flat(optax.linear_schedule(1e-2, 1e-3, 4), **kw)
    else:
        jtx = jadam(optax.linear_schedule(1e-2, 1e-3, 4), **kw)
    ttx = build_optimizer("amsgrad" if amsgrad else "adam", linear_schedule(1e-2, 1e-3, 4),
                          weight_decay=1e-2, flat=flat)
    assert isinstance(ttx, Adam)

    @jax.jit
    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    to_j = lambda t: jax.tree.map(jnp.asarray, t)
    to_t = lambda t: torch.tensor(t) if isinstance(t, np.ndarray) else {
        k: torch.tensor(v) for k, v in t.items()}
    jp, tp = to_j(p0), to_t(p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        jp, js = jstep(jp, js, to_j(g))
        u, ts = ttx.update(to_t(g), ts, tp)
        tp = tp + u if flat else {k: tp[k] + u[k] for k in tp}
    assert isinstance(ts, AdamState) and int(ts.count) == int(js.count) == STEPS
    leaves = (lambda t: [t]) if flat else (lambda t: [t[k] for k in SHAPES])
    for want, got in zip(leaves(jp), leaves(tp)):
        assert int(_ulps(want, got.numpy()).max()) <= PARAM_ULPS
    fields = ["exp_avg", "exp_avg_sq"] + (["max_exp_avg_sq"] if amsgrad else [])
    assert (ts.max_exp_avg_sq is None) == (js.max_exp_avg_sq is None) == (not amsgrad)
    for f in fields:
        for want, got in zip(leaves(getattr(js, f)), leaves(getattr(ts, f))):
            _close_moment(want, got.numpy())


def test_torch_adam_padding_stays_zero():
    """A zero gradient on a zero-padded tail keeps m = v = 0 and moves
    nothing (the flat state's padding)."""
    tx = build_optimizer("amsgrad", 1e-2, weight_decay=0.0)
    p = torch.tensor([1.0, -2.0, 0.0, 0.0])
    s = tx.init(p)
    for _ in range(3):
        u, s = tx.update(torch.tensor([0.5, -0.25, 0.0, 0.0]), s, p)
        p = p + u
    assert p[2:].eq(0).all() and s.exp_avg[2:].eq(0).all() and s.max_exp_avg_sq[2:].eq(0).all()
    assert not torch.equal(p[:2], torch.tensor([1.0, -2.0]))


def _pair(mesh, name, cfg_kw, lr=1e-3):
    """(JAX config, state, step; port state, step; flat params0) on the
    same LeNet weights, both with ``name`` (``tests.test_torch_ps._pair``
    with Adam in place of SGD)."""
    jmodel, tmodel = jbuild("LeNet"), build_model("LeNet")
    jcfg, tcfg = JPSConfig(num_workers=N, **cfg_kw), PSConfig(num_workers=N, **cfg_kw)
    jtx, ttx = jbuild_optimizer(name, lr, flat=True), build_optimizer(name, lr, flat=True)
    js = jinit_state(jmodel, jtx, jcfg, jax.random.key(0), (28, 28, 1))
    params0 = jax.tree.map(np.asarray, jax.device_get(tree_view(js.params)))
    bs0 = jax.tree.map(np.asarray, jax.device_get(js.batch_stats))
    flat0 = np.asarray(js.params.flat)
    js = shard_state(js, mesh, jcfg)
    jstep = jmake_step(jmodel, jtx, jcfg, mesh, preprocess=jpreprocessor("MNIST", train=True),
                       donate=False)
    tp, tbs = cnn_from_jax(params0, bs0, device="cpu")
    ts = init_ps_state(tmodel, ttx, tcfg, params=tp, batch_stats=tbs, device="cpu")
    tstep = make_ps_train_step(tmodel, ttx, tcfg, preprocess=make_preprocessor("MNIST", train=True),
                               device="cpu")
    return jcfg, js, jstep, ts, tstep, flat0


@pytest.mark.parametrize("placement", ["replicated", "sharded"])
@pytest.mark.parametrize("name", ["adam", "amsgrad"])
def test_torch_ps_adam_step_matches_jax(mesh, name, placement):
    jcfg, js, jstep, ts, tstep, flat0 = _pair(mesh, name, dict(opt_placement=placement))
    batch = _batches(1)[0]
    js, jm = jstep(js, shard_batch(batch, mesh, jcfg), KEY)
    ts, tm = tstep(ts, batch)
    want, got = np.asarray(js.params.flat), ts.params.flat.numpy()
    moved = float(np.abs(want - flat0).max())
    d = np.abs(want - got)
    assert float((d > 1e-5 * moved).mean()) <= 1e-3 and float(d.max()) <= 0.05 * moved
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    assert isinstance(ts.opt_state, AdamState) and int(ts.opt_state.count) == 1
    assert (ts.opt_state.max_exp_avg_sq is None) == (name == "adam")
    jm1 = np.asarray(js.opt_state.exp_avg if placement == "sharded"
                     else js.opt_state.exp_avg.flat)
    assert tuple(ts.opt_state.exp_avg.shape) == jm1.shape


@pytest.mark.parametrize("layout,placement,name", [("flat", "replicated", "adam"),
                                                   ("tree", "sharded", "amsgrad")])
def test_torch_adam_checkpoint_jax_to_port_to_jax_bit_exact(tmp_path, layout, placement, name):
    """JAX writes step 3 with Adam state; the port resumes it bit for bit
    and writes JAX's bytes; the port trains to step 4; JAX resumes that
    bit for bit and writes the same bytes."""
    d = tmp_path / "models"
    wire = dict(num_workers=2, compress="int8", state_layout=layout, opt_placement=placement)
    kw = dict(optimizer=name, lr=1e-3, fault_plan=None)
    jt = JTrainer(JTrainConfig(**_cfg(d, **kw)), JPSConfig(**wire),
                  dataset=jmake_synthetic("MNIST", train_size=64, test_size=32, seed=1))
    jt.train()
    jraw = jckpt.load_checkpoint_raw(str(d), 3)
    assert "exp_avg" in jraw["opt_state"]

    pt = Trainer(TrainConfig(**_cfg(d, resume=True, **kw)), PSConfig(**wire),
                 dataset=_dataset(), device="cpu")
    pt.train()
    assert pt.state.step == 3 and isinstance(pt.state.opt_state, AdamState)
    _assert_same(to_state_dict(pt.checkpoint_state()), jraw)
    tckpt.save_checkpoint(pt.checkpoint_state(), str(tmp_path / "port"), 3)
    assert _file(tmp_path / "port", 3) == _file(d, 3)

    pt.tcfg.max_steps = 4
    pt.train()
    assert pt.state.step == 4 and np.isfinite([h["loss"] for h in pt.history]).all()
    jt2 = JTrainer(JTrainConfig(**_cfg(d, **kw)), JPSConfig(**wire),
                   dataset=jmake_synthetic("MNIST", train_size=64, test_size=32, seed=1))
    assert jt2.try_resume() == 4
    jhost = jax.device_get(jt2.state)
    _assert_same(to_state_dict(pt.checkpoint_state()), fser.to_state_dict(jhost))
    jckpt._write_host_state(jhost, str(tmp_path / "jax"), 4, compress=False)
    assert _file(tmp_path / "jax", 4) == _file(d, 4)


@pytest.mark.parametrize("name", ["adam", "amsgrad"])
def test_torch_cli_runs_adam(name):
    """``--optimizer adam|amsgrad`` runs in both CLIs: finite losses, and
    the optimizer state is Adam's (``--momentum`` unused)."""
    from ps_pytorch_tpu_torch.cli import train as cli_train
    from ps_pytorch_tpu_torch.cli import train_lm
    from tests.test_torch_train_lm import SMALL

    lm = train_lm.main(SMALL + ["--device", "cpu", "--optimizer", name, "--lr", "0.001"])
    assert np.isfinite([h["loss"] for h in lm["history"]]).all() and len(lm["history"]) == 3
    out = cli_train.main(["--device", "cpu", "--network", "LeNet", "--num-workers", "2",
                          "--batch-size", "4", "--max-steps", "2", "--optimizer", name,
                          "--lr", "0.001", "--no-checkpoints", "--test-batch-size", "1000"])
    assert np.isfinite([h["loss"] for h in out["history"]]).all()
    st = out["trainer"].state.opt_state
    assert isinstance(st, AdamState) and (st.max_exp_avg_sq is None) == (name == "adam")
