"""Checkpoint integrity, resume rules and the polling evaluator of the port
(ps_pytorch_tpu_torch.checkpoint, trainer, cli.evaluate), on the CPU, as
the JAX package's tests/test_resilience.py holds its own:

- a truncated newest file (the ``ckpt_corrupt`` fault) is quarantined to
  ``*.corrupt`` and the resume falls back to the older step;
  ``ckpt_write_fail`` surfaces as CheckpointWriteError; a trailer-less
  file loads (the compressed ``PSCK`` form: tests/test_torch_codec.py);
  ``poll_checkpoints`` yields new steps in order, skips
  an unreadable one and stops at its timeout; resuming a finished run
  takes no step; a manifest of another geometry is reshaped, and EF
  residuals into a run with EF off are refused;
- the evaluator on a directory the JAX trainer wrote agrees with JAX's
  Evaluator (loss within the logits tolerance of
  tests/test_torch_cnn_models.py, 2e-5 relative; Prec@1 / Prec@5 equal),
  and averages worker-stacked BN stats (``bn_mode local``) as JAX's does.

LeNet, 2 workers, batch 8, at most 4 steps.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import checkpoint as jckpt
from ps_pytorch_tpu.cli.evaluate import Evaluator as JEvaluator
from ps_pytorch_tpu.data import make_synthetic as jmake_synthetic
from ps_pytorch_tpu.models import init_model as jinit
from ps_pytorch_tpu.models.resnet import BasicBlock as JBasic
from ps_pytorch_tpu.models.resnet import ResNet as JResNet
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.trainer import TrainConfig as JTrainConfig
from ps_pytorch_tpu.trainer import Trainer as JTrainer
from ps_pytorch_tpu_torch import checkpoint as ckpt
from ps_pytorch_tpu_torch.cli import evaluate as cli_evaluate
from ps_pytorch_tpu_torch.cli import single_machine
from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.cli.evaluate import Evaluator
from ps_pytorch_tpu_torch.data import make_synthetic
from ps_pytorch_tpu_torch.models import BasicBlock, ResNet
from ps_pytorch_tpu_torch.parallel.ps import PSConfig
from ps_pytorch_tpu_torch.resilience import elastic
from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer
from ps_pytorch_tpu_torch.utils.serialization import packb, to_state_dict
from tests.test_torch_one_thread import _one_thread  # noqa: F401


LOSS_RTOL = 2e-5  # tests/test_torch_cnn_models.py's logits tolerance


def _tcfg(tmp_path, **kw):
    base = dict(network="LeNet", dataset="MNIST", batch_size=8, test_batch_size=32,
                epochs=4, max_steps=4, lr=0.01, momentum=0.9, eval_freq=2,
                log_interval=1, train_dir=str(tmp_path / "models"))
    base.update(kw)
    return TrainConfig(**base)


def _trainer(tcfg, **pkw):
    ds = make_synthetic("MNIST", train_size=64, test_size=32, seed=1)
    return Trainer(tcfg, PSConfig(num_workers=2, **pkw), dataset=ds, device="cpu")


def test_torch_resume_quarantines_a_truncated_newest_checkpoint(tmp_path):
    _trainer(_tcfg(tmp_path, fault_plan='{"ckpt_corrupt": [4]}')).train()
    d = str(tmp_path / "models")
    assert ckpt.available_steps(d) == [2, 4]
    with pytest.raises(ckpt.CheckpointCorruptError):  # the trailer went with the tail
        ckpt.verify_checkpoint(d, 4)
    assert ckpt.latest_valid_step(d) == 2
    step, raw = ckpt.load_latest_valid(d)
    assert step == 2 and int(raw["step"]) == 2 and ckpt.load_latest_valid(d, after_step=2) is None
    t = _trainer(_tcfg(tmp_path, resume=True))
    assert t.try_resume() == 2 and t.state.step == 2
    assert ckpt.available_steps(d) == [2]
    assert os.path.exists(os.path.join(d, "model_step_4.corrupt"))


def test_torch_checkpoint_write_failure_surfaces(tmp_path):
    t = _trainer(_tcfg(tmp_path, fault_plan='{"ckpt_write_fail": [2]}'))
    with pytest.raises(ckpt.CheckpointWriteError, match="step 2") as e:
        t.train()
    assert e.value.step == 2
    assert ckpt.available_steps(str(tmp_path / "models")) == []


def test_torch_trailer_less_checkpoint_loads(tmp_path):
    t = _trainer(_tcfg(tmp_path, max_steps=2, save_checkpoints=False))
    t.train()
    d = str(tmp_path / "legacy")
    os.makedirs(d)
    with open(ckpt.checkpoint_path(d, 2), "wb") as f:
        f.write(packb(to_state_dict(t.checkpoint_state())))
    ckpt.verify_checkpoint(d, 2)
    t2 = _trainer(_tcfg(tmp_path, train_dir=d, resume=True))
    assert t2.try_resume() == 2
    assert torch.equal(t2.state.params.flat, t.state.params.flat)
    # a damaged trailer-less file is corrupt, not a crash
    with open(ckpt.checkpoint_path(d, 3), "wb") as f:
        f.write(packb(to_state_dict(t.checkpoint_state()))[:1000])
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_checkpoint(d, 3)


def test_torch_poll_checkpoints_in_order_skips_unreadable_and_times_out(tmp_path):
    d = str(tmp_path / "models")
    _trainer(_tcfg(tmp_path)).train()
    with open(ckpt.checkpoint_path(d, 3), "wb") as f:
        f.write(b"PSC1" + b"\0" * 3)  # listed, never readable
    got = list(ckpt.poll_checkpoints(d, interval_s=0.01, timeout_s=0.05,
                                     validate_attempts=2, validate_delay_s=0.001))
    assert got == [2, 4]
    assert list(ckpt.poll_checkpoints(d, start_after=4, interval_s=0.01,
                                      timeout_s=0.03)) == []


def test_torch_resuming_a_finished_run_takes_no_step(tmp_path):
    d = str(tmp_path / "models")
    _trainer(_tcfg(tmp_path)).train()
    mtime = os.path.getmtime(ckpt.checkpoint_path(d, 4))
    t = _trainer(_tcfg(tmp_path, resume=True))
    assert t.train() == {} and t.state.step == 4 and t.history == []
    assert ckpt.available_steps(d) == [2, 4]
    assert os.path.getmtime(ckpt.checkpoint_path(d, 4)) == mtime
    with open(os.path.join(d, elastic.GEOMETRY_FILE)) as f:
        man = json.load(f)
    assert sorted(man["steps"]) == ["2", "4"] and man["num_workers"] == 2


def test_torch_resume_refuses_another_geometry_and_lost_ef_state(tmp_path):
    """Another geometry, once refused, is reshaped now (the EF residuals'
    sum kept over 2 -> 4 workers); EF residuals into a run with EF off
    are still refused."""
    t2 = _trainer(_tcfg(tmp_path, max_steps=2), compress="int8", error_feedback=True)
    t2.train()
    t4 = Trainer(_tcfg(tmp_path, resume=True), PSConfig(num_workers=4, compress="int8",
                                                        error_feedback=True),
                 dataset=make_synthetic("MNIST", train_size=64, test_size=32, seed=1),
                 device="cpu")
    assert t4.try_resume() == 2 and t4.state.step == 2
    for a, b in zip(jax.tree_util.tree_leaves(to_state_dict(t2.state.comm_state)),
                    jax.tree_util.tree_leaves(to_state_dict(t4.state.comm_state))):
        assert a.shape[0] == 2 and b.shape[0] == 4
        np.testing.assert_array_equal(b.sum(0), a.sum(0))
    os.remove(str(tmp_path / "models" / elastic.GEOMETRY_FILE))
    with pytest.raises(ValueError, match="error-feedback"):
        _trainer(_tcfg(tmp_path, resume=True), compress="int8").try_resume()
    # the guard is observability: a guard-off run drops the stored counters
    t = _trainer(_tcfg(tmp_path, resume=True), compress="int8", error_feedback=True,
                 nonfinite_guard=False)
    assert t.try_resume() == 2 and t.state.guard_state is None


def test_torch_cli_train_checkpoint_flags_and_single_machine(tmp_path):
    d = str(tmp_path / "cli")
    base = ["--device", "cpu", "--network", "LeNet", "--num-workers", "2", "--batch-size",
            "8", "--test-batch-size", "32", "--train-dir", d, "--eval-freq", "2",
            "--log-interval", "1"]
    out = cli_train.main(base + ["--max-steps", "3"])
    assert ckpt.available_steps(d) == [2, 3] and len(out["history"]) == 3
    out = cli_train.main(base + ["--max-steps", "4", "--resume"])
    assert [h["step"] for h in out["history"]] == [4] and ckpt.available_steps(d) == [2, 3, 4]
    cli_train.main(base + ["--max-steps", "5", "--resume", "--no-checkpoints"])
    assert ckpt.available_steps(d) == [2, 3, 4]
    out = single_machine.main(["--device", "cpu", "--batch-size", "8", "--max-steps", "2",
                               "--test-batch-size", "32", "--train-dir", str(tmp_path / "s")])
    assert np.isfinite(out["val"]["loss"])
    assert ckpt.available_steps(str(tmp_path / "s")) == [2]
    res = cli_evaluate.main(["--model-dir", d, "--once", "--device", "cpu",
                             "--eval-batch-size", "256"])
    assert list(res) == [4] and np.isfinite(res[4]["loss"])


def _agree(got: dict, want: dict):
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * max(abs(want["loss"]), 1.0)
    assert got["prec1"] == want["prec1"] and got["prec5"] == want["prec5"]


def test_torch_evaluator_agrees_with_jax_on_a_jax_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("PS_TPU_DATA_DIR", str(tmp_path / "nodata"))
    d = str(tmp_path / "models")
    jt = JTrainConfig(network="LeNet", dataset="MNIST", batch_size=8, max_steps=4,
                      eval_freq=2, log_interval=1, lr=0.05, momentum=0.9, train_dir=d)
    JTrainer(jt, JPSConfig(num_workers=2, compress="int8"),
             dataset=jmake_synthetic("MNIST", train_size=64, test_size=32, seed=1)).train()
    want = JEvaluator("LeNet", "MNIST", d, eval_batch_size=256).run(once=True)
    got = Evaluator("LeNet", "MNIST", d, eval_batch_size=256, device="cpu").run(once=True)
    assert list(got) == list(want) == [4]
    _agree(got[4], want[4])
    polled = Evaluator("LeNet", "MNIST", d, eval_batch_size=256,
                       device="cpu").run(poll_interval=0.01, timeout=0.0)
    assert sorted(polled) == [2, 4]
    _agree(polled[4], want[4])


def test_torch_evaluator_averages_local_bn_stats_as_jax(tmp_path, monkeypatch):
    """A ResNet (1, 1, 1, 1) checkpoint with worker-stacked BN stats (two
    workers' stats differing), evaluated by both evaluators."""
    monkeypatch.setenv("PS_TPU_DATA_DIR", str(tmp_path / "nodata"))
    jmodel = JResNet(block=JBasic, num_blocks=(1, 1, 1, 1))
    params, bstats = jinit(jmodel, jax.random.key(3), (32, 32, 3))
    rng = np.random.RandomState(4)
    stacked = jax.tree_util.tree_map(
        lambda x: np.stack([np.asarray(x) + 0.1 * rng.rand(*x.shape).astype(np.float32)
                            for _ in range(2)]), bstats)
    d = str(tmp_path / "models")
    jckpt.save_checkpoint({"step": np.asarray(1, np.int32), "params": params,
                           "batch_stats": stacked}, d, 1)
    jev = JEvaluator("ResNet18", "Cifar10", d, eval_batch_size=256)
    jev.model = jmodel  # traced at the first call: the small ResNet
    tev = Evaluator("ResNet18", "Cifar10", d, eval_batch_size=256, device="cpu")
    tev.model = ResNet(block=BasicBlock, num_blocks=(1, 1, 1, 1))
    _agree(tev.run(once=True)[1], jev.run(once=True)[1])
