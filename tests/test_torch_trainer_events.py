"""The port's training event stream against the JAX trainer's
(ps_pytorch_tpu_torch.trainer, cli.train, obs, resilience.faults).

- One 4-step LeNet run per package on 2 workers, with the metrics JSONL,
  the straggler watchdog armed (``--mode`` / ``--kill-threshold``), a
  storm threshold of 2 and a fault plan that poisons step 2 and stalls
  steps 2 and 3: the ``train`` / ``eval`` / ``grad_skip`` records carry
  the JAX trainer's keys, every record passes both packages'
  ``validate_event``, and the watchdog's records come in JAX's sequence
  (``straggler`` at 2, ``straggler_storm`` at 3, ``straggler_storm_end``
  when step 4 is fast). Both loops read a virtual clock (``VClock``, put
  in place of each module's ``time``) that only the injected 0.7 s stalls
  advance, so the watchdog's 0.6 s verdicts do not depend on this
  machine's load.
- ``tools/trace_report.py`` reads the port's ``--trace`` directory, and
  so does the port's own ``ps_pytorch_tpu_torch.tools.trace_report``.
- ``ckpt_write_failed`` and ``ckpt_quarantined`` reach the stream.
- SIGTERM: the ``sigterm`` fault stops a run at its step with a
  checkpoint written; that run goes in a subprocess with its own timeout
  (a SIGTERM reaching a pytest worker that has no handler would kill it),
  and a ``--resume`` continues the step count.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ps_pytorch_tpu.resilience.faults as jfaults_mod
import ps_pytorch_tpu.trainer as jtrainer_mod
import ps_pytorch_tpu.utils.logging as jlogging_mod
import ps_pytorch_tpu_torch.resilience.faults as faults_mod
import ps_pytorch_tpu_torch.trainer as trainer_mod
from ps_pytorch_tpu.obs.schema import validate_event as jvalidate
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.trainer import TrainConfig as JTrainConfig
from ps_pytorch_tpu.trainer import Trainer as JTrainer
from ps_pytorch_tpu_torch import checkpoint as ckpt
from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.data import make_synthetic
from ps_pytorch_tpu_torch.obs.schema import validate_event
from ps_pytorch_tpu_torch.parallel.ps import PSConfig
from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = '{"nan_grads": [2], "slow_steps": [2, 3], "slow_s": 0.7}'
WATCHDOG = ("straggler", "straggler_storm", "straggler_storm_end")


def _cfg(cls, tmp_path, tag, **kw):
    base = dict(network="LeNet", dataset="MNIST", batch_size=4, test_batch_size=16,
                max_steps=4, log_interval=2, save_checkpoints=False, seed=1,
                metrics_file=str(tmp_path / f"{tag}.jsonl"), straggler_threshold_s=0.6,
                straggler_storm_n=2, fault_plan=PLAN)
    base.update(kw)
    return cls(**base)


class VClock:
    """A stand-in for the ``time`` module: ``perf_counter`` moves only
    when ``sleep`` is called; ``time`` is the wall clock."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.now += s

    @staticmethod
    def time():
        return time.time()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("events")
    ds = make_synthetic("MNIST", train_size=64, test_size=16, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        clock = VClock()
        for mod in (jtrainer_mod, jlogging_mod, jfaults_mod, trainer_mod, faults_mod):
            mp.setattr(mod, "time", clock)
        jt = JTrainer(_cfg(JTrainConfig, tmp, "jax"),
                      JPSConfig(num_workers=2, compress="int8"), dataset=ds)
        jout = jt.train()
        jt.validate()
        tt = Trainer(_cfg(TrainConfig, tmp, "port", trace_dir=str(tmp / "trace")),
                     PSConfig(num_workers=2, compress="int8"), dataset=ds, device="cpu")
        tout = tt.train()
        tt.validate()
    return (_records(tmp / "jax.jsonl"), jout), (_records(tmp / "port.jsonl"), tout), tmp


def test_torch_events_keys_match_the_jax_trainer(streams):
    (jrecs, _), (trecs, _), _ = streams
    for kind in ("run_header", "train", "eval", "grad_skip"):
        jkeys = [set(r) for r in jrecs if r["kind"] == kind]
        tkeys = [set(r) for r in trecs if r["kind"] == kind]
        assert tkeys and tkeys == jkeys, kind
    assert trecs[0]["kind"] == "run_header"
    for r in trecs:
        validate_event(dict(r))
        jvalidate(dict(r))


def test_torch_watchdog_sequence_matches_the_jax_trainer(streams):
    (jrecs, jout), (trecs, tout), _ = streams

    def seq(recs):
        return [(r["kind"], r["step"], r.get("start_step"), r.get("consecutive"))
                for r in recs if r["kind"] in WATCHDOG]

    assert seq(trecs) == seq(jrecs) == [("straggler", 2, None, None),
                                        ("straggler_storm", 3, 2, 2),
                                        ("straggler_storm_end", 3, 2, 2)]
    for k in ("straggler_steps", "straggler_storms", "skipped_steps"):
        assert tout[k] == jout[k], k
    grad_skip = [(r["step"], r["skipped_steps"]) for r in trecs if r["kind"] == "grad_skip"]
    assert grad_skip == [(2, 1)]


def test_torch_trace_report_reads_the_port_trace(streams, capsys):
    *_, tmp = streams
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    rc = report.main([str(tmp / "trace"), "--metrics", str(tmp / "port.jsonl"),
                      "--require-phases", "fetch,dispatch,sync,guard"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["nesting_ok"]
    header = _records(tmp / "trace" / "trace_train_p0.jsonl")[0]
    assert header["run_id"] == _records(tmp / "port.jsonl")[0]["run_id"]


def test_torch_port_trace_report_reads_the_port_trace(streams, capsys):
    """The port's own tool (no JAX) gives the gate and summary JAX's gives."""
    from ps_pytorch_tpu_torch.tools import trace_report

    *_, tmp = streams
    argv = [str(tmp / "trace"), "--metrics", str(tmp / "port.jsonl"),
            "--require-phases", "fetch,dispatch,sync,guard"]
    assert trace_report.main(argv) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["nesting_ok"] and summary["n_overlay_events"] >= 1
    assert summary["streams"][0]["run_id"] == _records(tmp / "port.jsonl")[0]["run_id"]


def test_torch_checkpoint_events_reach_the_stream(tmp_path):
    ds = make_synthetic("MNIST", train_size=32, test_size=8, seed=2)
    mfile = tmp_path / "m.jsonl"

    def run(max_steps, plan, resume=False):
        t = Trainer(TrainConfig(network="LeNet", dataset="MNIST", batch_size=4,
                                max_steps=max_steps, eval_freq=2, log_interval=2,
                                train_dir=str(tmp_path / "ck"), metrics_file=str(mfile),
                                fault_plan=plan, resume=resume),
                    PSConfig(num_workers=2), dataset=ds, device="cpu")
        return t.train()

    with pytest.raises(ckpt.CheckpointWriteError):
        run(2, '{"ckpt_write_fail": [2]}')
    run(4, '{"ckpt_corrupt": [4]}')
    run(4, None, resume=True)
    recs = [r for r in _records(mfile) if r["kind"].startswith("ckpt_")]
    assert [(r["kind"], r["step"]) for r in recs] == [("ckpt_write_failed", 2),
                                                      ("ckpt_quarantined", 4)]
    assert recs[1]["path"].endswith("model_step_4.corrupt")


def test_torch_sigterm_stops_with_a_checkpoint_and_resume_continues(tmp_path):
    args = ["--device", "cpu", "--network", "LeNet", "--num-workers", "2", "--batch-size",
            "4", "--max-steps", "4", "--log-interval", "1", "--eval-freq", "0",
            "--train-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "ps_pytorch_tpu_torch.cli.train", *args,
         "--fault-plan", '{"sigterm": 2}'],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "graceful stop at step 2" in proc.stderr
    assert ckpt.available_steps(str(tmp_path / "ck")) == [2]
    out = cli_train.main(args + ["--resume"])
    assert [h["step"] for h in out["history"]] == [3, 4]
    assert ckpt.available_steps(str(tmp_path / "ck")) == [2, 4]
    assert np.isfinite(out["val"]["loss"])
