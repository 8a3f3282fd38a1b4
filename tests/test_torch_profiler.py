"""Port parity: the profiler window (ps_pytorch_tpu_torch.obs.profiler
``ProfileWindow`` on ``torch.profiler``) and its wiring in the trainer
and ``cli.train_lm``, against the JAX package's obs/profiler.py.

- the window's bounds and its validation are JAX's: ``num_steps < 1``
  raises only with a ``profile_dir``;
- a capture writes a Chrome trace under ``profile_dir`` that holds the
  tracer's span names (``record_function`` scopes), and ``close()``
  inside the window writes it;
- the trainer's auto start is its first step + 1, ``--profile-start`` /
  ``--profile-steps`` set the window, a window that misses the run logs
  it and writes nothing; a trace write that fails at the loop's end
  still leaves the run's last checkpoint on disk;
- ``cli.train_lm`` captures from step 3, and logs when max-steps < 3.
"""

import contextlib
import glob
import json
import logging
import time

import pytest
import torch

from ps_pytorch_tpu.obs.profiler import ProfileWindow as JWindow
from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.obs import ProfileWindow, Tracer
from tests.test_torch_one_thread import _one_thread  # noqa: F401


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _traces(d):
    return sorted(glob.glob(str(d / "*.pt.trace.json")))


@contextlib.contextmanager
def _log_lines():
    """The package logger's messages (it does not propagate to pytest's
    caplog)."""
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger, h = logging.getLogger("ps_pytorch_tpu_torch"), Grab()
    logger.addHandler(h)
    try:
        yield lines
    finally:
        logger.removeHandler(h)


@pytest.mark.parametrize("profile_dir,start,n", [
    (None, 1, 0), (None, 4, -3), ("d", 2, 10), ("d", 7, 1), ("d", 3, 0), ("d", 3, -1),
])
def test_torch_profile_window_bounds_and_validation_match_jax(tmp_path, profile_dir,
                                                               start, n):
    d = None if profile_dir is None else str(tmp_path / profile_dir)
    try:
        w = JWindow(d, start, n)
        want = (w.start, w.stop, w.active)
    except ValueError as e:
        want = str(e)
    try:
        w = ProfileWindow(d, start, n)
        got = (w.start, w.stop, w.active)
    except ValueError as e:
        got = str(e)
    assert got == want
    assert isinstance(got, str) == (profile_dir is not None and n < 1)


def test_torch_profile_window_writes_the_tracer_spans(tmp_path):
    """Steps 2-3 of 5 captured: the trace holds the spans opened in them,
    not those of steps 1 and 4-5; before_step outside the window (and
    with no directory) does nothing."""
    tr = Tracer("train", annotate=True)
    w = ProfileWindow(str(tmp_path), 2, 2, device="cpu")
    ProfileWindow(None, 1, 5).before_step(1)
    x = torch.ones(8)
    for step in range(1, 6):
        w.before_step(step)
        with tr.span(f"phase_{step}", step=step):
            x = x * 2.0
    assert not w.active and w.trace_path == _traces(tmp_path)[0]
    names = {e.get("name") for e in _events(w.trace_path)}
    assert {"phase_2", "phase_3"} <= names
    assert not {"phase_1", "phase_4", "phase_5"} & names
    assert w.host_s > 0
    w.close()  # idempotent after the window
    assert len(_traces(tmp_path)) == 1


def test_torch_profile_window_close_inside_the_window_writes_it(tmp_path):
    w = ProfileWindow(str(tmp_path / "p"), 1, 10)
    w.before_step(1)
    with torch.profiler.record_function("inside"):
        torch.ones(4).sum()
    assert w.active and not _traces(tmp_path / "p")
    w.close()
    w.close()
    assert not w.active
    (path,) = _traces(tmp_path / "p")
    assert "inside" in {e.get("name") for e in _events(path)}


LENET = ["--device", "cpu", "--network", "LeNet", "--num-workers", "2", "--batch-size",
         "8", "--test-batch-size", "64", "--log-interval", "1", "--no-checkpoints"]


def test_torch_cli_train_profile_dir_captures_the_loop(tmp_path):
    """The auto start (first step + 1) with --trace: the trace holds the
    loop's spans; the run's losses are the unprofiled run's."""
    prof = tmp_path / "prof"
    out = cli_train.main(LENET + ["--max-steps", "4", "--profile-dir", str(prof),
                                  "--profile-steps", "2", "--trace", str(tmp_path / "t")])
    w = out["trainer"].profile_window
    assert (w.start, w.stop) == (2, 4) and not w.active
    (path,) = _traces(prof)
    names = {e.get("name") for e in _events(path)}
    assert {"fetch", "dispatch", "h2d"} <= names
    plain = cli_train.main(LENET + ["--max-steps", "4"])
    assert [h["loss"] for h in out["history"]] == [h["loss"] for h in plain["history"]]


def test_torch_cli_train_profile_window_open_at_the_end_is_written(tmp_path):
    """--profile-start 3 --profile-steps 10 on a 4-step run: the loop's
    finally closes the capture."""
    out = cli_train.main(LENET + ["--max-steps", "4", "--profile-dir", str(tmp_path),
                                  "--profile-start", "3"])
    assert (out["trainer"].profile_window.start, out["trainer"].profile_window.stop) == (3, 13)
    assert len(_traces(tmp_path)) == 1


def test_torch_cli_train_profile_window_missing_the_run_logs_it(tmp_path):
    with _log_lines() as lines:
        cli_train.main(LENET + ["--max-steps", "2", "--profile-dir", str(tmp_path),
                                "--profile-start", "5"])
    assert any("[5, 15) misses this run's steps [1, 2]" in x for x in lines)
    assert not _traces(tmp_path)
    with pytest.raises(ValueError, match=">= 1 step"):
        cli_train.main(LENET + ["--max-steps", "1", "--profile-dir", str(tmp_path),
                                "--profile-steps", "0"])
    # without a directory a zero window is no error (nothing is profiled)
    cli_train.main(LENET + ["--max-steps", "1", "--profile-steps", "0"])


def test_torch_cli_train_failed_trace_write_still_waits_for_the_checkpoint(tmp_path,
                                                                          monkeypatch):
    """The window is open when the run ends and its trace write raises: the
    last checkpoint, submitted just before (its write slowed here), is on
    disk when the error reaches the caller."""
    from ps_pytorch_tpu_torch import checkpoint as ckpt

    write = ckpt.AsyncCheckpointer._write_logged

    def slow_write(self, *args):
        time.sleep(0.5)
        return write(self, *args)

    def refuse(self, path):
        raise OSError("trace write refused")

    monkeypatch.setattr(ckpt.AsyncCheckpointer, "_write_logged", slow_write)
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", refuse)
    cdir = str(tmp_path / "ckpt")
    flags = [f for f in LENET if f != "--no-checkpoints"]
    with pytest.raises(OSError, match="trace write refused"):
        cli_train.main(flags + ["--max-steps", "3", "--train-dir", cdir, "--eval-freq", "100",
                                "--profile-dir", str(tmp_path / "p"), "--profile-start", "2"])
    assert ckpt.available_steps(cdir) == [3]


LM = ["--device", "cpu", "--vocab-size", "48", "--dim", "32", "--depth", "2", "--heads",
      "2", "--seq-len", "32", "--batch-size", "4", "--log-interval", "1"]


def test_torch_cli_train_lm_profile_dir_captures_from_step_3(tmp_path):
    out = train_lm.main(LM + ["--max-steps", "5", "--parallelism", "tp", "--num-shards", "2",
                              "--profile-dir", str(tmp_path / "p")])
    w = out["profile"]
    assert (w.start, w.stop) == (3, 6) and not w.active
    assert len(_traces(tmp_path / "p")) == 1
    with _log_lines() as lines:
        train_lm.main(LM + ["--max-steps", "2", "--profile-dir", str(tmp_path / "q")])
    assert any("max-steps < 3" in x for x in lines)
    assert not _traces(tmp_path / "q")
