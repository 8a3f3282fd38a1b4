"""The port's DCN scaling sweep (ps_pytorch_tpu_torch.tools.dcn_scaling)
against JAX's tools/dcn_scaling.py: K in {1, 2} processes of 2 LeNet
workers each, 2 steps, over gloo on the CPU through the training CLI. The
record carries JAX's record and row keys (tools/dcn_scaling.py:95-103,
:131-145) with ``contention: true``; and the card's launcher (each process
joins a gloo group, then runs ``cli.train.main``) trains what the CLI's own
coordinator path trains: the same losses, record for record.
"""

import json
import os
import subprocess
import sys

import numpy as np

from ps_pytorch_tpu_torch.tools import dcn_scaling
from tests.test_torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORD_KEYS = {"platform", "contention", "note", "network", "mode", "per_worker_batch",
                   "rows"}
JAX_ROW_KEYS = {"hosts", "devices_per_host", "workers", "global_batch", "median_step_s",
                "images_per_sec", "steps_timed", "speedup_vs_first", "scaling_efficiency"}
SWEEP = ["--hosts", "1", "2", "--per-host-devices", "2", "--per-worker-batch", "4",
         "--steps", "2", "--device", "cpu", "--timeout", "240"]


def test_torch_dcn_sweep_has_jaxs_record(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rec = dcn_scaling.main(SWEEP + ["--json", str(tmp_path / "r.json")])
    capsys.readouterr()
    assert JAX_RECORD_KEYS <= set(rec) and rec["contention"] is True
    assert rec["platform"] == "cpu" and rec["backend"] == "gloo"
    assert [r["hosts"] for r in rec["rows"]] == [1, 2]
    assert [r["workers"] for r in rec["rows"]] == [2, 4]
    for r in rec["rows"]:
        assert JAX_ROW_KEYS <= set(r)
        assert np.isfinite(r["images_per_sec"]) and np.isfinite(r["final_loss"])
    assert rec["rows"][0]["speedup_vs_first"] == 1.0
    assert json.loads((tmp_path / "r.json").read_text()) == rec


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if r.get("kind") == "train"]


def test_torch_card_launcher_trains_what_the_cli_coordinator_trains(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    args = dcn_scaling._train_argv(0, 2, 2, str(tmp_path), type("A", (), {
        "network": "LeNet", "dataset": "MNIST", "per_worker_batch": 4, "steps": 2,
        "compress": True, "device": "cpu"})())
    runs = {}
    for mode in ("cli", "gloo_child"):
        port = dcn_scaling.free_port()
        procs = []
        for pid in range(2):
            argv = [a.replace("metrics_0", f"{mode}_{pid}") for a in args]
            if mode == "cli":
                cmd = ["-m", "ps_pytorch_tpu_torch.cli.train", *argv, "--coordinator-address",
                       f"localhost:{port}", "--num-processes", "2", "--process-id", str(pid)]
            else:
                cmd = ["-m", "ps_pytorch_tpu_torch.tools.dcn_scaling", "--gloo-child",
                       f"localhost:{port}", "2", str(pid), "--", *argv]
            procs.append(subprocess.Popen([sys.executable, *cmd], cwd=REPO, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-3000:]
        runs[mode] = [_losses(tmp_path / f"{mode}_{pid}.jsonl") for pid in range(2)]
    assert len(runs["cli"][0]) == 2
    assert runs["gloo_child"] == runs["cli"]
