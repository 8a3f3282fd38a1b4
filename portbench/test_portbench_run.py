"""``run.py`` without a card, and without the program: it exits non-zero
and prints no result, and never falls back to the CPU (CPU only)."""

import os
import shutil
import subprocess
import sys

from portbench.harness import spec

ARGS = ["--workload", "resnet18.ps8x1024_int8", "--seed", str(2 ** 31 + 5), "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "portbench/run.py"] + ARGS, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    proc = _run(spec.ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_with_only_the_benchmark_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout == ""
