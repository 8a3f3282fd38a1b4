"""The port's trace front end and analysis scripts run where JAX cannot
be imported (as on the card's machine): each runs in a subprocess in
which importing ``jax``, ``jaxlib``, ``flax``, ``optax``, ``msgpack``,
``sklearn`` or the package ``ps_pytorch_tpu`` raises, while
``ps_pytorch_tpu_torch`` still imports. There, ``cli.train --device cpu --trace --profile-dir``
writes both traces, ``trace_report`` merges the span stream and passes
``--require-phases``, ``overlap_report trace`` reads the CPU profile and
exits 1 naming the missing device events (never a zero fraction), its
``tape`` mode reports the recorded step, ``speedup`` reads the run's log
and ``scaling_bench --device cpu`` times two points; ``longcontext_check``,
``predicted_scaling`` (with ``--t1``) and ``make_real_digits`` (which reads
the package's copy of the digits, not scikit-learn) run too.
"""

import json
import os
import subprocess
import sys

from ps_pytorch_tpu_torch.utils import format_iter_line
from tests.test_torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# an import hook that refuses the JAX stack, scikit-learn and the JAX
# package (not the port, whose name only starts like it)
HOOK = r"""
import importlib.abc, runpy, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "msgpack", "ps_pytorch_tpu"}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is not importable here")
        return None
sys.meta_path.insert(0, Refuse())
# scikit-learn absent as on the card's machine: an import fails and
# importlib.util.find_spec (which torch._dynamo probes it with) finds none
sys.modules["sklearn"] = None
"""
# ... then the named module runs as __main__
BLOCKED_RUN = HOOK + r"""
mod, sys.argv = sys.argv[1], sys.argv[1:]
runpy.run_module(mod, run_name="__main__", alter_sys=True)
"""
PROBE = HOOK + r"""
for name in ("jax", "ps_pytorch_tpu", "sklearn"):
    try:
        __import__(name)
    except ImportError as e:
        print("refused", e)
import ps_pytorch_tpu_torch.obs
print("port ok")
"""


def _run(module, *args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", BLOCKED_RUN, module, *args], cwd=REPO, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                       timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def test_torch_the_import_block_refuses_jax_and_keeps_the_port():
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE, text=True, timeout=120)
    assert p.stdout.count("refused") == 3 and "port ok" in p.stdout, p.stderr
    rc, out, _ = _run("ps_pytorch_tpu_torch.tools.trace_report", "--help")
    assert rc == 0 and "require-phases" in out


def test_torch_tools_run_without_jax(tmp_path):
    run = tmp_path / "run"
    rc, out, err = _run("ps_pytorch_tpu_torch.cli.train", "--device", "cpu", "--network",
                        "LeNet", "--num-workers", "2", "--batch-size", "4", "--max-steps", "4",
                        "--log-interval", "1", "--eval-freq", "0", "--no-checkpoints",
                        "--trace", str(run / "trace"), "--profile-dir", str(run / "prof"),
                        "--profile-start", "2", "--profile-steps", "2")
    assert rc == 0, err[-3000:]
    log = tmp_path / "train.log"
    log.write_text(err)

    rc, out, err = _run("ps_pytorch_tpu_torch.tools.trace_report", str(run / "trace"),
                        "--require-phases", "fetch,dispatch", "--out", str(tmp_path / "m.json"))
    assert rc == 0, err[-3000:]
    assert json.loads(out)["nesting_ok"] and (tmp_path / "m.json").exists()

    # a CPU profile holds no device event: an error, never a zero fraction
    rc, out, err = _run("ps_pytorch_tpu_torch.tools.overlap_report", "trace", "--profile-dir",
                        str(run / "prof"))
    assert rc == 1 and "no device events" in err
    rep = json.loads(out)
    assert rep["trace_file"].endswith(".pt.trace.json") and "overlap_fraction" not in rep

    rc, out, err = _run("ps_pytorch_tpu_torch.tools.overlap_report", "tape", "--network",
                        "LeNet", "--dataset", "MNIST", "--batch", "8", "--compress", "int8",
                        "--bucket-bytes", "65536", "--overlap", "on")
    assert rc == 0, err[-3000:]
    assert json.loads(out)["overlap_fraction"] > 0

    # the run's own four iteration lines and one more step
    with open(log, "a") as f:
        f.write(format_iter_line(0, 5, 1, 8, 16, 1.0, 0.5) + "\n")
    rc, out, err = _run("ps_pytorch_tpu_torch.analysis.speedup", str(log), "--json")
    assert rc == 0, err[-3000:]
    (row,) = json.loads(out)
    assert row["steps"] == 5 and row["speedup"] == 1.0

    rc, out, err = _run("ps_pytorch_tpu_torch.analysis.scaling_bench", "--device", "cpu",
                        "--network", "LeNet", "--batch-size", "4", "--workers", "1", "2",
                        "--steps", "1")
    assert rc == 0, err[-3000:]
    rec = json.loads(out.splitlines()[-1])
    assert rec["platform"] == "cpu" and len(rec["rows"]) == 2


def test_torch_the_last_repo_tools_run_without_jax(tmp_path):
    rc, out, err = _run("ps_pytorch_tpu_torch.tools.longcontext_check", "--seq", "128",
                        "--devices", "4", "--device", "cpu")
    assert rc == 0, err[-3000:]
    assert json.loads(out)["all_pass"]

    rc, out, err = _run("ps_pytorch_tpu_torch.tools.predicted_scaling", "--device", "cpu",
                        "--network", "LeNet", "--workers", "8", "--modes", "none",
                        "hier_2round", "--t1", "0.01", "--ici-gbs", "450", "--dcn-gbs", "50",
                        "--out", str(tmp_path / "ps.json"))
    assert rc == 0, err[-3000:]
    rep = json.loads((tmp_path / "ps.json").read_text())
    assert rep["contract_check"]["ok"] and len(rep["rows"]) == 2

    rc, out, err = _run("ps_pytorch_tpu_torch.tools.make_real_digits", "--root",
                        str(tmp_path / "data"))
    assert rc == 0, err[-3000:]
    assert out.startswith("train=1438 test=359")
    assert (tmp_path / "data" / "real_digits_svhn" / "test_32x32.mat").exists()
