"""ps_pytorch_tpu_torch.tools.convergence: the port of the JAX repo's four
convergence scripts (tools/convergence_r04.sh, convergence_r05.sh,
convergence_hier_r05.sh, plateau_r05.sh) as one table of legs.

One LeNet / MNIST leg runs through the tool on the CPU (4 steps,
``--eval-freq 2``): the polling evaluator logs steps 2 and 4, and the
merged ``compression_convergence.json`` (the repo's
analysis/compression_convergence.py) holds the leg's summary. A leg whose
trainer fails makes the tool exit 1. The table's wire flags, steps and
intervals are the scripts'.
"""

import json
import os
import re

import pytest

from ps_pytorch_tpu_torch.tools import convergence as cv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = ["--network", "LeNet", "--dataset", "MNIST", "--steps", "4", "--eval-freq", "2",
         "--log-interval", "1", "--device", "cpu", "--poll-interval", "0.5",
         "--wait-timeout", "120"]


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_torch_a_leg_trains_and_the_evaluator_follows(tmp_path):
    out = tmp_path / "out"
    assert cv.main(["--suite", "r04", "--legs", "int8", "--out-dir", str(out)] + SHORT) == 0
    with open(out / "convergence_legs.json") as f:
        rep = json.load(f)
    (leg,) = rep["legs"]
    assert rep["ok"] and leg["ok"] and leg["losses_finite"] and leg["logged_losses"] == 4
    assert leg["eval_steps"] == [2, 4] and "--compress-grad compress" in leg["train_flags"]
    # the CPU runs the kernels' plain versions: no launch
    assert set(leg["launches"].values()) == {0}
    with open(out / "compression_convergence.json") as f:
        merged = json.load(f)
    summ = merged["summary"]["int8"]
    assert summ["steps"] == 4 and summ["oob_eval"]["steps"] == [2, 4]
    assert [r["step"] for r in merged["per_step"]] == [1, 2, 3, 4]
    for suffix in ("_train.jsonl", "_eval.log", "_train.log", "_launches.json"):
        assert (out / f"r04_lenet_int8{suffix}").exists()


def test_torch_a_failed_trainer_fails_the_tool(tmp_path, monkeypatch):
    suites = dict(cv.SUITES)
    suites["r04"] = dict(suites["r04"], legs=(("broken", ["--compress-grad", "nonsense"]),
                                             ("none", [])))
    monkeypatch.setattr(cv, "SUITES", suites)
    out = tmp_path / "out"
    assert cv.main(["--suite", "r04", "--out-dir", str(out)] + SHORT) == 1
    with open(out / "convergence_legs.json") as f:
        rep = json.load(f)
    # the first leg failed, the tool stopped there and merged nothing
    assert not rep["ok"] and [leg["leg"] for leg in rep["legs"]] == ["broken"]
    assert rep["legs"][0]["error"].startswith("trainer exited 2")
    assert rep["merged"] == {} and not (out / "compression_convergence.json").exists()


def _script_runs(name):
    """(label, flags) of each ``run_one`` call of a JAX convergence
    script, the defaults of its variables substituted."""
    with open(os.path.join(REPO, "tools", name)) as f:
        text = f.read().replace("\\\n", " ").replace('"$ROUNDING"', "nearest")
    return [(line.split()[1], line.split()[2:]) for line in text.splitlines()
            if line.startswith("run_one ")]


def _script_train_flags(name, *keys):
    with open(os.path.join(REPO, "tools", name)) as f:
        text = f.read().replace("\\\n", " ")
    return [re.search(rf"{k} (\d+)(?=\s)", text).group(1) for k in keys]


@pytest.mark.parametrize("suite, script", [("r04", "convergence_r04.sh"),
                                           ("r05", "convergence_r05.sh"),
                                           ("plateau", "plateau_r05.sh")])
def test_torch_the_legs_are_the_scripts(suite, script):
    spec = cv.SUITES[suite]
    assert [(leg, list(wire)) for leg, wire in spec["legs"]] == _script_runs(script)
    with open(os.path.join(REPO, "tools", script)) as f:
        steps = re.search(r"STEPS=\$\{STEPS:-(\d+)\}", f.read()).group(1)
    assert [str(spec["steps"]), str(spec["log_interval"]), str(spec["eval_freq"])] == [
        steps] + _script_train_flags(script, "--log-interval", "--eval-freq")
    assert _script_train_flags(script, "--num-workers", "--batch-size", "--num-aggregate") == [
        "2", "128", "5"]
    assert cv.FLAT_LAYOUT == ["--num-workers", "2", "--batch-size", "128"]


def test_torch_the_hier_leg_is_the_script():
    ((leg, wire),) = cv.SUITES["hier"]["legs"]
    with open(os.path.join(REPO, "tools", "convergence_hier_r05.sh")) as f:
        text = " ".join(f.read().replace("\\\n", " ").split())
    assert f"mode={leg}" in text and " ".join(wire) in text
    layout = " ".join(cv.SUITES["hier"]["layout"])
    assert layout == "--num-workers 4 --dcn-hosts 2 --batch-size 64" and layout in text
    assert cv.SUITES["hier"]["prefix"] == "r05"
