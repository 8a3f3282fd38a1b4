"""Compressed-convergence legs on the real-digits stand-in (the port of
tools/convergence_r04.sh, convergence_r05.sh, convergence_hier_r05.sh and
plateau_r05.sh, as one table of legs; imports no JAX).

Each leg trains ResNet18 on the real-digits CIFAR-10 stand-in (``tools/
make_real_digits``, written once a leg into a temporary root) through
the product CLI, with the out-of-band polling evaluator watching its
checkpoint directory, reference-style:

    python -m ps_pytorch_tpu_torch.cli.evaluate --network ResNet18 --dataset Cifar10 \\
        --model-dir CKPT --data-root DATA --no-synthetic --poll-interval 45 --timeout 1200
    python -m ps_pytorch_tpu_torch.cli.train --network ResNet18 --dataset Cifar10 \\
        --num-workers 2 --batch-size 128 --num-aggregate 5 --log-interval 5 \\
        --eval-freq 20 --max-steps 80 --train-dir CKPT --data-root DATA --no-synthetic \\
        --metrics-file OUT/<prefix>_resnet18_<leg>_train.jsonl <the leg's wire flags>

The trainer runs as this module's ``--train-child``, which calls
``cli.train.main`` with exactly those flags and then writes the K1-K3
wrappers' launch counts of the run (``<leg>_launches.json``): the
counters live in the trainer's process. The tool waits until the
evaluator has logged ``Validation Step: <max-steps>,`` (``--wait-timeout``
fails the leg, no fixed grace), stops it, and after the suites merges the
legs with the repo's ``analysis/compression_convergence.py``, invoked as
the scripts invoke it, into ``compression_convergence.json`` (the r04, r05
and hier legs found in ``--out-dir``) and ``plateau_convergence.json``.

Suites (``--suite``): ``r04`` none / int8 / 2round_ef (per-tensor
scales, EF, nearest rounding); ``r05`` 2round_ef_blk128 (block-128
scales) and 2round_ef_blk128_sr (stochastic rounding); ``hier`` the
hierarchical wire on a 2 x 2 grid (``--num-workers 4 --dcn-hosts 2
--batch-size 64``: the same global batch); ``plateau`` none and
2round_ef_blk128 over 300 steps (``--log-interval 10 --eval-freq 50``);
``all`` every one. ``--steps``, ``--eval-freq`` and ``--log-interval``
override the suites' for short runs; ``--network`` / ``--dataset`` run
another model on its stand-in. A leg whose trainer or evaluator exits
non-zero, or whose evaluator never logs the last step, fails the tool
(exit 1); the shell scripts logged and went on. ``--out-dir`` also gets
each leg's train and evaluator logs and ``convergence_legs.json``, the
legs' summary (flags, seconds, launches, the evaluator's steps).

    python -m ps_pytorch_tpu_torch.tools.convergence --suite all \\
        --out-dir runs/real_digits_h100
    python -m ps_pytorch_tpu_torch.tools.convergence --suite r04 --legs none \\
        --network LeNet --dataset MNIST --steps 4 --eval-freq 2 --log-interval 1 \\
        --device cpu --poll-interval 0.5
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

_2ROUND_EF = ["--compress-grad", "2round", "--error-feedback"]
_BLK128 = ["--quant-block-size", "128"]

# suite -> file prefix, (leg, wire flags) in order, and its run length
SUITES = {
    "r04": {"prefix": "r04", "steps": 80, "log_interval": 5, "eval_freq": 20, "legs": (
        ("none", []),
        ("int8", ["--compress-grad", "compress"]),
        ("2round_ef", _2ROUND_EF + ["--quant-rounding", "nearest"]),
    )},
    "r05": {"prefix": "r05", "steps": 80, "log_interval": 5, "eval_freq": 20, "legs": (
        ("2round_ef_blk128", _2ROUND_EF + ["--quant-rounding", "nearest"] + _BLK128),
        ("2round_ef_blk128_sr", _2ROUND_EF + ["--quant-rounding", "stochastic"] + _BLK128),
    )},
    "hier": {"prefix": "r05", "steps": 80, "log_interval": 5, "eval_freq": 20,
             "layout": ["--num-workers", "4", "--dcn-hosts", "2", "--batch-size", "64"],
             "legs": (
                 ("hier_2round_ef_blk128",
                  _2ROUND_EF + ["--quant-rounding", "nearest"] + _BLK128),
             )},
    "plateau": {"prefix": "plateau", "steps": 300, "log_interval": 10, "eval_freq": 50,
                "legs": (
                    ("none", []),
                    ("2round_ef_blk128", _2ROUND_EF + ["--quant-rounding", "nearest"]
                     + _BLK128),
                )},
}
# the merged records: the suites each gathers, and its file
MERGES = (("compression_convergence.json", ("r04", "r05", "hier")),
          ("plateau_convergence.json", ("plateau",)))
FLAT_LAYOUT = ["--num-workers", "2", "--batch-size", "128"]
# the evaluator's --timeout (idle seconds), the scripts' (plateau_r05.sh's
# 2400 covers its slower CPU steps; a leg is stopped once its last step
# is logged)
EVAL_IDLE_S = 1200
# the K1-K3 wrappers whose launches a leg's trainer reports
COUNTED = ("quantize_tensors", "quantize_rows_scaled_many", "quantize_rows_many",
           "quantize_rows", "accumulate_rescale_int8")


def _log(msg: str) -> None:
    print(f"[convergence {time.strftime('%H:%M:%S', time.gmtime())}] {msg}",
          file=sys.stderr, flush=True)


def _stem(prefix: str, network: str, leg: str) -> str:
    return f"{prefix}_{network.lower()}_{leg}"


def train_child(out_path: str, train_argv: list) -> int:
    """One leg's trainer: ``cli.train.main(train_argv)``, then the K1-K3
    launch counts of the run written to ``out_path``."""
    from ..cli import train as cli_train
    from ..ops import quantize as q

    for name in COUNTED:
        getattr(q, name).launches = 0
    cli_train.main(train_argv)
    launches = {name: getattr(q, name).launches for name in COUNTED}
    with open(out_path, "w") as f:
        json.dump(launches, f)
    print(f"kernel launches: {json.dumps(launches)}", file=sys.stderr, flush=True)
    return 0


def _eval_steps(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [int(m.group(1)) for m in re.finditer(r"Validation Step:\s*(\d+),", f.read())]


def _train_records(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if r.get("kind", "train") == "train"]


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def run_leg(suite: str, leg: str, wire: list, args) -> dict:
    """One leg: the stand-in, the evaluator, then the trainer; the leg's
    record (``ok`` False with an ``error`` when it failed)."""
    from .make_real_digits import write_all

    spec = SUITES[suite]
    steps = args.steps or spec["steps"]
    eval_freq = args.eval_freq or spec["eval_freq"]
    log_interval = args.log_interval or spec["log_interval"]
    stem = _stem(spec["prefix"], args.network, leg)
    out = os.path.abspath(args.out_dir)
    metrics = os.path.join(out, f"{stem}_train.jsonl")
    eval_log = os.path.join(out, f"{stem}_eval.log")
    train_log = os.path.join(out, f"{stem}_train.log")
    launches_path = os.path.join(out, f"{stem}_launches.json")
    for path in (metrics, launches_path):  # fresh runs, no appends
        if os.path.exists(path):
            os.remove(path)
    train_flags = (["--network", args.network, "--dataset", args.dataset]
                   + spec.get("layout", FLAT_LAYOUT)
                   + ["--max-steps", str(steps), "--log-interval", str(log_interval),
                      "--eval-freq", str(eval_freq), "--num-aggregate", "5"]
                   + wire)
    rec = {"suite": suite, "leg": leg, "stem": stem, "steps": steps, "eval_freq": eval_freq,
           "train_flags": " ".join(train_flags), "ok": False}
    tmp = tempfile.mkdtemp(prefix=f"{stem}_")
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    procs = []
    try:
        data, ckpt = os.path.join(tmp, "data"), os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        write_all(data)
        common = ["--data-root", data, "--no-synthetic", "--device", args.device]
        _log(f"train {stem} -> {metrics}")
        with open(eval_log, "w") as ef, open(train_log, "w") as tf:
            # the evaluator first: it polls, with nothing to do until a
            # checkpoint appears
            ev = subprocess.Popen(
                [sys.executable, "-m", "ps_pytorch_tpu_torch.cli.evaluate",
                 "--network", args.network, "--dataset", args.dataset, "--model-dir", ckpt,
                 "--poll-interval", str(args.poll_interval),
                 "--timeout", str(EVAL_IDLE_S)] + common,
                cwd=REPO, env=env, stdout=ef, stderr=subprocess.STDOUT)
            procs.append(ev)
            tr = subprocess.Popen(
                [sys.executable, "-m", "ps_pytorch_tpu_torch.tools.convergence",
                 "--train-child", launches_path, "--"] + train_flags
                + ["--train-dir", ckpt, "--metrics-file", metrics] + common,
                cwd=REPO, env=env, stdout=tf, stderr=subprocess.STDOUT)
            procs.append(tr)
            try:
                rc = tr.wait(timeout=args.leg_timeout)
            except subprocess.TimeoutExpired:
                rec["error"] = f"trainer exceeded {args.leg_timeout} s"
                return rec
            rec["train_seconds"] = round(time.perf_counter() - t0, 3)
            if rc != 0:
                rec["error"] = f"trainer exited {rc} (see {train_log})"
                return rec
            # wait until the evaluator has LOGGED the last checkpoint's eval
            deadline = time.monotonic() + args.wait_timeout
            while steps not in _eval_steps(eval_log):
                if ev.poll() is not None:
                    rec["error"] = (f"evaluator exited {ev.returncode} before step {steps} "
                                    f"(see {eval_log})")
                    return rec
                if time.monotonic() > deadline:
                    rec["error"] = (f"evaluator logged no step {steps} within "
                                    f"{args.wait_timeout} s (see {eval_log})")
                    return rec
                time.sleep(min(1.0, args.poll_interval))
    finally:
        for p in procs:
            _stop(p)
        shutil.rmtree(tmp, ignore_errors=True)
        rec["seconds"] = round(time.perf_counter() - t0, 3)
    with open(launches_path) as f:
        rec["launches"] = json.load(f)
    rec["eval_steps"] = _eval_steps(eval_log)
    train = _train_records(metrics)
    losses = [r["loss"] for r in train]
    # the logged steps' time_cost after the first (cuDNN's search), unrounded
    times = sorted(r["time_cost"] for r in train[1:] if "time_cost" in r)
    rec["step_s_p50"] = times[len(times) // 2] if times else None
    rec["logged_losses"] = len(losses)
    rec["losses_finite"] = bool(losses) and all(math.isfinite(x) for x in losses)
    rec["ok"] = rec["losses_finite"]
    if not rec["ok"]:
        rec["error"] = f"train losses not all finite: {losses}"
    _log(f"{stem} done in {rec['seconds']} s; evaluator steps {rec['eval_steps']}")
    return rec


def merge(out_dir: str, network: str, name: str, suites) -> dict:
    """Merge every leg of ``suites`` found in ``out_dir`` (an earlier
    suite's too, as convergence_r05.sh re-used r04's) with
    analysis/compression_convergence.py into ``out_dir/name``."""
    runs, evals = [], []
    for suite in suites:
        spec = SUITES[suite]
        for leg, _ in spec["legs"]:
            stem = os.path.join(out_dir, _stem(spec["prefix"], network, leg))
            if os.path.exists(stem + "_train.jsonl"):
                runs += ["--run", f"{leg}={stem}_train.jsonl"]
                evals += ["--eval-log", f"{leg}={stem}_eval.log"]
    if not runs:
        return {}
    out = os.path.join(out_dir, name)
    subprocess.run([sys.executable, "-m", "analysis.compression_convergence"] + runs + evals
                   + ["--out", out], cwd=REPO, check=True, stdout=subprocess.DEVNULL)
    with open(out) as f:
        return json.load(f)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--train-child":
        return train_child(argv[1], [a for a in argv[2:] if a != "--"])
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.tools.convergence",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--suite", default="all", choices=list(SUITES) + ["all"])
    p.add_argument("--legs", nargs="+", default=None,
                   help="run only these legs of the suites")
    p.add_argument("--steps", type=int, default=None, help="every leg's --max-steps")
    p.add_argument("--eval-freq", type=int, default=None)
    p.add_argument("--log-interval", type=int, default=None)
    p.add_argument("--network", default="ResNet18")
    p.add_argument("--dataset", default="Cifar10")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the trainer's and the evaluator's (cuda raises without a card)")
    p.add_argument("--out-dir", default="output/convergence")
    p.add_argument("--poll-interval", type=float, default=45.0,
                   help="the evaluator's --poll-interval")
    p.add_argument("--leg-timeout", type=float, default=7200.0,
                   help="seconds a leg's trainer may take")
    p.add_argument("--wait-timeout", type=float, default=900.0,
                   help="seconds to wait, after the trainer, for the evaluator's last step")
    args = p.parse_args(argv)
    if args.device == "cuda":
        from .. import resolve_device

        resolve_device("cuda")  # no card: raise here, not in every leg
    os.makedirs(args.out_dir, exist_ok=True)
    suites = list(SUITES) if args.suite == "all" else [args.suite]
    legs, ok = [], True
    for suite in suites:
        for leg, wire in SUITES[suite]["legs"]:
            if args.legs and leg not in args.legs:
                continue
            legs.append(run_leg(suite, leg, wire, args))
            if not legs[-1]["ok"]:
                _log(f"leg {legs[-1]['stem']} FAILED: {legs[-1]['error']}")
                ok = False
                break
        if not ok:
            break
    merged = {}
    if ok:
        for name, group in MERGES:
            rep = merge(args.out_dir, args.network, name, group)
            if rep:
                merged[name] = rep["summary"]
    report = {"network": args.network, "dataset": args.dataset, "device": args.device,
              "ok": ok, "legs": legs, "merged": merged}
    with open(os.path.join(args.out_dir, "convergence_legs.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
