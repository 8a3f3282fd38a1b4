"""The port's training entry points on the CPU: ``cli.train.main`` and
``Trainer`` (ps_pytorch_tpu_torch.cli, trainer).

They run the whole slice end to end at a small size (LeNet, synthetic
MNIST, 8 stacked workers) with ``--device cpu``; without it, on a
machine with no card, they raise. Flags the port does not run are
refused, never ignored. The card runs the full-width ResNet18 path in
chip_smoke.py.
"""

import json
import math

import numpy as np
import pytest
import torch

from ps_pytorch_tpu.utils import logging as jlog
from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.data import make_synthetic
from ps_pytorch_tpu_torch.parallel.ps import PSConfig
from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer
from tests.test_torch_one_thread import _one_thread  # noqa: F401


BASE = ["--network", "LeNet", "--num-workers", "8", "--batch-size", "16",
        "--test-batch-size", "64", "--log-interval", "1"]


def _run(*extra):
    # --no-checkpoints: the default --train-dir is output/models/ in the
    # working directory, shared by every test process
    return cli_train.main(BASE + ["--device", "cpu", "--no-checkpoints", *extra])


def test_torch_cli_train_runs_on_cpu_with_finite_losses(caplog):
    out = _run("--max-steps", "5", "--compress-grad", "compress")
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 5 and all(math.isfinite(v) for v in losses)
    assert out["train"]["skipped_steps"] == 0.0
    assert math.isfinite(out["val"]["loss"]) and 0.0 <= out["val"]["prec1"] <= 100.0


@pytest.mark.parametrize("extra", [
    ["--quant-block-size", "128", "--error-feedback"],
    ["--num-aggregate", "5", "--mask-mode", "first_k", "--state-layout", "tree"],
    ["--compress-grad", "none", "--grad-accum-steps", "2", "--bn-mode", "local"],
    ["--compress-grad", "compress", "--dynamic-loss-scale", "--weight-decay", "1e-4"],
])
def test_torch_cli_train_wire_options(extra):
    args = ["--max-steps", "3"] + extra
    if "--error-feedback" in extra:
        args += ["--compress-grad", "compress", "--num-aggregate", "5"]
    out = _run(*args)
    assert all(math.isfinite(h["loss"]) for h in out["history"])


def test_torch_cli_train_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(BASE + ["--max-steps", "1"])


def test_torch_cli_train_nan_fault_plan_skips_one_step():
    out = _run("--max-steps", "3", "--compress-grad", "compress",
               "--fault-plan", '{"nan_grads": [2]}')
    assert out["train"]["skipped_steps"] == 1.0
    assert math.isfinite(out["history"][-1]["loss"])


@pytest.mark.parametrize("extra", [
    ["--compress-grad", "compress", "--quant-rounding", "stochastic", "--error-feedback"],
    ["--compress-grad", "2round", "--quant-rounding", "stochastic", "--quant-block-size", "128"],
    ["--compress-grad", "compress", "--bucket-bytes", "65536", "--precision-adapt",
     "--wire-budget-bytes", "200000", "--adapt-window", "1"],
    ["--compress-grad", "2round", "--wire-domain", "homomorphic", "--bucket-bytes", "0",
     "--num-aggregate-min", "2", "--num-aggregate-max", "4", "--mode", "straggler",
     "--kill-threshold", "60", "--adapt-window", "1"],
    ["--data-root", "/nonexistent"],
    ["--compress-grad", "compress", "--bucket-bytes", "65536", "--overlap", "on",
     "--error-feedback"],
    ["--overlap", "on", "--opt-placement", "sharded", "--compress-grad", "compress"],
    ["--compress-grad", "2round", "--dcn-hosts", "2", "--wire-domain", "homomorphic"],
    ["--dcn-hosts", "2"],
    ["--compress-checkpoints"],
    # the serve-side fault keys parse and the trainer ignores them, as JAX's
    ["--fault-plan", '{"slow_decode": [1], "slow_decode_s": 0.01}'],
    ["--fault-plan", '{"rollover_corrupt": [1]}'],
    ["--fault-plan", '{"spike": [5, 0, 1]}'],
], ids=["stochastic_ef", "stochastic_2round", "precision", "adaptive_count", "data_root",
        "overlap", "overlap_zero1", "dcn_hosts_homomorphic", "dcn_hosts",
        "compress_checkpoints", "slow_decode", "rollover_corrupt", "spike"])
def test_torch_cli_train_runs_what_it_refused(extra, tmp_path):
    """Refused before their port; JAX runs each of them (4 workers of 4
    images, 2 steps)."""
    args = ["--max-steps", "2", "--num-workers", "4", "--batch-size", "4",
            "--test-batch-size", "256", *extra]
    if "--compress-checkpoints" in extra:
        d = tmp_path / "models"
        out = cli_train.main(BASE + ["--device", "cpu", "--train-dir", str(d), *args])
        assert (d / "model_step_2").read_bytes()[:4] == b"PSCK"
    else:
        out = _run(*args)
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    assert out["train"]["skipped_steps"] == 0.0
    if "--precision-adapt" in extra:
        # a budget under the floor: every bucket at 4 bits, half of
        # LeNet's 431080 int8 bytes, adopted after two agreeing windows
        # (steps 1 and 2)
        assert out["train"]["precision_adaptations"] == 1.0
        assert out["train"]["effective_wire_bytes"] == 215540.0
    if "--num-aggregate-min" in extra:
        assert out["train"]["agg_count"] == 4.0 and out["train"]["mask_adaptations"] == 0.0


@pytest.mark.parametrize("extra,err", [
    (["--compress-grad", "compress", "--wire-domain", "homomorphic", "--quant-rounding",
      "stochastic"], "nearest"),
    (["--compress-grad", "compress", "--precision-adapt"], "bucketed"),
    (["--compress-grad", "compress", "--bucket-bytes", "0", "--precision-adapt",
      "--quant-rounding", "stochastic"], "nearest"),
    (["--num-aggregate-min", "2"], "BOTH"),
    (["--num-aggregate-min", "2", "--num-aggregate-max", "4"], "watchdog"),
    (["--no-synthetic", "--data-root", "/nonexistent"], "no MNIST data"),
])
def test_torch_cli_train_refuses_what_jax_refuses(extra, err):
    with pytest.raises((ValueError, FileNotFoundError), match=err):
        _run("--max-steps", "1", *extra)


def _small_run(tmp_path, network="LeNet", tcfg=None, pcfg=None):
    """Trainer on 2 workers x 2 images of a tiny synthetic split (the
    CLI's own split would make VGG's validation pass a CPU-minute)."""
    name = "MNIST" if network == "LeNet" else "Cifar10"
    d = make_synthetic(name, train_size=8, test_size=4, seed=3)
    t = Trainer(TrainConfig(network=network, dataset=name, batch_size=2, max_steps=2,
                            log_interval=1, test_batch_size=4, save_checkpoints=False,
                            **(tcfg or {})),
                PSConfig(num_workers=2, compress="int8", **(pcfg or {})), dataset=d,
                device="cpu")
    out = t.train()
    return t, out, t.validate()


# each once refused (the port's parent raised NotImplementedError for it)
@pytest.mark.parametrize("case", [
    dict(network="VGG11", pcfg=dict(opt_placement="sharded", bn_mode="synced")),
    dict(tcfg=dict(metrics_file="m.jsonl")),
    dict(network="VGG16"),
    dict(tcfg=dict(dtype="bfloat16")),
    dict(tcfg=dict(trace_dir="t")),
    dict(tcfg=dict(fault_plan='{"slow_steps": [2], "slow_s": 0.01}',
                   straggler_threshold_s=0.0)),
], ids=["synced", "metrics_file", "vgg16", "bf16", "trace", "slow_steps"])
def test_torch_trainer_runs_what_it_refused(tmp_path, case):
    tcfg = dict(case.get("tcfg", {}))
    for k in ("metrics_file", "trace_dir"):
        if k in tcfg:
            tcfg[k] = str(tmp_path / tcfg[k])
    t, out, val = _small_run(tmp_path, case.get("network", "LeNet"), tcfg, case.get("pcfg"))
    assert all(math.isfinite(h["loss"]) for h in t.history) and len(t.history) == 2
    assert out["skipped_steps"] == 0.0 and math.isfinite(val["loss"])
    if "metrics_file" in tcfg:
        kinds = [json.loads(x)["kind"] for x in open(tcfg["metrics_file"])]
        assert kinds == ["run_header", "train", "train", "eval"]
    if "trace_dir" in tcfg:
        names = {json.loads(x).get("name") for x in open(tmp_path / "t" / "trace_train_p0.jsonl")}
        assert {"fetch", "dispatch", "sync", "guard"} <= names
    if "fault_plan" in tcfg:
        # threshold 0: every step but the exempt first is a straggler
        assert out["straggler_steps"] == 1.0


def test_torch_trainer_log_lines_parse_with_the_reference_parser(caplog):
    lines = []
    import logging

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    from ps_pytorch_tpu_torch.trainer import logger

    h = Grab()
    logger.addHandler(h)
    try:
        d = make_synthetic("MNIST", train_size=256, test_size=32)
        t = Trainer(TrainConfig(network="LeNet", dataset="MNIST", batch_size=8,
                                max_steps=4, log_interval=2, test_batch_size=32,
                                save_checkpoints=False),
                    PSConfig(num_workers=4, compress="int8"), dataset=d, device="cpu")
        t.train()
        val = t.validate()
    finally:
        logger.removeHandler(h)
    parsed = [jlog.parse_iter_line(x) for x in lines]
    steps = [p["step"] for p in parsed if p]
    assert steps == [1.0, 2.0, 4.0]
    assert any(x.startswith("Validation Step: 4") for x in lines)
    assert np.isfinite(val["loss"])
