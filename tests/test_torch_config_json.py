"""Port parity: ``--config-json`` (ps_pytorch_tpu_torch.cli._flags
``expand_config_json`` and its wiring in cli/train.py) against the JAX
package's cli/_flags.py.

For each argv / file case the port's expansion returns the argv JAX's
returns, or raises ``SystemExit`` with JAX's message, each over its own
CLI's parser (the port's adds only ``--device``). Then one ``cli.train
--device cpu`` LeNet run from a two-flag file, whose values must reach
``TrainConfig`` and ``PSConfig``.
"""

import argparse
import json
import os

import pytest

from ps_pytorch_tpu.cli import _flags as jflags
from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.cli._flags import expand_config_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUTOTUNE = os.path.join(REPO, "runs", "autotune_resnet18.json")


def _jax_parser() -> argparse.ArgumentParser:
    """The parser JAX's cli/train.py:41-49 builds."""
    p = argparse.ArgumentParser("ps_pytorch_tpu.cli.train")
    jflags.add_train_flags(p)
    jflags.add_ps_flags(p)
    p.add_argument("--config-json", metavar="FILE")
    return p


def _outcome(expand, parser, argv):
    try:
        return "argv", expand(parser, list(argv))
    except SystemExit as e:
        return "exit", str(e)


TWO_ROUND = {"--compress-grad": "2round", "--error-feedback": True, "--bucket-bytes": 0,
             "--no-nonfinite-guard": False}

# (file contents or None for no file, argv with FILE for the file's path)
CASES = {
    "autotune_record": (None, ["--num-workers", "8", "--config-json", AUTOTUNE]),
    "bare_dict": (TWO_ROUND, ["--max-steps", "3", "--config-json", "FILE", "--lr", "0.05"]),
    "flags_entry": ({"rank": 0, "flags": TWO_ROUND}, ["--config-json", "FILE"]),
    "unknown_key": ({"--compress-grad": "2round", "--no-such-flag": 1},
                    ["--config-json", "FILE"]),
    "explicit_conflict": (TWO_ROUND, ["--config-json", "FILE", "--compress-grad", "compress"]),
    "abbreviated_conflict": (TWO_ROUND, ["--compress-g", "compress", "--config-json", "FILE"]),
    "abbreviated_conflict_eq": (TWO_ROUND, ["--compress-g=compress", "--config-json", "FILE"]),
    "equals_form": (TWO_ROUND, ["--config-json=FILE", "--num-workers", "4"]),
    "missing_file_argument": (None, ["--num-workers", "4", "--config-json"]),
    "no_such_file": (None, ["--config-json", "/nonexistent/run.json"]),
    "not_an_object": ([1, 2], ["--config-json", "FILE"]),
    "autotune_without_best": ({"kind": "autotune", "best": None}, ["--config-json", "FILE"]),
    "flag_takes_no_value": ({"--error-feedback": "yes"}, ["--config-json", "FILE"]),
    "no_config_json": (None, ["--num-workers", "4", "--lr", "0.1"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_expand_config_json_matches_jax(tmp_path, case):
    data, argv = CASES[case]
    path = str(tmp_path / "run.json")
    if data is not None:
        with open(path, "w") as f:
            json.dump(data, f)
    argv = [a.replace("FILE", path) for a in argv]
    want = _outcome(jflags.expand_config_json, _jax_parser(), argv)
    got = _outcome(expand_config_json, cli_train.build_parser(), argv)
    assert got == want
    if case in ("unknown_key", "explicit_conflict", "abbreviated_conflict",
                "missing_file_argument", "no_such_file"):
        assert got[0] == "exit"
    if case == "autotune_record":
        # the committed record's best candidate: the homomorphic two-round
        # wire in one fused bucket (K3's path)
        flags = got[1]
        assert flags[flags.index("--compress-grad") + 1] == "2round"
        assert flags[flags.index("--wire-domain") + 1] == "homomorphic"
        assert flags[-2:] == ["--num-workers", "8"]


def test_torch_cli_train_config_json_reaches_the_configs(tmp_path):
    """A two-flag file on a LeNet run: the values reach TrainConfig and
    PSConfig through the parser's own types."""
    path = tmp_path / "run.json"
    path.write_text(json.dumps({"--compress-grad": "2round", "--lr": 0.05}))
    out = cli_train.main(["--device", "cpu", "--network", "LeNet", "--num-workers", "2",
                          "--batch-size", "8", "--test-batch-size", "64", "--max-steps",
                          "2", "--log-interval", "1", "--no-checkpoints", "--config-json",
                          str(path)])
    t = out["trainer"]
    assert t.tcfg.lr == 0.05 and t.pcfg.compress == "int8_2round"
    assert t.tcfg.network == "LeNet" and t.pcfg.num_workers == 2
    assert len(out["history"]) == 2
    with pytest.raises(SystemExit, match="passed explicitly"):
        cli_train.main(["--device", "cpu", "--config-json", str(path), "--lr", "0.1"])
