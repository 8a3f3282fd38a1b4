"""The port's serving CLI (ps_pytorch_tpu_torch.cli.serve) against the
JAX package's cli.serve, on the CPU.

A tiny LM is trained by the port's ``cli.train_lm --device cpu``
(checkpoints at steps 2 and 4). On the same ``--model-dir`` and
``--seed`` both CLIs serve it without deadlines or admission control:
their summaries have the same keys, the same ``requests_completed`` and
the same ``new_tokens`` (latencies are not compared). Then the port
alone: ``--step 2 --poll-interval`` rolls over exactly once, to 4; with
``--events``, ``--fault-plan '{"rollover_corrupt": [4]}'`` and
``--traffic-spike`` on a copy of the directory the stream validates
(against both packages' schemas), holds one ``rollover_abort`` and one
terminal record per request, and the service stays on step 2. The
geometry checks refuse as JAX's do, with the same messages.
"""

import json
import shutil

import pytest

from ps_pytorch_tpu.cli import serve as jserve
from ps_pytorch_tpu.obs.schema import validate_event as jvalidate
from ps_pytorch_tpu_torch.cli import serve as tserve
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.obs import validate_event
from tests.test_torch_one_thread import _one_thread  # noqa: F401

TRAFFIC = ["--slots", "4", "--requests", "12", "--rate", "200", "--prompt-min", "3",
           "--prompt-max", "8", "--new-min", "4", "--new-max", "10", "--seed", "3"]


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    train_lm.main(["--device", "cpu", "--vocab-size", "64", "--dim", "32", "--depth", "2",
                   "--heads", "4", "--seq-len", "48", "--batch-size", "4", "--max-steps",
                   "4", "--eval-freq", "2", "--train-dir", str(d)])
    assert sorted(p.name for p in d.iterdir()) == ["model_step_2", "model_step_4"]
    return d


def _serve(main, d, *extra, device=True):
    args = ["--model-dir", str(d), *TRAFFIC, *extra]
    return main((["--device", "cpu"] if device else []) + args)


def test_torch_cli_serve_summary_matches_jax(lm_dir, tmp_path):
    got = _serve(tserve.main, lm_dir, "--summary-file", str(tmp_path / "s.json"))
    want = _serve(jserve.main, lm_dir, device=False)
    assert sorted(got) == sorted(want)
    assert got["requests_completed"] == want["requests_completed"] == 12
    assert got["new_tokens"] == want["new_tokens"]
    assert got["weights_step"] == want["weights_step"] == 4
    assert got["rollovers"] == [] and got["requests_submitted"] == 12
    assert json.loads((tmp_path / "s.json").read_text()) == got


def test_torch_cli_serve_rolls_over_once(lm_dir, tmp_path):
    got = _serve(tserve.main, lm_dir, "--step", "2", "--poll-interval", "0.001",
                 "--int8-kv", "--num-workers", "2", "--trace", str(tmp_path / "tr"))
    assert [(r["from_step"], r["to_step"]) for r in got["rollovers"]] == [(2, 4)]
    assert got["weights_step"] == 4 and got["requests_completed"] == 12
    names = {json.loads(line).get("name")
             for line in (tmp_path / "tr" / "trace_serve_p0.jsonl").read_text().splitlines()}
    assert {"rollover_drain", "rollover_swap", "decode_dispatch", "admit_prefill"} <= names


def test_torch_cli_serve_events_under_a_corrupt_staged_step(lm_dir, tmp_path):
    d = tmp_path / "copy"
    shutil.copytree(lm_dir, d)
    ev = tmp_path / "events.jsonl"
    got = _serve(tserve.main, d, "--step", "2", "--poll-interval", "0.001", "--events",
                 str(ev), "--fault-plan", '{"rollover_corrupt": [4]}',
                 "--traffic-spike", "5,0,0.02", "--slo-budget", "0.5")
    recs = [json.loads(line) for line in ev.read_text().splitlines()]
    for r in recs:
        validate_event(dict(r))
        jvalidate(dict(r))
    assert recs[0]["kind"] == "run_header" and recs[0]["component"] == "serve"
    aborts = [r for r in recs if r["kind"] == "rollover_abort"]
    assert len(aborts) == 1 and aborts[0]["reason"] == "corrupt_staged"
    assert (aborts[0]["from_step"], aborts[0]["staged_step"]) == (2, 4)
    terminal = ("request_done", "request_shed", "deadline_expired")
    assert sorted(r["rid"] for r in recs if r["kind"] in terminal) == list(range(12))
    assert got["weights_step"] == 2 and got["rollovers"] == []
    counts = (got["requests_completed"], got["requests_shed"], got["requests_expired"])
    assert sum(counts) == got["requests_submitted"] == 12


@pytest.mark.parametrize("extra", [["--prompt-max", "8", "--max-prompt-len", "6"],
                                   ["--new-max", "60"]], ids=["prefill_width", "slot_length"])
def test_torch_cli_serve_geometry_refusals_match_jax(lm_dir, extra):
    with pytest.raises(SystemExit) as got:
        _serve(tserve.main, lm_dir, *extra)
    with pytest.raises(SystemExit) as want:
        _serve(jserve.main, lm_dir, *extra, device=False)
    assert str(got.value) == str(want.value)
