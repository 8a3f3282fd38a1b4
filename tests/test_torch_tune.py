"""Autotune on the port (ps_pytorch_tpu_torch/tune, cli/tune.py,
tools/autotune.py), held against the JAX package's tune/ on the CPU:

- the cost formulas equal JAX's on the same accounting rows and profile;
- no hardware's figures are a default: a profile is given or measured;
- the LeNet tiny-grid search under JAX's profile values (passed
  explicitly) gives JAX's live ``run_search`` candidates in JAX's rank
  order, its pruned set (names, stage, rule ids: the two engine-refused
  points and PSC103 on ``..._qb32``) and its best candidate; the record
  is schema-valid; a probe stamps its backend;
- ``require_same_backend`` refuses mixed records;
- every candidate's flags, and the record itself, go through the port's
  ``cli.train`` parser (``--config-json``);
- ``cli.tune.main`` on LeNet with 2 workers and 4 steps scores each
  learning rate (JAX's tests/test_trainer_cli.py::test_cli_tune_main);
- ``tools.autotune`` on the CPU needs ``--profile`` and writes its record.

The JAX oracle enters jax 0.9's ``jit`` equations exactly: the numerics
analyzer's ``_EXACT_CALLS`` and the walker's ``_subjaxprs`` are patched
for each test through ``monkeypatch`` (tests/test_torch_numerics_parity.py
explains the gap); the files on disk do not change. The ResNet18 search
is in tests/test_torch_tune_resnet.py.
"""

import argparse
import json
import math
from pathlib import Path

import pytest

import ps_pytorch_tpu  # noqa: F401  (installs the jax.shard_map alias)
from ps_pytorch_tpu.check import walker as jwalker
from ps_pytorch_tpu.tune import costmodel as jcost
from ps_pytorch_tpu.tune import search as jsearch
from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, expand_config_json
from ps_pytorch_tpu_torch.obs.schema import validate_event
from ps_pytorch_tpu_torch.tune import costmodel, search
from ps_pytorch_tpu_torch.tune.costmodel import HardwareProfile
from tests.test_torch_numerics_parity import _one_thread, jax_exact_jit  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def jax_walker_exact_jit(monkeypatch):
    """JAX's walker maps a jax 0.9 ``jit`` equation 1:1 onto its body, as
    it maps ``pjit`` (a test-local patch of the reference)."""
    orig = jwalker._subjaxprs

    def subjaxprs(eqn):
        out = orig(eqn)
        if eqn.primitive.name == "jit":
            body = eqn.params.get("jaxpr")
            out = [(sub, exact or sub is body) for sub, exact in out]
        return out

    monkeypatch.setattr(jwalker, "_subjaxprs", subjaxprs)


def jax_profile(network: str) -> jcost.HardwareProfile:
    """JAX's own profile for ``network`` (its committed scaling model):
    a test input here, never a default of the port."""
    return jcost.load_hardware_profile(network, 8,
                                       path=str(REPO / "runs" / "predicted_scaling.json"))


def port_profile(jprof) -> HardwareProfile:
    return HardwareProfile(**jprof.to_json())


def search_summary(rec) -> dict:
    return {
        "ranked": [c["name"] for c in rec["candidates"]],
        "pruned": sorted((p["name"] or "", p["stage"], tuple(p["rules"]),
                          json.dumps(p["knobs"], sort_keys=True)) for p in rec["pruned"]),
        "best": rec["best"]["name"],
        "default": rec["default"]["name"],
    }


# ------------------------------------------------------------ cost model

def test_torch_cost_formulas_equal_jaxs():
    contract = json.loads((REPO / "runs" / "comm_contract.json").read_text())["configs"]
    jprof = jax_profile("ResNet18")
    prof = port_profile(jprof)
    sizes = {"workers": 8, "dcn": 2}
    for name, cfg in contract.items():
        rows = cfg["collectives"]
        assert costmodel.comm_seconds_from_rows(rows, sizes, prof) == \
            jcost.comm_seconds_from_rows(rows, sizes, jprof), name
        for frac in (0.0, 0.5, 1.25):
            assert costmodel.expected_mixed_comm_seconds(rows, sizes, prof, frac) == \
                jcost.expected_mixed_comm_seconds(rows, sizes, jprof, frac), name
    for comm, head, ops in ((5e-3, None, 100), (1e-3, 0.4, 7), (0.0, 1.0, 0)):
        assert costmodel.modeled_step_seconds(comm, head, ops, prof) == \
            jcost.modeled_step_seconds(comm, head, ops, jprof)
    for kind in ("psum", "pmax", "psum_scatter", "all_gather", "all_to_all", "ppermute"):
        for g in (1, 2, 8):
            assert costmodel._kind_factor(kind, g) == jcost._kind_factor(kind, g)
    tags, sizes_b = [0, 1, 2, 3, 2], [100, 64, 300, 17, 5]
    for hi in (127, 32767):
        assert costmodel.precision_mix_fraction(tags, sizes_b, hi) == \
            jcost.precision_mix_fraction(tags, sizes_b, hi)
    with pytest.raises(ValueError):
        costmodel.expected_mixed_comm_seconds([], sizes, prof, -1.0)


def test_torch_no_hardware_figure_is_a_default(tmp_path):
    with pytest.raises(TypeError):
        HardwareProfile()  # every link, launch and op figure must be given
    with pytest.raises(ValueError, match="explicit HardwareProfile"):
        search.run_search("lenet", grid="tiny", device="cpu")
    with pytest.raises(ValueError, match="measures a card"):
        costmodel.measure_card_profile("LeNet", device="cpu")
    prof = port_profile(jax_profile("LeNet"))
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(prof.to_json()))
    assert costmodel.load_hardware_profile(str(path)) == prof
    faster = costmodel.load_hardware_profile(str(path), ici_gbs=90.0)
    assert faster.ici_gbs == 90.0 and faster.dcn_gbs == prof.dcn_gbs
    assert "ici_gbs" in faster.source


def test_torch_require_same_backend_refuses_mixed():
    cpu = {"platform": "cpu", "device_kind": "cpu"}
    search.require_same_backend([cpu, dict(cpu)])
    with pytest.raises(SystemExit, match="across backends"):
        search.require_same_backend([cpu, {"platform": "gpu",
                                           "device_kind": "NVIDIA H100 80GB HBM3"}])
    assert search.backend_info("cpu") == {"platform": "cpu", "device_kind": "cpu"}


def test_torch_grids_and_knobs_are_jaxs():
    for model in search.MODELS:
        for grid in ("default", "smoke", "tiny"):
            mine = [k.to_json() for k in search.build_grid(model, grid)]
            theirs = [k.to_json() for k in jsearch.build_grid(model, grid)]
            assert mine == theirs, (model, grid)
    assert search.MODELS == jsearch.MODELS
    assert search.GATE_MIN_SPEEDUP == jsearch.GATE_MIN_SPEEDUP
    kn = search.Knobs(compress="int8_2round", overlap="pipelined", quant_block_size=32)
    assert kn.flags("LeNet", "MNIST") == jsearch.Knobs(
        compress="int8_2round", overlap="pipelined", quant_block_size=32).flags("LeNet", "MNIST")
    assert search.flag_line({"--a": 1, "--b": "x"}) == "--a 1 --b x"
    with pytest.raises(ValueError, match="unknown grid"):
        search.build_grid("lenet", "nope")


# ------------------------------------------------ the LeNet tiny search

@pytest.fixture(scope="module")
def tiny_search():
    return search.run_search("lenet", grid="tiny", profile=port_profile(jax_profile("LeNet")),
                             probe_top=1, probe_steps=2, device="cpu",
                             probe_names=["ps_int8_replicated_bucketed64k"])


def test_torch_tiny_search_equals_jaxs_live_search(tiny_search):
    theirs = jsearch.run_search("lenet", grid="tiny", profile=jax_profile("LeNet"))
    assert search_summary(tiny_search) == search_summary(theirs)
    stages = sorted(p["stage"] for p in tiny_search["pruned"])
    assert stages == ["config", "config", "contract"]
    (contract,) = [p for p in tiny_search["pruned"] if p["stage"] == "contract"]
    assert contract["rules"] == ["PSC103"] and contract["name"].endswith("_qb32")
    assert tiny_search["n_candidates"] == theirs["n_candidates"] == 6
    # the costs are priced from the same accounting rows
    for mine, jc in zip(tiny_search["candidates"], theirs["candidates"]):
        assert mine["cost"]["comm_s"] == pytest.approx(jc["cost"]["comm_s"], rel=1e-9)
        assert mine["cost"]["wire_bytes"] == jc["cost"]["wire_bytes"]


def test_torch_tiny_search_record_is_schema_valid_and_ranked(tiny_search):
    rec = tiny_search
    validate_event(dict(rec))
    validate_event(dict(rec["run"]))
    assert rec["run"]["component"] == "autotune"
    assert rec["backend"] == {"platform": "cpu", "device_kind": "cpu"}
    costs = [c["cost"]["modeled_step_s"] for c in rec["candidates"]]
    assert costs == sorted(costs) and all(c > 0 for c in costs)
    assert rec["hardware_profile"]["name"] == "tpu_v5e_defaults"  # the given profile, named
    prof = HardwareProfile(**rec["hardware_profile"])
    for c in rec["candidates"]:
        cost = c["cost"]
        comm = costmodel.comm_seconds_from_rows(cost["comm_rows"], {"workers": 8}, prof)
        assert comm == pytest.approx(cost["comm_s"], rel=1e-6, abs=2e-9)
        assert costmodel.modeled_step_seconds(comm, cost["overlap_headroom"],
                                              cost["update_path_ops"], prof) == \
            pytest.approx(cost["modeled_step_s"], rel=1e-6, abs=2e-9)


def test_torch_tiny_search_probe_feeds_back_into_the_formula(tiny_search):
    top = tiny_search["candidates"][0]
    probe = top["probe"]
    assert probe["platform"] == "cpu" and probe["steps"] == 2 and probe["measured_step_s"] > 0
    # the CPU runs the plain versions: no kernel launches
    assert probe["launches"] == {"K1": 0, "K2": 0, "K3": 0}
    prof = HardwareProfile(**tiny_search["hardware_profile"])
    want = costmodel.modeled_step_seconds(top["cost"]["comm_s"], probe["overlap_fraction_spans"],
                                          top["cost"]["update_path_ops"], prof)
    assert top["cost"]["modeled_step_probe_s"] == pytest.approx(want, rel=1e-6)


def test_torch_tiny_search_probes_the_named_candidates_too(tiny_search):
    probed = [c["name"] for c in tiny_search["candidates"] if "probe" in c]
    assert probed == [tiny_search["candidates"][0]["name"], "ps_int8_replicated_bucketed64k"]
    assert not tiny_search["trace_only"]
    with pytest.raises(ValueError, match="no ranked candidate"):
        search.run_search("lenet", grid="tiny", profile=port_profile(jax_profile("LeNet")),
                          device="cpu", probe_names=["ps_no_such_candidate"])


def test_torch_tiny_search_flags_round_trip_through_cli_train(tiny_search, tmp_path):
    from ps_pytorch_tpu_torch.cli.train import build_parser

    parser = argparse.ArgumentParser()
    add_train_flags(parser)
    add_ps_flags(parser)
    for c in tiny_search["candidates"]:
        argv = []
        for k, v in c["flags"].items():
            argv.extend([k, str(v)])
        assert parser.parse_args(argv).network == "LeNet"
    path = tmp_path / "tune_roundtrip.json"
    path.write_text(json.dumps(tiny_search))
    train = build_parser()
    args = train.parse_args(expand_config_json(
        train, ["--config-json", str(path), "--max-steps", "2", "--device", "cpu"]))
    assert args.max_steps == 2 and args.network == "LeNet"
    best = tiny_search["best"]["flags"]
    assert args.bucket_bytes == (None if best["--bucket-bytes"] == -1 else best["--bucket-bytes"])


# ------------------------------------------------------------- the CLIs

def test_torch_cli_tune_main(tmp_path, monkeypatch):
    monkeypatch.setenv("PS_TPU_DATA_DIR", str(tmp_path / "nodata"))
    from ps_pytorch_tpu_torch.cli.tune import main

    out = main(["--device", "cpu", "--network", "LeNet", "--num-workers", "2",
                "--batch-size", "8", "--max-steps", "4", "--lr-grid", "0.01", "0.5",
                "--score-window", "2", "--train-dir", str(tmp_path / "m")])
    assert set(out) == {0.01, 0.5}
    assert all(math.isfinite(v) for v in out.values())


def test_torch_score_lines_refuses_a_diverged_run():
    from ps_pytorch_tpu_torch.cli.tune import score_lines
    from ps_pytorch_tpu_torch.utils import format_iter_line

    lines = [format_iter_line(0, i, 0, 4, 8, loss, 0.0) for i, loss in enumerate([2.0, 1.0, 0.5])]
    assert score_lines(lines, 2) == pytest.approx(0.75)
    assert score_lines(lines + [format_iter_line(0, 3, 0, 4, 8, float("nan"), 0.0)],
                       2) == float("inf")
    assert score_lines([], 2) == float("inf")


def test_torch_autotune_tool_needs_a_profile_on_the_cpu(tmp_path, capsys):
    from ps_pytorch_tpu_torch.tools.autotune import main

    assert main(["--model", "lenet", "--trace-only", "--device", "cpu"]) == 2
    assert "--profile" in capsys.readouterr().err
    assert main(["--model", "lenet", "--trace-only", "--probe-top", "1",
                 "--device", "cpu"]) == 2
    prof = tmp_path / "p.json"
    prof.write_text(json.dumps(port_profile(jax_profile("LeNet")).to_json()))
    out = tmp_path / "rec.json"
    rc = main(["--model", "lenet", "--grid", "tiny", "--trace-only", "--device", "cpu",
               "--profile", str(prof), "--out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    validate_event(rec)
    assert rec["n_candidates"] == 6 and rec["trace_only"]
    assert "# flags: " + rec["best"]["flag_line"] in capsys.readouterr().out
