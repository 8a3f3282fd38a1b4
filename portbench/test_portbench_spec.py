"""BENCHMARK.json, and every file it names, found by name and within the
benchmark's contract (CPU only)."""

import json
import os
import re

import pytest

from portbench.harness import compare, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _one_line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert _one_line(x["why"])
    for m in BENCH["per_layer"]:
        assert _one_line(m["layer"])


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell):
    c = spec.find_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "a cell reports at least one per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    assert c.chips == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = spec.find_cell(cell)
    assert os.path.exists(os.path.splitext(c.config_file)[0] + ".py")
    assert os.path.exists(os.path.join(spec.PORTBENCH, "drivers", f"{c.driver}.py"))
    limits = spec.load_json(os.path.join(spec.PORTBENCH, "limits", f"{cell}.json"))
    assert limits["limits"] and set(limits["limits"]) <= set(compare.NUMBERS)
    assert all(0 < v < 1 for v in limits["limits"].values())
    assert limits["control"] in ("bf16", "fp8", "tf32")
    ref = spec.reference_module(c)
    assert callable(ref.leaf_specs)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric).read)


def test_configs_sit_under_paths_and_each_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and c["name"] in used
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert _one_line(c["source"])


def test_metrics_apply_only_to_named_cells():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_the_budget_of_a_full_check_fits():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
