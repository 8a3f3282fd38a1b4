"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's ``file`` holds its sizes; the plain reference
is the ``.py`` file beside it. The traffic mix is
``portbench/traffic/<traffic>.json`` and names its driver,
``portbench/drivers/<driver>.py``. The cell's limits are
``portbench/limits/<cell>.json``. A per-layer metric's reader is
``portbench/metrics/<metric>.py``. Nothing here knows a cell, a model or
a metric by name, so a later change adds files and entries and edits
none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import List, Optional

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    config_file: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: dict, cell_name: str) -> bool:
    """A metric is reported in a cell its ``workloads`` lists, or in every
    cell when it has no ``workloads`` key."""
    cells = metric.get("workloads")
    return cells is None or cell_name in cells


def find_cell(name: str, bench: Optional[dict] = None, root: str = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = configs[w["config"]]
    config_file = os.path.join(root, cfg["file"])
    limits_path = os.path.join(PORTBENCH, "limits", f"{name}.json")
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]),
        config=load_json(config_file), config_file=config_file,
        traffic=load_json(os.path.join(PORTBENCH, "traffic", f"{w['traffic']}.json")),
        limits=load_json(limits_path)["limits"] if os.path.exists(limits_path) else {},
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def load_module(path: str, name: str) -> ModuleType:
    """Import the file at ``path`` as module ``name`` (a metric's file name
    holds dots, so it is loaded by path, not by ``import``)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reference_module(cell: Cell) -> ModuleType:
    """The configuration's plain reference: the ``.py`` beside its file."""
    path = os.path.splitext(cell.config_file)[0] + ".py"
    return load_module(path, f"portbench_reference_{cell.config_name}")


def driver_module(kind: str) -> ModuleType:
    return load_module(os.path.join(PORTBENCH, "drivers", f"{kind}.py"),
                       f"portbench_driver_{kind}")


def metric_reader(metric: str) -> ModuleType:
    return load_module(os.path.join(PORTBENCH, "metrics", f"{metric}.py"),
                       f"portbench_metric_{metric}")

