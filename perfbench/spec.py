"""Find a cell's pieces by the names in ``BENCHMARK.json``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as fin:
        return json.load(fin)


def load_json(kind: str, name: str) -> Dict:
    with open(HERE / kind / f"{name}.json") as fin:
        return json.load(fin)


def load_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    key = f"perfbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key,
                                                  HERE / kind / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def reference(self) -> ModuleType:
        return load_module("reference", self.config["name"])

    @property
    def work(self) -> ModuleType:
        return load_module("work", self.config["name"])


def _reports(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: Dict = None) -> Cell:
    """The cell `name`: its configuration, traffic and limits, and the
    metrics it reports (an end-to-end metric unless its ``workloads``
    leave the cell out; a per-layer metric where its ``workloads`` name
    the cell or, without them, where the cell reports what it moves)."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, chips=entry["chips"],
                config=load_json("configs", entry["config"]),
                traffic=load_json("traffic", entry["traffic"]),
                limits=load_json("workloads", name)["limits"],
                end_to_end=e2e, per_layer=per_layer)
