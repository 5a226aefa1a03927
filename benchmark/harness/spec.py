"""What a run reads from data: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<mix>.json``), the driver of
the mix's kind (``drivers/<kind>.py``) and its per-layer metric readers
(``metrics/<metric>.py``), each found by the name ``BENCHMARK.json`` or the
mix gives. A new cell, mix, kind of traffic or metric is new files, never an
edit of this one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
KIND = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}\Z")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r}: a name is 1 to 64 letters, digits, '_', '.' "
                         "and '-', starting with a letter, a digit or '_'")
    return name


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]] = None
    bound: Optional[float] = None
    layer: str = ""
    moves: str = ""

    def reported_in(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _metric(entry: dict) -> Metric:
    check_name(entry["name"], "metric")
    return Metric(entry["name"], entry["unit"], entry["better"], entry["source"],
                  entry.get("workloads"), entry.get("bound"), entry.get("layer", ""),
                  entry.get("moves", ""))


def load_cell(root: str, workload: str, spec: Optional[dict] = None,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``workload`` of the ``BENCHMARK.json`` under ``root`` (or of
    ``spec``), with its configuration, its traffic mix (from
    ``bench_dir/traffic``) and the metrics it reports."""
    spec = load_spec(root) if spec is None else spec
    check_name(workload, "workload")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    c = configs[check_name(w["config"], "config")]
    with open(os.path.join(root, c["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(bench_dir, "traffic", check_name(w["traffic"], "traffic") + ".json")) as fh:
        traffic = json.load(fh)
    e2e = [m for m in map(_metric, spec["end_to_end"]) if m.reported_in(workload)]
    per_layer = [m for m in map(_metric, spec["per_layer"]) if m.reported_in(workload)]
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), config, traffic, e2e,
                per_layer)


def driver(kind: str):
    """The module ``benchmark.drivers.<kind>`` that runs traffic of ``kind``."""
    if not isinstance(kind, str) or not KIND.match(kind):
        raise ValueError(f"traffic kind {kind!r}: a kind is a Python identifier of at most "
                         "64 characters")
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str) -> Callable:
    """``read(window) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", check_name(name, "metric") + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[Metric], window) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds something."""
    out = {}
    for m in metrics:
        value = metric_reader(m.name)(window)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
