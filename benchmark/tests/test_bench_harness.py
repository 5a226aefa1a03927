"""The harness is driven by data: every cell, configuration, traffic mix,
driver of a mix's kind and per-layer metric of BENCHMARK.json loads by
name; names outside the
contract's characters are refused; a run's last line holds exactly the keys
the driver reads; without a card a run exits non-zero and prints nothing."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import compare, spec
from conftest import ROOT

SPEC = spec.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_from_data(name):
    cell = spec.load_cell(ROOT, name)
    driver = spec.driver(cell.traffic["kind"])
    assert driver.WORK in ("train", "serve")
    for entry in ("setup", "window", "end_to_end", "release", "check"):
        assert callable(getattr(driver, entry))
    assert cell.config["channels"] == 64
    assert any(m.name == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(compare.load_limits(name))


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(spec.metric_reader(name))


def test_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    end = {m["name"] for m in SPEC["end_to_end"]}
    assert end == {"train_mpbs", "train_mpbs.bf16", "serve_rps", "setup_s"}
    for m in SPEC["per_layer"]:
        assert m["moves"] in end and set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:
            moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("bad", ["", "a b", "a/b", ".x", "a,b", "é", "x" * 65])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad, "test")


@pytest.mark.parametrize("bad", ["", "a-b", "a.b", "../run", "1x", "x" * 65])
def test_bad_kinds_are_refused(bad):
    with pytest.raises(ValueError):
        spec.driver(bad)


def test_unknown_kind_is_refused():
    with pytest.raises(ModuleNotFoundError):
        spec.driver("no_such_kind")


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell(ROOT, "no-such-cell")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(tiny_cell, name, trace):
    from benchmark import run

    cell = tiny_cell(name)
    result = run.execute(cell, 2 ** 31 + 5, 0.5, trace, torch.device("cpu"),
                         time.perf_counter(), compare.load_limits(name))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m.name for m in cell.end_to_end}
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                           "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
