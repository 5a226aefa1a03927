"""The readers of the program's spans (``harness/spans.py``): a Window and a
tracer filled on the CPU give the expected values; each reader is None in a
cell of the other kind, and where the program has no tracer; the traced
tiny cells report them, as BENCHMARK.json lists them."""

import time

import pytest
import torch

from benchmark.harness import compare, spec
from benchmark.harness.trace import TraceSummary
from benchmark.harness.window import Window
from conftest import ROOT

SPANS = {"step_enqueue_ms.train": "train", "step_enqueue_ms.train_bf16": "train",
         "first_step_s.train": "train", "first_step_s.train_bf16": "train",
         "serve_fetch_ms": "serve", "serve_lock_wait_ms": "serve"}


def _window(kind, items):
    return Window(kind, "float32", 1.0, 10, 1e9, trace=TraceSummary(1.0, 0.5),
                  traced_items=items)


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer in the program's place, on a clock that moves by 1 ms
    a reading."""
    from sshslie_torch import observability

    t = observability.Tracer()
    ticks = iter(range(0, 10 ** 12, 1_000_000))
    monkeypatch.setattr(observability, "TRACER", t)
    monkeypatch.setattr(observability, "_clock", lambda: next(ticks))
    return t


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        fn()


def test_train_readers(tracer):
    with tracer.span("train.step"):          # set-up's first step: 0 .. 3 ms
        with tracer.span("train.forward"):
            pass

    def steps():
        for _ in range(4):                   # 1 ms each: no child
            with tracer.span("train.step"):
                pass

    _profiled(steps)
    w = _window("train", 4)
    for name in ("step_enqueue_ms.train", "step_enqueue_ms.train_bf16"):
        assert spec.metric_reader(name)(w) == pytest.approx(1.0)
    for name in ("first_step_s.train", "first_step_s.train_bf16"):
        assert spec.metric_reader(name)(w) == pytest.approx(3e-3)


def test_serve_readers(tracer):
    def requests():
        for _ in range(2):
            with tracer.span("serve.request"):
                with tracer.span("serve.lock_wait"):       # 1 ms
                    pass
                with tracer.span("serve.fetch"):           # 3 ms
                    with tracer.span("serve.lock_wait"):   # 1 ms
                        pass

    _profiled(requests)
    w = _window("serve", 2)
    assert spec.metric_reader("serve_fetch_ms")(w) == pytest.approx(3.0)
    assert spec.metric_reader("serve_lock_wait_ms")(w) == pytest.approx(2.0)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_none_in_a_cell_of_the_other_kind(tracer, name):
    def both():
        for s in ("train.step", "serve.fetch", "serve.lock_wait"):
            with tracer.span(s):
                pass

    _profiled(both)
    other = "serve" if SPANS[name] == "train" else "train"
    assert spec.metric_reader(name)(_window(other, 3)) is None
    assert spec.metric_reader(name)(_window(SPANS[name], 3)) is not None


@pytest.mark.parametrize("name", sorted(SPANS))
def test_none_without_the_programs_tracer(monkeypatch, name):
    from sshslie_torch import observability

    monkeypatch.delattr(observability, "TRACER")
    assert spec.metric_reader(name)(_window(SPANS[name], 3)) is None


@pytest.mark.parametrize("name", sorted(SPANS))
def test_none_without_the_span(tracer, name):
    assert spec.metric_reader(name)(_window(SPANS[name], 3)) is None


def test_entries_in_benchmark_json():
    entries = {m["name"]: m for m in spec.load_spec(ROOT)["per_layer"]}
    for name, kind in SPANS.items():
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        for cell in m["workloads"]:
            loaded = spec.load_cell(ROOT, cell)
            assert spec.driver(loaded.traffic["kind"]).WORK == kind
            assert name in {p.name for p in loaded.per_layer}


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_spec(ROOT)["workloads"]])
def test_a_traced_tiny_cell_reports_its_span_metrics(tiny_cell, name):
    from benchmark import run

    cell = tiny_cell(name)
    mine = {m.name for m in cell.per_layer if m.source == "program_span"} & set(SPANS)
    result = run.execute(cell, 2 ** 31 + 11, 0.5, True, torch.device("cpu"),
                         time.perf_counter(), compare.load_limits(name))
    assert mine and mine <= set(result["metrics"])
    for m in mine:
        assert result["metrics"][m]["value"] > 0, m
