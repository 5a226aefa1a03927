"""The port's run tracking, plots and profiler against the JAX package's on the CPU.

* ``LocalRunTracker``: the same calls write byte-equal ``params.json`` and
  ``metrics.jsonl`` and the same artifact files as the JAX tracker.
* ``MLflowShim``: without mlflow it falls back to the file tracker; a failing
  backend degrades to the file tracker, a failing file tracker to none.
* ``param_summary``: the stock model at 6 bands has the JAX model's total, and
  the same multiset of tensor sizes.
* ``RunObserver``: the plots render on the worker and inline; a failed plot
  is printed, never raised.
* ``Profiler``: a Chrome trace (JSON) of CPU activity.
* ``Tracer``: nesting, parents and shared root ids across threads; self
  time; the buffer's bound with the totals kept past it; ``reset``; the
  first instances kept with no profiler, at no profiler call, clock or
  device call afterwards; each recorded span a ``user_annotation`` range of
  the profiler's Chrome trace, nested as in memory, of the same duration.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
from sshslie_tpu.observability import LocalRunTracker as JaxTracker
from sshslie_tpu.observability import param_summary as jax_param_summary
from sshslie_tpu.train import init_params
from sshslie_torch.models.enhance import LowLightEnhanceNet
from sshslie_torch import observability
from sshslie_torch.observability import (LocalRunTracker, Logger, MLflowShim, Profiler,
                                         RunObserver, Tracer, param_summary)

LOSS_KEYS = ("total_loss", "L_reconstruction", "L_R_fidelity", "L_I_smooth_low",
             "L_I_smooth_delta", "L_fourier", "L_spectral_cons")


def _track(tracker, artifact):
    tracker.set_experiment("exp1")
    with tracker.start_run():
        tracker.log_params({"phase": "train", "seed": 41, "lr": 0.001, "adaptive_lr": False,
                            "weird": [1, 2], "none": None})
        tracker.log_param("data_train", "./data/low/train")
        tracker.log_metric("learning_rate", 1e-3, step=0)
        tracker.log_metrics({"total_loss": np.float32(1.25), "L_fourier": 0.1}, step=0)
        tracker.log_metric("PSNR_dB", 31.5)
        tracker.log_artifact(artifact)
        tracker.log_artifact(artifact, artifact_path="run_logs")
        tracker.log_artifact(artifact + ".missing")


def test_local_tracker_files_equal_jax(tmp_path):
    art = tmp_path / "a.txt"
    art.write_text("artifact")
    _track(JaxTracker(str(tmp_path / "jax")), str(art))
    _track(LocalRunTracker(str(tmp_path / "port")), str(art))
    for name in ("params.json", "metrics.jsonl", "artifacts/a.txt", "artifacts/run_logs/a.txt"):
        assert (tmp_path / "port" / "exp1" / name).read_bytes() == \
            (tmp_path / "jax" / "exp1" / name).read_bytes(), name
    walk = {p: sorted(os.path.relpath(os.path.join(d, f), p) for d, _, fs in os.walk(p) for f in fs)
            for p in (str(tmp_path / "jax"), str(tmp_path / "port"))}
    assert walk[str(tmp_path / "jax")] == walk[str(tmp_path / "port")]
    params = json.loads((tmp_path / "port" / "exp1" / "params.json").read_text())
    assert params["weird"] == "[1, 2]" and params["seed"] == 41


def test_mlflow_shim_falls_back_to_local(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "mlflow", None)     # mlflow absent, as on both machines
    shim = MLflowShim(enabled=True)
    assert shim.active and isinstance(shim._backend, LocalRunTracker)
    shim.set_experiment("e")
    with shim.start_run():
        shim.log_metric("m", 1.0, step=0)
    assert os.path.exists("runs/e/metrics.jsonl")
    off = MLflowShim(enabled=False)
    assert not off.active
    with off.start_run():
        off.log_metric("m", 1.0)
    assert not os.path.exists("runs/default")


def test_mlflow_shim_degrades_on_backend_failure(tmp_path, capsys):
    shim = MLflowShim(enabled=True, local_root=str(tmp_path / "runs"))

    class _Dead:
        def __getattr__(self, name):
            def boom(*a, **k):
                raise ConnectionError("tracking server unreachable")
            return boom

    shim._backend = _Dead()
    shim.set_experiment("exp")
    assert isinstance(shim._backend, LocalRunTracker)
    shim.log_param("k", "v")
    with shim.start_run():
        shim.log_metric("m", 1.0, step=0)
    assert json.loads((tmp_path / "runs" / "exp" / "params.json").read_text()) == {"k": "v"}
    assert "falling back to file tracker" in capsys.readouterr().out

    # The file tracker failing too (an unwritable root) turns tracking off.
    blocker = tmp_path / "file"
    blocker.write_text("")
    broken = MLflowShim(enabled=True, local_root=str(blocker))
    broken._backend = LocalRunTracker(str(blocker))
    broken.log_metric("m", 1.0)
    assert not broken.active
    broken.log_params({"a": 1})
    assert "disabling run tracking" in capsys.readouterr().out


def test_param_summary_total_matches_jax():
    jax_summary = jax_param_summary(init_params(JaxNet(input_channels=6), 0, 16))
    model = LowLightEnhanceNet(6)
    summary = param_summary(model)
    total = sum(p.numel() for p in model.parameters())
    assert summary.splitlines()[-1] == jax_summary.splitlines()[-1] == f"Total params: {total:,}"

    def sizes(text):
        return sorted(int(line.split()[-1].replace(",", "")) for line in text.splitlines()[2:-2])

    assert sizes(summary) == sizes(jax_summary)
    assert "decomposition_net.shallow_conv.0.weight" in summary


@pytest.mark.parametrize("async_plots", [True, False], ids=["worker", "inline"])
def test_plots_render(tmp_path, async_plots):
    obs = RunObserver(async_plots=async_plots)
    obs.plot_loss_curve({k: [1.0, 0.5, 0.3] for k in LOSS_KEYS}, str(tmp_path / "loss.png"))
    obs.plot_eval_metrics({1: {"psnr": 30.0, "ssim": 0.9, "sam": 0.1},
                           2: {"psnr": 31.0, "ssim": 0.92, "sam": 0.09}}, str(tmp_path / "eval.png"))
    obs.drain()
    for name in ("loss.png", "eval.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("async_plots", [True, False], ids=["worker", "inline"])
def test_failed_plot_is_printed_not_raised(tmp_path, capsys, async_plots):
    obs = RunObserver(async_plots=async_plots)
    obs.plot_loss_curve({"total_loss": [1.0]}, str(tmp_path / "loss.png"))   # missing panels
    obs.drain()
    assert "plot failed: KeyError" in capsys.readouterr().out


def test_model_summary_is_logged(tmp_path):
    shim = MLflowShim(enabled=True, local_root=str(tmp_path / "runs"))
    shim.set_experiment("exp")
    RunObserver().log_model_summary(LowLightEnhanceNet(6), str(tmp_path / "ck"), shim)
    text = (tmp_path / "ck" / "model_summary.txt").read_text()
    assert (tmp_path / "runs" / "exp" / "artifacts" / "model_summary.txt").read_text() == text


def test_logger_tees(tmp_path, capsys):
    logpath = str(tmp_path / "logs" / "log.txt")
    orig = sys.stdout
    logger = Logger(logpath)
    sys.stdout = logger
    try:
        print("hello tee")
    finally:
        sys.stdout = orig
        logger.close()
    assert "hello tee" in open(logpath).read()
    assert "hello tee" in capsys.readouterr().out


def test_profiler_writes_a_chrome_trace(tmp_path):
    with Profiler(str(tmp_path / "prof"), torch.device("cpu")) as prof:
        torch.nn.functional.conv2d(torch.ones(1, 2, 8, 8), torch.ones(3, 2, 3, 3)).sum()
    assert not prof.active and os.path.dirname(prof.path) == str(tmp_path / "prof")
    trace = json.load(open(prof.path))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::conv2d" in names
    with Profiler("") as off:
        pass
    assert off.path is None


def _recording():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _forbid(monkeypatch, *names):
    """Make each ``module.attribute`` of ``names`` raise when called."""
    def refuse(*_a, **_k):
        raise AssertionError("called with no profiler recording")

    for name in names:
        monkeypatch.setattr(name, refuse)


def _by_name(records):
    return {r.name: r for r in records}


def test_spans_nest_and_share_their_root_across_threads():
    t = Tracer()
    opened, done = threading.Event(), threading.Event()

    def other():
        with t.span("req"):
            opened.set()
            with t.span("req.inner"):
                done.wait(5)

    with _recording():
        with t.span("step"):
            worker = threading.Thread(target=other)
            worker.start()
            assert opened.wait(5)
            with t.span("step.a"):
                with t.span("step.a.b"):
                    pass
            with t.span("step.c"):
                pass
            done.set()
            worker.join()
    got = _by_name(t.spans())
    step, a, b, c = got["step"], got["step.a"], got["step.a.b"], got["step.c"]
    req, inner = got["req"], got["req.inner"]
    assert step.parent is None and step.root == step.id
    assert a.parent == step.id and c.parent == step.id and b.parent == a.id
    assert {a.root, b.root, c.root} == {step.id}
    assert req.parent is None and req.root == req.id != step.id
    assert inner.parent == req.id and inner.root == req.id
    assert req.thread != step.thread and inner.thread == req.thread
    assert len({r.id for r in got.values()}) == 6
    assert step.start_ns <= a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns
    assert c.end_ns <= step.end_ns


def test_threads_lose_no_span():
    """More threads than cores, a short switch interval: every span of every
    thread is counted, buffered and nested under its own thread's root."""
    t = Tracer()
    threads, each = 2 * (os.cpu_count() or 4), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _recording():
            def work():
                for _ in range(each):
                    with t.span("outer"):
                        with t.span("inner"):
                            pass

            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    summary = t.summary()
    assert summary["outer"]["count"] == summary["inner"]["count"] == threads * each
    spans = t.spans()
    assert len(spans) == 2 * threads * each and t.dropped == 0
    outer = {r.id: r for r in spans if r.name == "outer"}
    for r in spans:
        if r.name == "inner":
            assert outer[r.parent].thread == r.thread and r.root == r.parent


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    ticks = iter([0, 10, 30, 40, 70, 100, 200, 205])
    monkeypatch.setattr(observability, "_clock", lambda: next(ticks))
    t = Tracer()
    with _recording():
        with t.span("outer"):            # 0 .. 100
            with t.span("one"):          # 10 .. 30
                pass
            with t.span("two"):          # 40 .. 70
                pass
        with t.span("one"):              # 200 .. 205
            pass
    got = {(r.name, r.start_ns): r for r in t.spans()}
    assert got[("outer", 0)].self_ns == 100 - 20 - 30
    assert got[("one", 10)].self_ns == 20 and got[("two", 40)].self_ns == 30
    summary = t.summary()
    assert summary["outer"] == pytest.approx({"count": 1, "total_s": 100e-9, "self_s": 50e-9})
    assert summary["one"]["count"] == 2
    assert summary["one"]["total_s"] == pytest.approx(25e-9)
    assert summary["one"]["self_s"] == pytest.approx(25e-9)


def test_buffer_is_bounded_and_the_totals_keep_every_span():
    t = Tracer(capacity=3)
    with _recording():
        for _ in range(5):
            with t.span("x"):
                pass
    kept = t.spans()
    assert len(kept) == 3 and t.dropped == 2
    summary = t.summary()["x"]
    assert summary["count"] == 5
    assert summary["total_s"] >= sum(r.seconds for r in kept)
    assert summary["self_s"] == pytest.approx(summary["total_s"])


def test_reset_empties_the_buffer_and_totals_but_keeps_the_first_instances():
    t = Tracer(capacity=1)
    with _recording():
        for _ in range(2):
            with t.span("x"):
                pass
    cold = t.cold()
    t.reset()
    assert t.summary() == {} and t.spans() == [] and t.dropped == 0
    assert t.cold() == cold and set(cold) == {"x"}


def test_first_instances_are_kept_with_no_profiler(monkeypatch):
    t = Tracer()
    with t.span("step"):
        with t.span("step.forward"):
            time.sleep(0.002)
    cold = t.cold()
    assert set(cold) == {"step", "step.forward"}
    assert cold["step.forward"].parent == cold["step"].id
    assert cold["step"].seconds >= cold["step.forward"].seconds >= 0.002
    assert t.summary() == {} and t.spans() == []
    # Later instances: no clock, no profiler call, no device call, one shared object.
    _forbid(monkeypatch, "torch.autograd.profiler.record_function",
            "torch.profiler.record_function", "torch.cuda.synchronize", "torch.cuda.Event",
            "sshslie_torch.observability._clock")
    assert t.span("step") is t.span("step.forward")
    with t.span("step"):
        with t.span("step.forward"):
            pass
    assert t.cold() == cold and t.summary() == {}


def test_no_profiler_call_while_nothing_records(monkeypatch):
    _forbid(monkeypatch, "torch.autograd.profiler.record_function",
            "torch.profiler.record_function", "torch.cuda.synchronize", "torch.cuda.Event")
    t = Tracer()
    for _ in range(3):
        with t.span("a"):
            with t.span("b"):
                pass
    assert set(t.cold()) == {"a", "b"} and t.spans() == []


def _recorded_demo(path):
    """Four nested spans under a CPU profiler -> (the tracer's records by
    name, the trace's ``user_annotation`` events by name)."""
    t = Tracer()
    with _recording() as prof:
        with t.span("demo.step"):
            with t.span("demo.forward"):
                time.sleep(0.003)
                with t.span("demo.inner"):
                    time.sleep(0.002)
            with t.span("demo.adam"):
                time.sleep(0.002)
    prof.export_chrome_trace(path)
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("demo.")]
    trace = {e["name"]: e for e in events}
    assert len(events) == len(trace) == 4
    return _by_name(t.spans()), trace


def test_recorded_spans_are_user_annotations_of_the_chrome_trace(tmp_path, monkeypatch):
    """Names and nesting in every recording; durations within 10% or 50 us in
    one of three, since a loaded host can stall the thread for milliseconds
    between a span's clock read and the profiler's own timestamp."""
    _forbid(monkeypatch, "torch.cuda.synchronize", "torch.cuda.Event")
    apart = []
    for attempt in range(3):
        mine, trace = _recorded_demo(str(tmp_path / f"trace{attempt}.json"))
        assert set(mine) == set(trace)
        assert mine["demo.inner"].parent == mine["demo.forward"].id
        assert mine["demo.adam"].parent == mine["demo.step"].id
        for name, rec in mine.items():
            if rec.parent is None:
                continue
            up = next(r.name for r in mine.values() if r.id == rec.parent)
            child, parent = trace[name], trace[up]
            assert float(parent["ts"]) <= float(child["ts"]), name
            assert (float(child["ts"]) + float(child["dur"])
                    <= float(parent["ts"]) + float(parent["dur"])), name
        off = {name: (float(trace[name]["dur"]), rec.seconds * 1e6)
               for name, rec in mine.items()
               if abs(float(trace[name]["dur"]) - rec.seconds * 1e6)
               > max(0.1 * rec.seconds * 1e6, 50.0)}
        if not off:
            return
        apart.append(off)
    pytest.fail(f"trace and tracer durations (us) apart in every recording: {apart}")
