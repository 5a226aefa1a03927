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
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
from sshslie_tpu.observability import LocalRunTracker as JaxTracker
from sshslie_tpu.observability import param_summary as jax_param_summary
from sshslie_tpu.train import init_params
from sshslie_torch.models.enhance import LowLightEnhanceNet
from sshslie_torch.observability import (LocalRunTracker, Logger, MLflowShim, Profiler,
                                         RunObserver, param_summary)

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
