"""The port's bandwise metrics, metrics CLI, disk-scored eval and background
saver against the JAX package on the CPU.

* ``psnr_bandwise``, ``ssim_bandwise``, ``ssim_spatial`` and
  ``multi_img_bandwise_metrics`` under the three data_range kinds: float32
  reductions in another order, so PSNR within rtol 1e-5 and SSIM within 1e-5
  absolute (SSIMs near 0), as ``tests/test_torch_eval.py`` holds the
  pairwise metrics.
* The CLI (``python -m sshslie_torch.metrics``) prints JAX ``_main``'s numbers
  (4 decimals); without a card it raises unless asked for the CPU.
* ``eval_metric_source: disk`` scores the saved files: within 1e-6 of the
  in-memory scores (the same float32 values, saved and read back).
* ``_OverlappedSaver``: back-pressure at its depth, fail-fast on submit.
"""

import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax.numpy as jnp

from sshslie_tpu import metrics as jm
from sshslie_torch import evaluate, metrics as tm
from sshslie_torch.config import load_config
from sshslie_torch.data.datasets import CubeStore
from sshslie_torch.models.enhance import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = [None, 4095.0, (200.0, 3500.0)]


@pytest.fixture
def cubes():
    rng = np.random.default_rng(7)
    pred = (rng.random((20, 30, 12)) * 3000 + 100).astype(np.float32)
    gt = (rng.random((20, 30, 12)) * 4000).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("data_range", RANGES, ids=["none", "scalar", "pair"])
def test_bandwise_and_spatial_metrics_match_jax(cubes, data_range):
    pred, gt = cubes
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    got = tm.psnr_bandwise(pred, gt, data_range).numpy()
    assert got.shape == (12,)
    np.testing.assert_allclose(got, np.asarray(jm.psnr_bandwise(jp, jg, data_range)), rtol=1e-5)
    got = tm.ssim_bandwise(pred, gt, data_range).numpy()
    assert got.shape == (12,)
    np.testing.assert_allclose(got, np.asarray(jm.ssim_bandwise(jp, jg, data_range)), atol=1e-5)
    np.testing.assert_allclose(float(tm.ssim_spatial(pred, gt, data_range)),
                               float(jm.ssim_spatial(jp, jg, data_range)), atol=1e-5)


@pytest.fixture
def pairs(tmp_path):
    """Three predictions, two with ground truth, under tmp_path/{pred,gt}."""
    rng = np.random.default_rng(11)
    for sub in ("pred", "gt"):
        os.makedirs(tmp_path / sub)
    for i in range(3):
        sio.savemat(str(tmp_path / "pred" / f"c{i}.mat"),
                    {"data": (rng.random((18, 22, 8)) * 3500 + 200).astype(np.float32)})
        if i < 2:
            sio.savemat(str(tmp_path / "gt" / f"c{i}.mat"),
                        {"data": (rng.random((18, 22, 8)) * 4000).astype(np.float32)})
    return str(tmp_path / "pred"), str(tmp_path / "gt")


@pytest.mark.parametrize("lo,hi", [(None, None), (None, 4095.0), (200.0, 3800.0)],
                         ids=["none", "scalar", "pair"])
def test_multi_img_bandwise_metrics_match_jax(pairs, lo, hi):
    got = tm.multi_img_bandwise_metrics(*pairs, data_min=lo, data_max=hi, device="cpu")
    want = jm.multi_img_bandwise_metrics(*pairs, data_min=lo, data_max=hi)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    with pytest.raises(ValueError, match="data_min without data_max"):
        tm.multi_img_bandwise_metrics(*pairs, data_min=1.0, device="cpu")


def _avg_lines(text):
    return [line for line in text.splitlines() if line.startswith("===> Avg.")]


def test_metrics_cli_prints_the_jax_numbers(pairs, capsys):
    args = [os.path.join(pairs[0], "*.mat"), pairs[1], "--data_max", "4095"]
    jm._main(args)
    want = _avg_lines(capsys.readouterr().out)
    tm._main(args + ["--device", "cpu"])
    assert _avg_lines(capsys.readouterr().out) == want and len(want) == 3
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "sshslie_torch.metrics", *args, "--device", "cpu"],
                          capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert _avg_lines(proc.stdout) == want


def test_metrics_entry_points_need_a_card_unless_cpu_is_asked(pairs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm._main([os.path.join(pairs[0], "*.mat"), pairs[1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.multi_img_bandwise_metrics(*pairs)


def test_disk_metric_source_matches_memory(tmp_path):
    rng = np.random.default_rng(5)
    for sub in ("low", "high"):
        os.makedirs(tmp_path / sub)
    for name in ("a.mat", "b.mat"):
        for sub, scale in (("low", 1200.0), ("high", 3800.0)):
            sio.savemat(str(tmp_path / sub / name),
                        {"data": (rng.random((24, 24, 6)) * scale + 200).astype(np.float32)})
    kw = dict(channels=6, global_min=200.0, global_max=4095.0, device="cpu",
              save_reflectance=True)
    store = CubeStore(str(tmp_path / "low"), normalization="global_normalization",
                      global_min=200.0, global_max=4095.0)
    model = build_model(load_config(None, kw), 6, generator=torch.Generator().manual_seed(3))
    scores = {}
    for source in ("memory", "disk"):
        view = types.SimpleNamespace(cfg=load_config(None, dict(kw, eval_metric_source=source)),
                                     model=model)
        scores[source] = evaluate.evaluate_model(view, store, str(tmp_path / source), 1,
                                                 str(tmp_path / "high"))
        for name in ("a", "b"):
            assert os.path.exists(tmp_path / source / "epoch_1" / f"{name}.mat")
            assert os.path.exists(tmp_path / source / "epoch_1" / "artifacts" / f"{name}_R_low.mat")
    assert set(scores["disk"]) == {"psnr", "ssim", "sam"}
    for k, v in scores["memory"].items():
        assert abs(scores["disk"][k] - v) <= 1e-6 * max(1.0, abs(v)), (k, scores)


def test_overlapped_saver_back_pressure_and_fail_fast():
    saver = evaluate._OverlappedSaver(depth=2)
    gate = threading.Event()
    done = []

    def slow(i):
        gate.wait(timeout=30)
        done.append(i)

    saver.submit(slow, 0)
    saver.submit(slow, 1)
    blocked = threading.Thread(target=saver.submit, args=(slow, 2))
    blocked.start()
    blocked.join(timeout=0.3)
    assert blocked.is_alive() and done == []       # a third save waits for the first
    gate.set()
    blocked.join(timeout=30)
    assert not blocked.is_alive()
    saver.close()
    assert done == [0, 1, 2]

    def fail(_):
        raise OSError("disk full")

    saver = evaluate._OverlappedSaver(depth=2)
    saver.submit(fail, 0)
    saver.submit(lambda _: None, 1)
    with pytest.raises(OSError, match="disk full"):
        saver.submit(lambda _: None, 2)             # surfaces at the next submit past the depth
    saver.close()
    with pytest.raises(OSError, match="disk full"):
        with evaluate._OverlappedSaver() as owned:
            owned.submit(fail, 0)
