"""The port's training engine around the steps, against the JAX package's
behaviour (tests/test_train.py) on the CPU, at 24x24x6 cubes.

* ``async_eval``: every eval runs on the ``async-eval`` worker, from a
  snapshot of the weights, and scores exactly as a synchronous
  ``evaluate_model`` of the model loaded from ``model_epoch_N.pth`` (the same
  float32 arithmetic on the same weights).
* ``checkpoint_best`` on the sync and async paths, its re-arm after a prune,
  off by default.
* ``checkpoint_async``: the background writer's files load equal to the
  synchronous ones, exactly.
* SIGTERM: the epoch finishes, ``model_epoch_latest.pth`` is written with the
  Adam state, fit returns and the default handler is back; resumed from it,
  the fused pipeline's epoch terms equal the uninterrupted run's exactly.
* ``runner.main`` on ``train_and_test`` leaves the JAX runner's ``runs/``
  param and metric keys, plots, and a ``profile_dir`` trace.
* The launch counts stay exact with two threads counting.
"""

import builtins
import glob
import json
import os
import signal
import sys
import threading

import numpy as np
import pytest
import scipy.io as sio
import torch

from sshslie_torch import checkpoints, evaluate, interop, runner
from sshslie_torch.config import load_config
from sshslie_torch.data.datasets import CubeStore
from sshslie_torch.models.enhance import build_model
from sshslie_torch.ops import attention, conv9
from sshslie_torch.train import LOSS_KEYS, Trainer, report_hbm_pressure

KW = dict(channels=6, patch_size=16, batch_size=2, epoch=2, eval_every_epoch=100,
          plot_every_epoch=100, start_lr=1e-3, global_min=0.0, global_max=4095.0,
          device="cpu")


def _cfg(**kw):
    return load_config(None, dict(KW, **kw))


@pytest.fixture
def cube_dir(tmp_path, monkeypatch):
    """Two 24x24x6 cubes (raw 0..4000) and their ground truth; cwd = tmp_path."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(2026)
    for sub in ("cubes", "gt"):
        os.makedirs(sub)
    for i in range(2):
        sio.savemat(f"cubes/c{i}.mat", {"data": (rng.random((24, 24, 6)) * 4000).astype(np.float32)})
        sio.savemat(f"gt/c{i}.mat", {"data": (rng.random((24, 24, 6)) * 4000).astype(np.float32)})
    return "cubes"


def _store(d):
    return CubeStore(d, normalization="global_normalization", global_min=0.0, global_max=4095.0)


def _fake_evaluator(psnr_by_epoch):
    def evaluator(view, eval_store, out_dir, epoch, label_dir):
        return {"psnr": psnr_by_epoch[epoch], "ssim": 0.5, "sam": 0.1}
    return evaluator


def test_async_eval_runs_on_its_worker_and_scores_as_a_sync_eval(cube_dir):
    cfg = _cfg(epoch=3, eval_every_epoch=1, async_eval=True)
    trainer = Trainer(cfg, 6)
    threads = {}

    def evaluator(view, eval_store, out_dir, epoch, label_dir):
        threads[epoch] = threading.current_thread().name
        assert view.model is not trainer.model
        return evaluate.evaluate_model(view, eval_store, out_dir, epoch, label_dir)

    trainer.fit(_store(cube_dir), eval_store=_store(cube_dir), evaluator=evaluator,
                ckpt_dir="ck", eval_result_dir="ev", label_dir="gt")
    assert sorted(threads) == [1, 2, 3]
    assert all(name.startswith("async-eval") for name in threads.values())
    assert sorted(trainer.eval_metrics) == [1, 2, 3]
    # The weights kept training between the snapshots.
    assert len({m["psnr"] for m in trainer.eval_metrics.values()}) == 3
    for ep in (1, 2, 3):
        model = build_model(cfg, 6)
        interop.load_checkpoint(checkpoints.epoch_path("ck", ep), model)
        view = type("View", (), {"cfg": cfg, "model": model})()
        assert evaluate.evaluate_model(view, _store(cube_dir), "re", ep, "gt") \
            == trainer.eval_metrics[ep]
        assert os.path.exists(os.path.join("ev", f"epoch_{ep}", "c1.mat"))


def test_sync_eval_saves_land_before_fit_returns(cube_dir):
    trainer = Trainer(_cfg(epoch=2, eval_every_epoch=1), 6)
    trainer.fit(_store(cube_dir), eval_store=_store(cube_dir),
                evaluator=evaluate.evaluate_model, ckpt_dir="ck", eval_result_dir="ev",
                label_dir="gt")
    assert trainer.eval_saver is None and sorted(trainer.eval_metrics) == [1, 2]
    for ep in (1, 2):
        assert sorted(os.listdir(os.path.join("ev", f"epoch_{ep}"))) == ["c0.mat", "c1.mat"]


@pytest.mark.parametrize("use_async", [False, True], ids=["sync", "async"])
def test_checkpoint_best_tracks_eval_psnr(cube_dir, use_async):
    trainer = Trainer(_cfg(epoch=3, eval_every_epoch=1, checkpoint_best=True,
                           async_eval=use_async), 6)
    trainer.fit(_store(cube_dir), eval_store=_store(cube_dir),
                evaluator=_fake_evaluator({1: 3.0, 2: 5.0, 3: 2.0}), ckpt_dir="ck",
                eval_result_dir="ev")
    best = checkpoints.best_path("ck")
    with open(best, "rb") as fh, open(checkpoints.epoch_path("ck", 2), "rb") as fh2:
        assert fh.read() == fh2.read()
    assert not os.path.exists(best + ".tmp")


def test_checkpoint_best_rearms_after_prune(cube_dir):
    """The winning epoch's file pruned before its deferred copy: the tracker
    falls back to the best epoch on disk, so a later epoch that beats that
    one (but not the pruned maximum) is still copied. Eval 1 (PSNR 10, the
    run's maximum) deletes its own epoch file; eval 3 (PSNR 7) must win,
    however late the evals finish against the epochs."""
    import time

    trainer = Trainer(_cfg(epoch=4, eval_every_epoch=1, checkpoint_best=True, async_eval=True,
                           checkpoint_async=False), 6)
    psnr_by_epoch = {1: 10.0, 2: 5.0, 3: 7.0, 4: 2.0}

    def evaluator(view, eval_store, out_dir, epoch, label_dir):
        if epoch == 1:
            path = checkpoints.epoch_path("ck", 1)
            deadline = time.time() + 30
            while time.time() < deadline and not os.path.exists(path):
                time.sleep(0.01)
            os.remove(path)
        return {"psnr": psnr_by_epoch[epoch], "ssim": 0.5, "sam": 0.1}

    trainer.fit(_store(cube_dir), eval_store=_store(cube_dir), evaluator=evaluator,
                ckpt_dir="ck", eval_result_dir="ev")
    best = checkpoints.best_path("ck")
    assert os.path.exists(best), "best tracker wedged on a pruned epoch"
    assert interop.load_checkpoint(best, build_model(trainer.cfg, 6)) == 3


def test_checkpoint_best_off_by_default(cube_dir):
    trainer = Trainer(_cfg(epoch=2, eval_every_epoch=1), 6)
    trainer.fit(_store(cube_dir), eval_store=_store(cube_dir),
                evaluator=_fake_evaluator({1: 3.0, 2: 5.0}), ckpt_dir="ck", eval_result_dir="ev")
    assert not os.path.exists(checkpoints.best_path("ck"))
    assert sorted(os.listdir("ck")) == ["model_epoch_1.pth", "model_epoch_2.pth",
                                        "model_epoch_latest.pth"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_trees_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_async_checkpoint_files_load_equal_to_sync(cube_dir):
    for async_on in (True, False):
        trainer = Trainer(_cfg(epoch=3, eval_every_epoch=1, checkpoint_async=async_on,
                               checkpoint_keep=2), 6)
        trainer.fit(_store(cube_dir), ckpt_dir=f"ck_{async_on}")
    names = ["model_epoch_2.pth", "model_epoch_3.pth", "model_epoch_latest.pth"]
    assert sorted(os.listdir("ck_True")) == sorted(os.listdir("ck_False")) == names
    for name in names:
        got, want = _load(os.path.join("ck_True", name)), _load(os.path.join("ck_False", name))
        assert got["optimizer_state_dict"]["state"]
        _assert_trees_equal(got, want, name)


def _fit_signalled(trainer, store, ckpt_dir, after_epoch):
    """fit, with SIGTERM sent to this process once the epoch line of
    ``after_epoch`` is printed (the main thread takes it right there)."""
    fired = []
    orig = builtins.print

    def hooked(*args, **kw):
        orig(*args, **kw)
        if not fired and args and str(args[0]).startswith(f"Epoch [{after_epoch}/"):
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    builtins.print = hooked
    try:
        trainer.fit(store, ckpt_dir=ckpt_dir)
    finally:
        builtins.print = orig
    assert fired


def test_sigterm_checkpoints_and_stops(cube_dir):
    trainer = Trainer(_cfg(epoch=50), 6)
    _fit_signalled(trainer, _store(cube_dir), "ck", after_epoch=2)
    assert len(trainer.all_epoch_losses["total_loss"]) == 2
    ck = _load(checkpoints.latest_path("ck"))
    assert ck["epoch"] == 2 and ck["optimizer_state_dict"]["state"]
    _assert_trees_equal(ck["model_state_dict"], trainer.model.state_dict())
    assert os.listdir("ck") == ["model_epoch_latest.pth"]
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    assert signal.getsignal(signal.SIGINT) == signal.default_int_handler


def test_resume_after_sigterm_replays_the_uninterrupted_fused_run(cube_dir):
    kw = dict(fused_pipeline="on", steps_per_dispatch=1)
    sd = Trainer(_cfg(**kw), 6).model.state_dict()
    straight = Trainer(_cfg(epoch=3, **kw), 6, state_dict=sd)
    straight.fit(_store(cube_dir), ckpt_dir="straight")
    stopped = Trainer(_cfg(epoch=50, **kw), 6, state_dict=sd)
    _fit_signalled(stopped, _store(cube_dir), "ck", after_epoch=1)
    assert stopped.pipeline == "fused" and _load(checkpoints.latest_path("ck"))["epoch"] == 1
    resumed = Trainer(_cfg(epoch=3, resume=True, **kw), 6, state_dict=sd)
    resumed.fit(_store(cube_dir), ckpt_dir="ck")
    for k in LOSS_KEYS:
        assert stopped.all_epoch_losses[k] + resumed.all_epoch_losses[k] \
            == straight.all_epoch_losses[k], k


def test_runner_train_and_test_tracks_the_run_as_jax(tmp_path, monkeypatch, rng):
    from conftest import make_synthetic_dataset
    from sshslie_tpu import runner as jax_runner
    from sshslie_tpu.config import load_config as jax_load_config

    monkeypatch.chdir(tmp_path)
    make_synthetic_dataset(str(tmp_path), rng, n_train=2, h=24, w=24, c=6)
    kw = dict(channels=6, global_min=200.0, global_max=3800.0, batch_size=2, patch_size=16,
              epoch=2, eval_every_epoch=1, plot_every_epoch=1, phase="train_and_test",
              train_data="./data/low/train", eval_data="./data/low/test",
              test_data="./data/low/test", label_dir="./data/high/test", model_name="run",
              attention_impl="xla")
    runs = {}
    for name, main, cfg in (
            ("jax", jax_runner.main, jax_load_config(None, dict(kw, device="cpu", jit_cache_dir="",
                                                                 timestamp="jax"))),
            ("port", runner.main, load_config(None, dict(kw, device="cpu", timestamp="port",
                                                         async_eval=True, checkpoint_best=True,
                                                         profile_dir="./prof")))):
        main(cfg)
        d = os.path.join("runs", cfg.full_model_name)
        metrics = [json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
        runs[name] = dict(
            params=set(json.load(open(os.path.join(d, "params.json")))),
            metrics=[(m["step"], sorted(m)) for m in metrics],
            artifacts=sorted(os.path.relpath(os.path.join(r, f), d)
                             for r, _, fs in os.walk(os.path.join(d, "artifacts")) for f in fs),
            plots=sorted(os.path.basename(p) for p in glob.glob(os.path.join(
                cfg.eval_result_dir, "*.png"))))
    jax_art = [a.replace("console_output_run_jax", "console_output_run_port")
               for a in runs["jax"]["artifacts"]]
    assert runs["port"]["params"] == runs["jax"]["params"]
    assert runs["port"]["metrics"] == runs["jax"]["metrics"]
    assert runs["port"]["artifacts"] == jax_art
    assert runs["port"]["plots"] == runs["jax"]["plots"] == ["eval_metrics.png", "loss_curves.png"]
    assert {"PSNR_dB", "SSIM", "SAM", "learning_rate", "model_path"} <= \
        runs["port"]["params"] | {k for _, ks in runs["port"]["metrics"] for k in ks}
    traces = glob.glob("prof/*.json")
    assert len(traces) == 1 and json.load(open(traces[0]))["traceEvents"]
    assert os.path.exists(checkpoints.best_path(os.path.join("checkpoint", "run",
                                                             "Decomposition_port")))


@pytest.mark.parametrize("module,wrapper,count", [
    (conv9, "conv9_fwd", lambda: conv9._count(conv9.conv9_fwd, torch.float32)),
    (attention, "flash_attention", lambda: attention._count(torch.bfloat16)),
], ids=["conv9", "flash_attention"])
def test_launch_counts_stay_exact_across_threads(module, wrapper, count):
    wrapper = getattr(module, wrapper)
    module.reset_counts()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count() for _ in range(10_000)])
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert wrapper.launches == 20_000
        assert sum(wrapper.launches_by_dtype.values()) == 20_000
        assert sum(wrapper.launches_by_shape.values()) == 20_000
        # The count is taken under the module's lock: held here, a counting
        # thread waits for it.
        with module._COUNT_LOCK:
            t = threading.Thread(target=count)
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive() and wrapper.launches == 20_000
        t.join(timeout=30)
        assert not t.is_alive() and wrapper.launches == 20_001
    finally:
        sys.setswitchinterval(switch)
        module.reset_counts()


def test_memory_line_is_none_on_the_cpu():
    assert report_hbm_pressure(torch.device("cpu")) is None
