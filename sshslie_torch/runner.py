"""Run entry of the port: ``python -m sshslie_torch --config … --phase
train|test|train_and_test|serve``.

As ``sshslie_tpu/runner.py``: stdout teed to
``logs/console_output_<run>.log``, the parameters printed, Python, numpy and
torch seeded, the channel count taken from the first training cube when the
config leaves it out. ``train`` builds a ``Trainer`` (warm-started from
``pretrained_model`` when given; ``freeze_decom_epochs`` applies only then)
and runs ``run_train``; ``test`` runs ``run_test`` and ``run_eval_metrics``
on ``model_epoch_latest.pth`` of ``test_timestamp``; ``train_and_test`` does
both, testing from the checkpoint the run just wrote; ``serve`` serves
``model_epoch_latest.pth`` of ``test_timestamp`` over HTTP until stopped
(``serve.serve_from_config``). The two TF32 switches of cuDNN and cuBLAS are
set from ``matmul_precision`` (``device.set_matmul_precision``: off for
'', float32 and highest) on every call, and printed.

Every run is tracked as in the JAX package (``observability.MLflowShim``,
``use_mlflow``): one experiment named after the run, its params and loss
weights, the config file, the git commit and the port's own source files,
the data directories, the trainer's params and epoch metrics, the test
phase's ``PSNR_dB``/``SSIM``/``SAM`` and the console log under
``run_logs``; without mlflow, as files under ``runs/<experiment>/``.

With ``mesh_shape: "N"`` the run is data parallel over N processes, one per
GPU, as the JAX runner's mesh: ``torchrun --nproc_per_node N -m
sshslie_torch --config cfg.yml --mesh_shape N``; with ``mesh_shape: "DxS"``
and ``space_axis`` (``--nproc_per_node`` D·S) the patch height is also split
over S of them (dp×sp). ``main`` joins the group
(``parallel.distributed.initialize_distributed``: NCCL on the card, gloo
with ``device: cpu``), builds the mesh (``parallel.mesh.make_mesh`` with the
axes ``(data_axis, space_axis or "space")``; its size must be the world
size) and prints it, and takes rank 0's run names
(``timestamp`` and the directories derived from it), so that every rank
reads what rank 0 writes. Rank 0 alone tracks, tees to
``logs/console_output_<run>.log`` (rank r > 0 to ``..._rank<r>.log``) and
scores the test phase; every rank trains, and every rank runs the test
phase's forward (height- or band-sharded with ``eval_sharded``). A group
that ``main`` joined is left when it returns.

A config value the port cannot honour raises (``config.check_ported``).
"""

from __future__ import annotations

import os
import random
import sys
import traceback
from glob import glob

import numpy as np
import torch

from sshslie_torch.config import _DERIVED_FIELDS, Config, check_ported, parse_args
from sshslie_torch.device import resolve_device, set_matmul_precision
from sshslie_torch.observability import Logger, MLflowShim, RunObserver

_TRAINING = ("train", "train_and_test")


def _log_source_artifacts(mlflow) -> None:
    """Log the git commit of the checkout (only when the package's parent
    directory is the checkout's top level) and the port's engine modules, so
    that every run says what code made it (reference main.py:243-248)."""
    import subprocess

    pkg = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(pkg)
    try:
        toplevel = subprocess.run(["git", "-C", root, "rev-parse", "--show-toplevel"],
                                  capture_output=True, text=True, timeout=10).stdout.strip()
        head = ""
        if toplevel and os.path.realpath(toplevel) == os.path.realpath(root):
            head = subprocess.run(["git", "-C", root, "rev-parse", "HEAD"],
                                  capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        head = ""
    if head:
        mlflow.log_param("source_git_commit", head)
    for name in ("runner.py", "config.py", "train.py", "evaluate.py", "metrics.py"):
        path = os.path.join(pkg, name)
        if os.path.exists(path):
            mlflow.log_artifact(path)


def run_train(trainer, cfg: Config) -> None:
    """Fit on ``cfg.train_data`` with the mid-training eval on ``cfg.eval_data``."""
    from sshslie_torch.data.datasets import store_from_config
    from sshslie_torch.evaluate import evaluate_model

    trainer.fit(store_from_config(cfg, cfg.train_data),
                eval_store=store_from_config(cfg, cfg.eval_data),
                evaluator=evaluate_model, eval_result_dir=cfg.eval_result_dir,
                label_dir=cfg.label_dir)


def _build_trainer(cfg: Config, channels: int, device: torch.device, mlflow: MLflowShim,
                   mesh=None, writer: bool = True):
    from sshslie_torch.train import Trainer

    trainer = Trainer(cfg, channels, device, mlflow=mlflow,
                      observer=RunObserver() if writer else None, mesh=mesh)
    if cfg.pretrained_model and not os.path.exists(cfg.pretrained_model):
        raise FileNotFoundError(f"pretrained_model {cfg.pretrained_model!r} does not exist")
    if cfg.pretrained_model:
        print(f"Loading pretrained model from: {cfg.pretrained_model}")
        trainer.load_pretrained(cfg.pretrained_model)
        if cfg.freeze_decom_epochs > 0:
            print("decomposition network will be frozen for the first "
                  f"{cfg.freeze_decom_epochs} epochs")
    elif trainer.freeze_decom_epochs > 0:
        # Reference semantics (main.py:196-212): the freeze applies only to
        # loaded weights.
        print("freeze_decom_epochs ignored: no pretrained model loaded "
              "(reference main.py:196-212 semantics)")
        trainer.freeze_decom_epochs = 0
    return trainer


def run_test(model: torch.nn.Module, cfg: Config, mesh=None) -> dict:
    """Test every cube of ``cfg.test_data``; returns each file's seconds."""
    from sshslie_torch.data.datasets import store_from_config
    from sshslie_torch.evaluate import test_model

    # The reference's loose "*.*" glob for .mat datasets; a non-default
    # data_pattern takes precedence.
    default_pat = cfg.data_pattern in ("", "*.mat")
    test_store = store_from_config(cfg, cfg.test_data, pattern="*.*" if default_pat else None)
    print("Found test files:", test_store.files)
    seconds: dict = {}
    test_model(model, cfg, cfg.test_model_dir, test_store, cfg.test_result_dir, timings=seconds,
               mesh=mesh)
    return seconds


def run_eval_metrics(cfg: Config, device: torch.device, mlflow: MLflowShim):
    """Average PSNR/SSIM/SAM of the saved test outputs against ``label_dir``,
    logged as ``PSNR_dB``, ``SSIM`` and ``SAM``."""
    from sshslie_torch.metrics import calc_metrics

    scores = calc_metrics(
        im_dir=os.path.normpath(cfg.test_result_dir + "/*.mat"),
        label_dir=os.path.normpath(cfg.label_dir),
        data_min=None,
        data_max=cfg.global_max,
        mat_key_prediction=cfg.mat_key_prediction,
        mat_key_gt=cfg.mat_key,
        device=device,
    )
    print(f"\n===> Avg.PSNR : {scores[0]:.4f}")
    print(f"===> Avg.SSIM : {scores[1]:.4f}")
    print(f"===> Avg.SAM  : {scores[2]:.4f}")
    mlflow.log_metric("PSNR_dB", scores[0])
    mlflow.log_metric("SSIM", scores[1])
    mlflow.log_metric("SAM", scores[2])
    return scores


def main(cfg: Config):
    """Run ``cfg.phase``. Returns a dict: ``"trainer"`` (the fitted Trainer:
    ``all_epoch_losses``, ``eval_metrics``, ``model``) when the phase trains,
    and ``"scores"`` (psnr, ssim, sam) and ``"seconds"`` ({file: seconds})
    when it tests (on rank 0 under a mesh); None when there are no training
    cubes to take the channel count from. ``serve`` returns {} once the
    server stops."""
    check_ported(cfg)
    mesh, joined = None, False
    if cfg.mesh_shape:
        from sshslie_torch.parallel import distributed
        from sshslie_torch.parallel.mesh import make_mesh, parse_mesh_shape

        joined = not distributed.active() and distributed.initialize_distributed(
            device=cfg.device)
    try:
        device = resolve_device(cfg.device)
        if cfg.mesh_shape:
            # The config's axis names, as JAX's runner passes them.
            two_d = len(parse_mesh_shape(cfg.mesh_shape)) == 2
            mesh = make_mesh(cfg.mesh_shape, axis_names=(
                (cfg.data_axis, cfg.space_axis or "space") if two_d else (cfg.data_axis,)))
            names = distributed.broadcast_object(
                {k: getattr(cfg, k) for k in sorted(_DERIVED_FIELDS)}, device)
            for k, v in names.items():
                setattr(cfg, k, v)
        return _run(cfg, device, mesh)
    finally:
        if joined:
            distributed.leave()


def _run(cfg: Config, device: torch.device, mesh):
    writer = mesh is None or mesh.rank == 0
    suffix = "" if writer else f"_rank{mesh.rank}"
    log_filepath = os.path.join("logs", "console_output_" + cfg.full_model_name + suffix + ".log")
    original_stdout = sys.stdout
    logger = Logger(log_filepath)
    sys.stdout = logger
    try:
        print(f"Console output is being logged to: {log_filepath}")
        print("------ PARAMETERS ------")
        for key, value in cfg.to_dict().items():
            print(f"{key} : {value}")
        print("------------------------")

        random.seed(cfg.seed_value)
        np.random.seed(cfg.seed_value)
        torch.manual_seed(cfg.seed_value)
        set_matmul_precision(cfg)
        print(f"Using device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
        print(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
              f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
        if mesh is not None:
            print("Mesh:", mesh)

        channels = cfg.channels
        if channels is None:
            from sshslie_torch.utils.io_hsi import load_hsi

            train_files = sorted(glob(os.path.join(cfg.train_data, cfg.data_pattern or "*.mat")))
            if not train_files:
                print("No training files found.")
                return None
            channels = load_hsi(train_files[0], mat_key=cfg.mat_key).shape[-1]
            cfg.channels = channels

        mlflow = MLflowShim(enabled=cfg.use_mlflow and writer)
        trainer = (_build_trainer(cfg, channels, device, mlflow, mesh, writer)
                   if cfg.phase in _TRAINING else None)
        mlflow.set_experiment(cfg.full_model_name)
        result: dict = {}
        with mlflow.start_run():
            run_params = {"phase": cfg.phase, "data_min": cfg.global_min,
                          "data_max": cfg.global_max, "seed": cfg.seed_value,
                          "patch_size": cfg.patch_size, "model_name": cfg.full_model_name}
            for key in ("c_loss_reconstruction", "c_loss_r_fidelity", "c_loss_i_smooth_low",
                        "c_loss_i_smooth_delta", "c_loss_fourier", "c_loss_spectral_cons",
                        "alpha_i_smooth_low", "alpha_i_smooth_delta"):
                run_params[key] = getattr(cfg, key)
            # One call: the file tracker rewrites params.json a call.
            mlflow.log_params(run_params)
            if cfg.config_path:
                mlflow.log_artifact(cfg.config_path)
            _log_source_artifacts(mlflow)
            if trainer is not None:
                mlflow.log_param("data_train", cfg.train_data)
            if cfg.phase in ("test", "train_and_test"):
                mlflow.log_param("data_test", cfg.test_data)
            if trainer is not None:
                run_train(trainer, cfg)
                result["trainer"] = trainer
                # cfg.test_model_dir is this run's checkpoint directory.
                model = trainer.model
            elif cfg.phase == "test":
                from sshslie_torch.models.enhance import build_model

                model = build_model(cfg, channels, device)
            if cfg.phase in ("test", "train_and_test"):
                result["seconds"] = run_test(model, cfg, mesh)
                if writer:
                    result["scores"] = run_eval_metrics(cfg, device, mlflow)
            elif cfg.phase == "serve":
                from sshslie_torch.serve import serve_from_config

                serve_from_config(cfg)
            mlflow.log_artifact(log_filepath, artifact_path="run_logs")
        return result
    except Exception as e:
        print(f"\n--- An error occurred: {e} ---")
        traceback.print_exc(file=sys.stdout)
        raise
    finally:
        if sys.stdout is logger:
            sys.stdout = original_stdout
            logger.close()
        print(f"Final console output log is available at: {log_filepath}")


def cli(argv=None) -> None:
    main(parse_args(argv))
    print("Job finished...")
