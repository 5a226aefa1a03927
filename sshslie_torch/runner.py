"""Run entry of the port: ``python -m sshslie_torch --config … --phase
train|test|train_and_test``.

As ``sshslie_tpu/runner.py``: stdout teed to
``logs/console_output_<run>.log``, the parameters printed, Python, numpy and
torch seeded, the channel count taken from the first training cube when the
config leaves it out. ``train`` builds a ``Trainer`` (warm-started from
``pretrained_model`` when given; ``freeze_decom_epochs`` applies only then)
and runs ``run_train``; ``test`` runs ``run_test`` and ``run_eval_metrics``
on ``model_epoch_latest.pth`` of ``test_timestamp``; ``train_and_test`` does
both, testing from the checkpoint the run just wrote. Float32 runs in full
float32 on the card: both TF32 switches are set off and printed.

The ``serve`` phase is not ported yet and raises, as does any config value
the port cannot honour (``config.check_ported``). MLflow logging is not
ported.
"""

from __future__ import annotations

import os
import random
import sys
import traceback
from glob import glob

import numpy as np
import torch

from sshslie_torch.config import Config, check_ported, parse_args
from sshslie_torch.device import resolve_device

_TRAINING = ("train", "train_and_test")


class Logger:
    """Tee stdout to the terminal and a UTF-8 log file (reference logger.py:3-24)."""

    def __init__(self, filepath: str):
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(filepath, "w", encoding="utf-8")

    def write(self, message: str) -> None:
        self.terminal.write(message)
        self.log.write(message)
        self.flush()

    def flush(self) -> None:
        self.terminal.flush()
        self.log.flush()

    def close(self) -> None:
        self.log.close()


def run_train(trainer, cfg: Config) -> None:
    """Fit on ``cfg.train_data`` with the mid-training eval on ``cfg.eval_data``."""
    from sshslie_torch.data.datasets import store_from_config
    from sshslie_torch.evaluate import evaluate_model

    trainer.fit(store_from_config(cfg, cfg.train_data),
                eval_store=store_from_config(cfg, cfg.eval_data),
                evaluator=evaluate_model, eval_result_dir=cfg.eval_result_dir,
                label_dir=cfg.label_dir)


def _build_trainer(cfg: Config, channels: int, device: torch.device):
    from sshslie_torch.train import Trainer

    trainer = Trainer(cfg, channels, device)
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


def run_test(model: torch.nn.Module, cfg: Config) -> dict:
    """Test every cube of ``cfg.test_data``; returns each file's seconds."""
    from sshslie_torch.data.datasets import store_from_config
    from sshslie_torch.evaluate import test_model

    # The reference's loose "*.*" glob for .mat datasets; a non-default
    # data_pattern takes precedence.
    default_pat = cfg.data_pattern in ("", "*.mat")
    test_store = store_from_config(cfg, cfg.test_data, pattern="*.*" if default_pat else None)
    print("Found test files:", test_store.files)
    seconds: dict = {}
    test_model(model, cfg, cfg.test_model_dir, test_store, cfg.test_result_dir, timings=seconds)
    return seconds


def run_eval_metrics(cfg: Config, device: torch.device):
    """Average PSNR/SSIM/SAM of the saved test outputs against ``label_dir``."""
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
    return scores


def main(cfg: Config):
    """Run ``cfg.phase``. Returns a dict: ``"trainer"`` (the fitted Trainer:
    ``all_epoch_losses``, ``eval_metrics``, ``model``) when the phase trains,
    and ``"scores"`` (psnr, ssim, sam) and ``"seconds"`` ({file: seconds})
    when it tests; None when there are no training cubes to take the channel
    count from."""
    if cfg.phase == "serve":
        raise NotImplementedError("phase 'serve' is not ported yet: serving is ROADMAP.md "
                                  "queue 1, item 8")
    check_ported(cfg, training=cfg.phase in _TRAINING)
    device = resolve_device(cfg.device)
    log_filepath = os.path.join("logs", "console_output_" + cfg.full_model_name + ".log")
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
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"Using device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
        print(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
              f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

        channels = cfg.channels
        if channels is None:
            from sshslie_torch.utils.io_hsi import load_hsi

            train_files = sorted(glob(os.path.join(cfg.train_data, cfg.data_pattern or "*.mat")))
            if not train_files:
                print("No training files found.")
                return None
            channels = load_hsi(train_files[0], mat_key=cfg.mat_key).shape[-1]
            cfg.channels = channels

        result: dict = {}
        if cfg.phase in _TRAINING:
            trainer = _build_trainer(cfg, channels, device)
            run_train(trainer, cfg)
            result["trainer"] = trainer
            if cfg.phase == "train":
                return result
            # cfg.test_model_dir is this run's checkpoint directory.
            model = trainer.model
        else:
            from sshslie_torch.models.enhance import build_model

            model = build_model(cfg, channels, device)
        result["seconds"] = run_test(model, cfg)
        result["scores"] = run_eval_metrics(cfg, device)
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
