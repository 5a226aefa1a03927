"""Whole-cube inference and the test phase, as ``sshslie_tpu/evaluate.py``.

* :func:`pad_forward_crop_batch` edge-pads H and W to a multiple
  (``F.pad(mode="replicate")`` for the JAX ``jnp.pad(mode="edge")``), runs the
  forward and crops the pad back out.
* :class:`Inferencer` runs the model under ``torch.inference_mode`` on
  stacks of host (H, W, C) cubes; the upload is part of the call, as in the
  JAX one.
* :func:`test_model` loads ``model_epoch_latest.pth``, runs every test cube
  through the model with per-cube timing (host clock, ending in
  ``torch.cuda.synchronize()`` on the card), and saves the denormalised S,
  S·(max−min)+min in float32, plus the artifacts the config asks for.
* :func:`evaluate_model` is the mid-training eval: every eval cube through
  the trainer's model, saved to ``eval_result_dir/epoch_N/``, scored in
  memory against ``label_dir`` (the JAX ``eval_metric_source: memory``
  path), the average PSNR/SSIM/SAM returned.

Outputs are saved as each cube finishes, outside its timed window; the JAX
package's background saver, its asynchronous eval and its sharded
inferencers are not ported yet.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sshslie_torch import checkpoints, interop
from sshslie_torch import metrics as metrics_mod
from sshslie_torch.config import Config
from sshslie_torch.data.datasets import CubeStore
from sshslie_torch.utils.io_hsi import load_hsi, save_hsi


def pad_forward_crop_batch(fn: Callable, stack: torch.Tensor, mh: int, mw: int):
    """Edge-pad an (N, H, W, C) stack to multiples of (mh, mw), run ``fn`` →
    (R, I, I_delta, S), crop the pad. Outputs keep the batch dim."""
    _, h, w, _ = stack.shape
    ph = (mh - h % mh) % mh
    pw = (mw - w % mw) % mw
    x = stack
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    R, I, Id, S = fn(x)
    if ph or pw:
        R, I, Id, S = (t[:, :h, :w, :] for t in (R, I, Id, S))
    return R, I, Id, S


class Inferencer:
    """(R_low, I_low, I_delta, S) forward over host (H, W, C) cubes."""

    def __init__(self, model: torch.nn.Module, pad_multiple: int = 1):
        self.model = model
        self.pad_multiple = max(int(pad_multiple), 1)
        self.device = next(model.parameters()).device

    def batched(self, stack: np.ndarray):
        """(N, H, W, C) stack of same-shape cubes in one forward."""
        m = self.pad_multiple
        with torch.inference_mode():
            x = torch.as_tensor(stack, dtype=torch.float32).to(self.device)
            return pad_forward_crop_batch(self.model, x, m, m)


def _inference_stream(infer: Inferencer, store: CubeStore, eval_batch: int):
    """Yield ``(idx, R, I, I_delta, S, seconds)`` per cube, ``eval_batch``
    same-shape cubes to a forward. ``seconds`` is the cube's share of its
    chunk's synchronised wall time."""
    groups: "OrderedDict[tuple, list]" = OrderedDict()
    for idx, shape in enumerate(store.shapes):
        groups.setdefault(tuple(shape), []).append(idx)
    batch = max(int(eval_batch), 1)
    sync = infer.device.type == "cuda"
    for idxs in groups.values():
        for lo in range(0, len(idxs), batch):
            chunk = idxs[lo: lo + batch]
            stack = np.stack([store[i] for i in chunk])
            if len(chunk) < batch:
                # Remainder chunks are zero-padded to the full batch, as in the JAX package.
                stack = np.concatenate(
                    [stack, np.zeros((batch - len(chunk), *stack.shape[1:]), stack.dtype)])
            start = time.perf_counter()
            R, I, Id, S = infer.batched(stack)
            if sync:
                torch.cuda.synchronize(infer.device)
            per_cube = (time.perf_counter() - start) / len(chunk)
            for j, i in enumerate(chunk):
                yield i, R[j], I[j], Id[j], S[j], per_cube


def _denormalize(cfg: Config, S: np.ndarray) -> np.ndarray:
    if cfg.global_min is not None and cfg.global_max is not None:
        return S * (cfg.global_max - cfg.global_min) + cfg.global_min
    return S


def _save_outputs(cfg: Config, out_dir: str, filename: str, S, R, I, I_delta) -> None:
    """Denormalise and save S, and the artifacts the config asks for
    (reference model.py:371-388). Each tensor leaves the device only if saved."""
    S = _denormalize(cfg, S.cpu().numpy())
    save_hsi(os.path.join(out_dir, filename), S, key=cfg.mat_key_prediction)
    artifact_dir = os.path.join(out_dir, "artifacts")
    stem = os.path.splitext(filename)[0]
    for flag, suffix, t in ((cfg.save_reflectance, "_R_low", R),
                            (cfg.save_illumination, "_I_low", I),
                            (cfg.save_i_delta, "_I_delta", I_delta)):
        if flag:
            save_hsi(os.path.join(artifact_dir, stem + suffix + ".mat"), t.cpu().numpy())


def _score_in_memory(name: str, S: torch.Tensor, cfg: Config, label_dir: str):
    """PSNR/SSIM/SAM of one in-memory S against its ground truth, scored as
    ``calc_metrics`` scores the saved file: the same float32 denormalisation,
    ``data_range = global_max``. Returns None when ``label_dir`` has no GT."""
    label_path = os.path.join(label_dir, name)
    if not os.path.exists(label_path):
        print(f"===> {name} | no ground truth in {label_dir}, skipping")
        return None
    gt = torch.as_tensor(load_hsi(label_path, mat_key=cfg.mat_key), device=S.device)
    pred = _denormalize(cfg, S.float())
    scores = (float(metrics_mod.psnr(pred, gt, cfg.global_max)),
              float(metrics_mod.ssim(pred, gt, cfg.global_max)),
              float(metrics_mod.sam(pred, gt)))
    print(f"\n===> {name} | PSNR : {scores[0]:.4f}")
    print(f"===> {name} | SSIM : {scores[1]:.4f}")
    print(f"===> {name} | SAM  : {scores[2]:.4f}")
    return scores


def _average_scores(per_file: Dict[str, tuple]) -> Dict[str, float]:
    """Per-file scores averaged in sorted-filename order, in float64, as
    ``calc_metrics`` averages its sorted walk."""
    total = np.zeros(3, dtype=np.float64)
    for name in sorted(per_file):
        total += per_file[name]
    avg = total / len(per_file)
    return {"psnr": float(avg[0]), "ssim": float(avg[1]), "sam": float(avg[2])}


def evaluate_model(trainer, eval_store: CubeStore, eval_result_dir: str, epoch: int,
                   label_dir: Optional[str]) -> Optional[Dict[str, float]]:
    """Mid-training eval (reference model.py:343-404), synchronous: returns
    ``{psnr, ssim, sam}`` averaged over the cubes with ground truth, or None
    when there is no eval cube or no ground truth."""
    if len(eval_store) == 0:
        print(f"--- No files found for evaluation. Skipping evaluation for epoch {epoch} ---")
        return None
    print(f"--- Running evaluation for epoch {epoch} ---")
    cfg = trainer.cfg
    epoch_dir = os.path.join(eval_result_dir, f"epoch_{epoch}")
    os.makedirs(epoch_dir, exist_ok=True)
    infer = Inferencer(trainer.model, cfg.eval_pad_multiple)
    per_file: Dict[str, tuple] = {}
    for idx, R, I, Id, S, _sec in _inference_stream(infer, eval_store, cfg.eval_batch):
        filename = os.path.basename(eval_store.files[idx])
        if label_dir:
            sc = _score_in_memory(filename, S, cfg, label_dir)
            if sc is not None:
                per_file[filename] = sc
        _save_outputs(cfg, epoch_dir, filename, S, R, I, Id)
    scores = None
    if label_dir:
        if per_file:
            scores = _average_scores(per_file)
        else:
            print(f"--- Eval metrics skipped for epoch {epoch}: "
                  "Number of files must be greater than 0 ---")
    print(f"--- Evaluation for epoch {epoch} finished. Results saved to {epoch_dir} ---")
    return scores


def test_model(model: torch.nn.Module, cfg: Config, model_dir: str, test_store: CubeStore,
               save_dir: str, timings: Optional[Dict[str, float]] = None) -> float:
    """Test phase (reference model.py:406-443): load the latest checkpoint,
    run every cube timed, save the outputs. Returns the mean seconds a cube;
    ``timings``, when given, receives each file's seconds."""
    interop.load_checkpoint(checkpoints.latest_path(model_dir), model)
    os.makedirs(save_dir, exist_ok=True)
    infer = Inferencer(model, cfg.eval_pad_multiple)
    total = 0.0
    for idx, R, I, Id, S, run_time in _inference_stream(infer, test_store, cfg.eval_batch):
        filename = os.path.basename(test_store.files[idx])
        print(f"Processing {filename}")
        total += run_time
        if timings is not None:
            timings[filename] = run_time
        _save_outputs(cfg, save_dir, filename, S, R, I, Id)
        print(f"Processed {filename} in {run_time:.4f} seconds.")
    n = len(test_store)
    avg = total / n if n else 0.0
    print(f"Average run time: {avg:.4f} seconds.")
    return avg
