"""Whole-cube inference and the test phase, as ``sshslie_tpu/evaluate.py``.

* :func:`pad_forward_crop_batch` edge-pads H and W to a multiple
  (``F.pad(mode="replicate")`` for the JAX ``jnp.pad(mode="edge")``), runs the
  forward and crops the pad back out.
* :class:`Inferencer` runs the model under ``torch.inference_mode`` on
  stacks of host (H, W, C) cubes; the upload is part of the call, as in the
  JAX one. ``inf(weights, cube)`` (JAX ``Inferencer(params, cube)``) runs
  one cube with explicit weights, a state dict on the device, through
  ``torch.func.functional_call``: the serving path's hot reload swaps them
  without touching the module. :func:`pad_forward_crop` is the one-cube form
  of :func:`pad_forward_crop_batch`.
* :func:`test_model` loads ``model_epoch_latest.pth``, runs every test cube
  through the model with per-cube timing (host clock, ending in
  ``torch.cuda.synchronize()`` on the card), and saves the denormalised S,
  S·(max−min)+min in float32, plus the artifacts the config asks for.
* :func:`evaluate_model` is the mid-training eval: every eval cube through
  the model of the trainer (or of a snapshot view with ``.model`` and
  ``.cfg``), saved to ``eval_result_dir/epoch_N/``, scored against
  ``label_dir`` in memory (``eval_metric_source: memory``) or from the saved
  files (``disk``, :func:`calc_metrics` once the saves have landed), the
  average PSNR/SSIM/SAM returned.
* :class:`_OverlappedSaver` saves the outputs on a worker thread, at most
  ``depth`` cubes behind the forward. The worker's device-to-host copies run
  on its own stream after an event recorded on the producing stream, never
  on a bare ``.cpu()`` of another stream's tensor. A trainer may own one
  across epochs (``trainer.eval_saver``), drained before disk metrics, at
  the end of ``fit`` and so before the test phase reads anything.

The sharded inferencers are not ported yet (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import contextlib
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


def pad_forward_crop(fn: Callable, cube: torch.Tensor, mh: int, mw: int):
    """One (H, W, C) cube through :func:`pad_forward_crop_batch`; outputs
    without the batch dim."""
    R, I, Id, S = pad_forward_crop_batch(fn, cube[None], mh, mw)
    return R[0], I[0], Id[0], S[0]


class Inferencer:
    """(R_low, I_low, I_delta, S) forward over host (H, W, C) cubes, with the
    model's own weights or explicit ones (a state dict on ``device``, the
    model's device unless given)."""

    def __init__(self, model: torch.nn.Module, pad_multiple: int = 1,
                 device: Optional[torch.device] = None):
        self.model = model
        self.pad_multiple = max(int(pad_multiple), 1)
        self.device = device or next(model.parameters()).device

    def _fn(self, weights: Optional[Dict[str, torch.Tensor]]) -> Callable:
        if weights is None:
            return self.model
        return lambda x: torch.func.functional_call(self.model, weights, (x,))

    def batched(self, stack, weights: Optional[Dict[str, torch.Tensor]] = None):
        """(N, H, W, C) stack of same-shape cubes in one forward."""
        m = self.pad_multiple
        with torch.inference_mode():
            x = torch.as_tensor(stack, dtype=torch.float32).to(self.device)
            return pad_forward_crop_batch(self._fn(weights), x, m, m)

    def __call__(self, weights: Optional[Dict[str, torch.Tensor]], cube):
        """One (H, W, C) cube (host array or tensor) with ``weights`` (None:
        the model's own)."""
        m = self.pad_multiple
        with torch.inference_mode():
            x = torch.as_tensor(cube, dtype=torch.float32).to(self.device)
            return pad_forward_crop(self._fn(weights), x, m, m)


def _inference_stream(infer: Inferencer, store: CubeStore, eval_batch: int,
                      timed: bool = False):
    """Yield ``(idx, R, I, I_delta, S, seconds)`` per cube, ``eval_batch``
    same-shape cubes to a forward. With ``timed``, ``seconds`` is the cube's
    share of its chunk's wall time up to the end of the current stream's work
    (else 0.0, and nothing waits for the card)."""
    groups: "OrderedDict[tuple, list]" = OrderedDict()
    for idx, shape in enumerate(store.shapes):
        groups.setdefault(tuple(shape), []).append(idx)
    batch = max(int(eval_batch), 1)
    sync = timed and infer.device.type == "cuda"
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
                torch.cuda.current_stream(infer.device).synchronize()
            per_cube = (time.perf_counter() - start) / len(chunk) if timed else 0.0
            for j, i in enumerate(chunk):
                yield i, R[j], I[j], Id[j], S[j], per_cube


def _denormalize(cfg: Config, S: np.ndarray) -> np.ndarray:
    if cfg.global_min is not None and cfg.global_max is not None:
        return S * (cfg.global_max - cfg.global_min) + cfg.global_min
    return S


def _ready_event(t: torch.Tensor) -> Optional["torch.cuda.Event"]:
    """An event recorded on the current stream after ``t``'s producer, for a
    consumer on another thread or stream (None on the CPU)."""
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _save_outputs(cfg: Config, out_dir: str, filename: str, S, R, I, I_delta,
                  ready: Optional["torch.cuda.Event"] = None) -> None:
    """Denormalise and save S, and the artifacts the config asks for
    (reference model.py:371-388). Each tensor leaves the device only if saved.
    With ``ready`` (the producer's event), the copies run on a stream of their
    own after it, so they overlap the producer's next work instead of queueing
    behind it; copies to pageable memory end before the tensors are released."""
    artifacts = [(suffix, t) for flag, suffix, t in ((cfg.save_reflectance, "_R_low", R),
                                                     (cfg.save_illumination, "_I_low", I),
                                                     (cfg.save_i_delta, "_I_delta", I_delta))
                 if flag]
    with torch.cuda.stream(torch.cuda.Stream(S.device)) if ready is not None \
            else contextlib.nullcontext():
        if ready is not None:
            torch.cuda.current_stream(S.device).wait_event(ready)
        S = S.cpu().numpy()
        artifacts = [(suffix, t.cpu().numpy()) for suffix, t in artifacts]
    save_hsi(os.path.join(out_dir, filename), _denormalize(cfg, S), key=cfg.mat_key_prediction)
    stem = os.path.splitext(filename)[0]
    for suffix, t in artifacts:
        save_hsi(os.path.join(out_dir, "artifacts", stem + suffix + ".mat"), t)


class _OverlappedSaver:
    """Bounded single-worker save pipeline (JAX ``_OverlappedSaver``).

    * back-pressure: at most ``depth`` saves are pending, so queued saves pin
      at most ``depth`` cubes' outputs on the device;
    * fail-fast: :meth:`submit` first waits for the oldest save beyond the
      depth, so a failed write surfaces ``depth`` cubes later, not after the
      whole dataset.
    """

    def __init__(self, depth: int = 2):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="save")
        self._pending: "deque" = deque()
        self.depth = max(int(depth), 1)

    def submit(self, fn, *args) -> None:
        while len(self._pending) >= self.depth:
            self._pending.popleft().result()
        self._pending.append(self._pool.submit(fn, *args))

    def drain(self) -> None:
        """Block until every pending save has landed (raises the first failure)."""
        while self._pending:
            self._pending.popleft().result()

    def close(self) -> None:
        """Drain and shut the worker down."""
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "_OverlappedSaver":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.drain()
            else:
                # The forward raised: report save errors without masking it.
                while self._pending:
                    e = self._pending.popleft().exception()
                    if e is not None:
                        print(f"(save error during teardown: {e})")
        finally:
            self._pool.shutdown(wait=True)


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
    """Mid-training eval (reference model.py:343-404) with ``trainer.model``
    and ``trainer.cfg``: returns ``{psnr, ssim, sam}`` averaged over the cubes
    with ground truth, or None when there is no eval cube or no ground truth.
    Saves go to ``trainer.eval_saver`` when the trainer owns one (left
    running), else to a saver drained before returning."""
    if len(eval_store) == 0:
        print(f"--- No files found for evaluation. Skipping evaluation for epoch {epoch} ---")
        return None
    print(f"--- Running evaluation for epoch {epoch} ---")
    cfg = trainer.cfg
    epoch_dir = os.path.join(eval_result_dir, f"epoch_{epoch}")
    os.makedirs(epoch_dir, exist_ok=True)
    infer = Inferencer(trainer.model, cfg.eval_pad_multiple)
    from_memory = cfg.eval_metric_source != "disk"
    persistent = getattr(trainer, "eval_saver", None)
    saver = persistent if persistent is not None else _OverlappedSaver()
    per_file: Dict[str, tuple] = {}
    with contextlib.nullcontext() if persistent is not None else saver:
        for idx, R, I, Id, S, _sec in _inference_stream(infer, eval_store, cfg.eval_batch):
            filename = os.path.basename(eval_store.files[idx])
            if from_memory and label_dir:
                sc = _score_in_memory(filename, S, cfg, label_dir)
                if sc is not None:
                    per_file[filename] = sc
            saver.submit(_save_outputs, cfg, epoch_dir, filename, S, R, I, Id, _ready_event(S))
    scores = None
    if label_dir and from_memory:
        if per_file:
            scores = _average_scores(per_file)
        else:
            print(f"--- Eval metrics skipped for epoch {epoch}: "
                  "Number of files must be greater than 0 ---")
    elif label_dir:
        # The disk source reads this epoch's files: they must have landed.
        saver.drain()
        try:
            avg = metrics_mod.calc_metrics(
                im_dir=os.path.normpath(os.path.join(epoch_dir, "*.mat")),
                label_dir=os.path.normpath(label_dir), data_min=None, data_max=cfg.global_max,
                mat_key_prediction=cfg.mat_key_prediction, mat_key_gt=cfg.mat_key,
                device=infer.device)
            scores = {"psnr": avg[0], "ssim": avg[1], "sam": avg[2]}
        except ValueError as e:
            print(f"--- Eval metrics skipped for epoch {epoch}: {e} ---")
    print(f"--- Evaluation for epoch {epoch} finished. Results saved to {epoch_dir} ---")
    return scores


def test_model(model: torch.nn.Module, cfg: Config, model_dir: str, test_store: CubeStore,
               save_dir: str, timings: Optional[Dict[str, float]] = None) -> float:
    """Test phase (reference model.py:406-443): load the latest checkpoint,
    run every cube timed, save the outputs on the background saver (outside
    the timed window). Returns the mean seconds a cube;
    ``timings``, when given, receives each file's seconds."""
    interop.load_checkpoint(checkpoints.latest_path(model_dir), model)
    os.makedirs(save_dir, exist_ok=True)
    infer = Inferencer(model, cfg.eval_pad_multiple)
    total = 0.0
    with _OverlappedSaver() as saver:
        for idx, R, I, Id, S, run_time in _inference_stream(infer, test_store, cfg.eval_batch,
                                                            timed=True):
            filename = os.path.basename(test_store.files[idx])
            print(f"Processing {filename}")
            total += run_time
            if timings is not None:
                timings[filename] = run_time
            saver.submit(_save_outputs, cfg, save_dir, filename, S, R, I, Id, _ready_event(S))
            print(f"Processed {filename} in {run_time:.4f} seconds.")
    n = len(test_store)
    avg = total / n if n else 0.0
    print(f"Average run time: {avg:.4f} seconds.")
    return avg
