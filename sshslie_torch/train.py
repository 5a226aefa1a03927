"""Training engine of the port, as ``sshslie_tpu/train.py``.

* :func:`train_step` is one step of JAX ``make_train_step``: the forward with
  the re-decomposition of S, the six-term loss (``_make_loss_fn``), the
  gradients, the freeze mask and the Adam update (``_apply_update``). It
  returns the 7 terms as detached tensors on the device and syncs nothing.
  Every other step is built on it or on its pieces, so their trajectories
  agree by construction, as JAX builds all four from one loss function.
* :func:`accum_train_step` is JAX ``make_accum_train_step``: the batch split
  into K micro-batches, their gradients and terms summed and scaled by 1/K,
  then one update (host pipeline only).
* :func:`fused_train_step` is JAX ``make_fused_train_step``: the batch cropped
  and augmented on the device from the (N, H, W, C) stack of
  :func:`stack_cubes` (cube ``(batch_start + i) % N``, offsets in
  [0, dim - P), one of 8 modes), then :func:`train_step`: no host-to-device
  batch upload a step. :func:`multistep_train_step` runs K of them in one
  host call and returns the chunk's terms summed (JAX
  ``make_multistep_train_step``; a remainder chunk takes only its real
  steps), so its trajectory is that of K single fused steps.
* The fused pipeline's random stream: torch cannot replay JAX's threefry, so
  each epoch's whole table of (x, y, mode) draws comes from numpy,
  ``default_rng(SeedSequence([seed_value, epoch]))`` (:func:`fused_draws`),
  and is uploaded once an epoch; steps index it on the device. The stream is
  the same on every device, and resume replays it. A documented deviation
  beside PARITY #19 (the three JAX pipelines draw from three streams too);
  ``fit`` prints it in its "Patch sampler:" line.
* Adam is ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` without weight
  decay, with each epoch's StepLR value written into its param groups:
  optax ``scale_by_adam`` followed by ``p - lr * u`` is the same update.
* Freeze (``freeze_decom_epochs`` with pretrained weights): the
  DecompositionNet's gradients are set to zero, not dropped, so Adam's
  moments and step counts advance as the JAX package's do; Adam is recreated
  at the unfreeze epoch (reference model.py:273-288).
* :class:`Trainer` is ``Trainer.fit``: pipeline selection as JAX (fused on
  same-shape cubes for ``fused_pipeline: auto|on``, else the host
  ``PatchSampler`` stream, numpy PCG64, one upload a step), per-epoch
  averages of the 7 terms with one device-to-host sync an epoch, eval and
  checkpoint on the ``eval_every_epoch`` cadence, the final-tail checkpoint
  (PARITY #22), resume from ``model_epoch_latest.pth`` with the optimizer
  state and the sampler fast-forwarded.

Not ported (ROADMAP.md queue 1): SIGTERM checkpointing, async eval,
``checkpoint_best``, the background writer, plots and MLflow (item 6);
meshes (item 7); ``fused_window`` (item 9); a CUDA graph of a multistep
chunk (item 11).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from sshslie_torch import checkpoints, interop
from sshslie_torch.config import SPEED_ONLY_KEYS, Config, check_ported
from sshslie_torch.data.datasets import CubeStore, PatchSampler
from sshslie_torch.device import resolve_device
from sshslie_torch.models.enhance import LowLightEnhanceNet, build_model
from sshslie_torch.ops.losses import total_loss
from sshslie_torch.utils.augment import NUM_MODES, augment_batch
from sshslie_torch.utils.schedule import step_lr

LOSS_KEYS = (
    "total_loss",
    "L_reconstruction",
    "L_R_fidelity",
    "L_I_smooth_low",
    "L_I_smooth_delta",
    "L_fourier",
    "L_spectral_cons",
)


def loss_coeffs(cfg: Config) -> Dict[str, float]:
    return {key: float(getattr(cfg, key)) for key in (
        "c_loss_reconstruction", "c_loss_r_fidelity", "c_loss_i_smooth_low",
        "c_loss_i_smooth_delta", "c_loss_fourier", "c_loss_spectral_cons",
        "alpha_i_smooth_low", "alpha_i_smooth_delta")}


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """torch.optim.Adam with the reference's defaults (JAX ``make_optimizer``)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _backward(model: LowLightEnhanceNet, batch: torch.Tensor,
              coeffs: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """The shared objective (JAX ``_make_loss_fn``): forward, loss, backward,
    gradients added into ``p.grad`` → the detached terms."""
    R_low, I_low, I_delta, S, R_enh = model.forward_with_redecomposition(batch)
    total, terms = total_loss(batch, R_low, I_low, I_delta, S, R_enh, coeffs)
    total.backward()
    return {k: terms[k].detach() for k in LOSS_KEYS}


def _update(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
            freeze_decom: bool) -> None:
    """Freeze mask and Adam (JAX ``_apply_update``)."""
    if freeze_decom:
        for p in model.decomposition_net.parameters():
            p.grad.zero_()
    optimizer.step()


def _add_terms(sums: Optional[Dict[str, torch.Tensor]],
               terms: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return terms if sums is None else {k: sums[k] + terms[k] for k in LOSS_KEYS}


def train_step(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
               batch: torch.Tensor, coeffs: Dict[str, float],
               freeze_decom: bool = False) -> Dict[str, torch.Tensor]:
    """One update on an NHWC batch → {LOSS_KEYS name: detached scalar tensor}."""
    optimizer.zero_grad(set_to_none=True)
    terms = _backward(model, batch, coeffs)
    _update(model, optimizer, freeze_decom)
    return terms


def accum_train_step(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
                     batch: torch.Tensor, coeffs: Dict[str, float], accum_steps: int,
                     freeze_decom: bool = False) -> Dict[str, torch.Tensor]:
    """One update from ``accum_steps`` consecutive micro-batches of ``batch``:
    the gradients and terms summed in micro-batch order and scaled by
    1/accum_steps (every term is a mean over the batch, so this is the
    full-batch update up to rounding)."""
    b = batch.shape[0]
    if b % accum_steps != 0:
        raise ValueError(f"batch {b} not divisible by grad_accum_steps {accum_steps}")
    optimizer.zero_grad(set_to_none=True)
    sums = None
    for micro in batch.chunk(accum_steps):
        sums = _add_terms(sums, _backward(model, micro, coeffs))
    inv = 1.0 / accum_steps
    for p in model.parameters():
        p.grad.mul_(inv)
    _update(model, optimizer, freeze_decom)
    return {k: sums[k] * inv for k in LOSS_KEYS}


def stack_cubes(store: CubeStore, device) -> Optional[torch.Tensor]:
    """The (N, H, W, C) float32 stack of the store's cubes on ``device``, or
    None when their shapes differ (JAX ``stack_cubes``)."""
    if len({c.shape for c in store.cubes}) != 1:
        return None
    return torch.from_numpy(np.stack(store.cubes)).to(device)


def fused_draws(seed: int, epoch: int, num_batches: int, batch_size: int,
                cube_hw: tuple, patch_size: int) -> np.ndarray:
    """One epoch's (num_batches, batch_size, 3) int64 table of (x, y, mode):
    crop offsets in [0, dim - patch_size) (exclusive, as the reference) and
    modes in [0, 8), from ``default_rng(SeedSequence([seed, epoch]))``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    size = (num_batches, batch_size)
    h, w = cube_hw
    xs = rng.integers(0, max(h - patch_size, 1), size=size)
    ys = rng.integers(0, max(w - patch_size, 1), size=size)
    modes = rng.integers(0, NUM_MODES, size=size)
    return np.stack([xs, ys, modes], axis=-1)


def sample_fused_batch(cubes: torch.Tensor, draws: torch.Tensor, batch_start: int,
                       patch_size: int) -> torch.Tensor:
    """The (B, P, P, C) batch of one fused step, on the cubes' device: sample i
    crops cube ``(batch_start + i) % N`` at ``draws[i, :2]`` and takes mode
    ``draws[i, 2]`` (JAX ``_sample_fused_batch``)."""
    dev = cubes.device
    idx = (batch_start + torch.arange(draws.shape[0], device=dev)) % cubes.shape[0]
    offs = torch.arange(patch_size, device=dev)
    rows = draws[:, 0, None] + offs
    cols = draws[:, 1, None] + offs
    patches = cubes[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
    return augment_batch(patches, draws[:, 2])


def fused_train_step(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
                     cubes: torch.Tensor, draws: torch.Tensor, batch_start: int,
                     patch_size: int, coeffs: Dict[str, float],
                     freeze_decom: bool = False) -> Dict[str, torch.Tensor]:
    """One fused step: the batch sampled on the device, then :func:`train_step`."""
    batch = sample_fused_batch(cubes, draws, batch_start, patch_size)
    return train_step(model, optimizer, batch, coeffs, freeze_decom)


def multistep_train_step(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
                         cubes: torch.Tensor, epoch_draws: torch.Tensor,
                         batch_ids: Iterable[int], batch_size: int, patch_size: int,
                         coeffs: Dict[str, float],
                         freeze_decom: bool = False) -> Dict[str, torch.Tensor]:
    """The fused steps ``batch_ids`` of an epoch in one host call, each
    exactly as :func:`fused_train_step` → their terms summed in step order."""
    sums = None
    for batch_id in batch_ids:
        sums = _add_terms(sums, fused_train_step(
            model, optimizer, cubes, epoch_draws[batch_id], batch_id * batch_size,
            patch_size, coeffs, freeze_decom))
    return sums


class Trainer:
    """Epoch orchestration (reference train_model, model.py:236-341).

    The initial weights are drawn from a ``torch.Generator`` seeded with
    ``cfg.seed_value``, or taken from ``state_dict`` (the tests pass JAX
    ``init_params`` through ``interop.jax_params_to_state_dict``).
    """

    def __init__(self, cfg: Config, channels: int, device=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        check_ported(cfg, training=True)
        self.cfg = cfg
        self.channels = channels
        self.device = resolve_device(cfg.device if device is None else device)
        self.model = build_model(cfg, channels, self.device,
                                 generator=torch.Generator().manual_seed(cfg.seed_value), train=True)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.coeffs = loss_coeffs(cfg)
        self.optimizer = make_optimizer(self.model, cfg.start_lr)
        self.freeze_decom_epochs = int(cfg.freeze_decom_epochs or 0)
        self.all_epoch_losses: Dict[str, list] = {k: [] for k in LOSS_KEYS}
        self.eval_metrics: Dict[int, Dict[str, float]] = {}
        self.pipeline = ""           # 'fused' or 'host', set by fit
        # Per trained epoch: (seconds the host spent sampling and uploading,
        # or drawing and uploading the fused draws, wall seconds of the
        # epoch's steps up to its sync).
        self.epoch_seconds: list = []

    def load_pretrained(self, path: str) -> None:
        """Warm start from a reference ``.pth`` (full checkpoint or bare state dict)."""
        epoch = interop.load_checkpoint(path, self.model)
        print(f"Loaded model from epoch {epoch if epoch is not None else 'unknown'}")
        print("Pretrained model loaded successfully!")

    def _lr_for_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        return step_lr(epoch, cfg.start_lr, cfg.lr_update_factor, cfg.lr_update_period,
                       max(self.freeze_decom_epochs, 0))

    def _upload(self, host_batch) -> torch.Tensor:
        batch = torch.from_numpy(host_batch)
        if self.device.type == "cuda":
            # Pinned and asynchronous: the next batch is cropped on the host
            # while the card runs this step.
            return batch.pin_memory().to(self.device, non_blocking=True)
        return batch

    def _save_epoch_ckpt(self, ckpt_dir: str, epoch: int, label: str = "Checkpoint") -> None:
        saved = interop.save_checkpoint(checkpoints.epoch_path(ckpt_dir, epoch),
                                        self.model.state_dict(), epoch, self.optimizer)
        latest = checkpoints.copy_checkpoint(saved, checkpoints.latest_path(ckpt_dir))
        print(f"{label} saved at {latest}")
        if self.cfg.checkpoint_keep > 0:
            checkpoints.prune_checkpoints(ckpt_dir, self.cfg.checkpoint_keep)

    def fit(self, train_store: CubeStore, eval_store: Optional[CubeStore] = None,
            evaluator: Optional[Callable] = None, ckpt_dir: Optional[str] = None,
            eval_result_dir: Optional[str] = None, label_dir: Optional[str] = None) -> None:
        cfg = self.cfg
        shapes = train_store.shapes
        if shapes:
            min_h = min(s[0] for s in shapes)
            min_w = min(s[1] for s in shapes)
            if cfg.patch_size > min_h or cfg.patch_size > min_w:
                raise ValueError(f"patch_size {cfg.patch_size} exceeds the smallest training "
                                 f"cube ({min_h}x{min_w}); reduce patch_size")
            for i, s in enumerate(shapes):
                if s[2] != self.channels:
                    raise ValueError(
                        f"model was built for {self.channels} channels but "
                        f"{train_store.files[i]} has {s[2]} (check the 'channels' config key "
                        "and dataset uniformity)")
        if len(train_store) // cfg.batch_size == 0:
            # PARITY #23: zero steps an epoch would checkpoint untrained weights.
            raise ValueError(
                f"batch_size {cfg.batch_size} exceeds the {len(train_store)} training cube(s): "
                "zero steps per epoch (the epoch drops the remainder batch, PARITY #7) — "
                "reduce batch_size")
        ckpt_dir = ckpt_dir or os.path.join(cfg.model_ckpt_dir, "Decomposition_" + cfg.timestamp)
        os.makedirs(ckpt_dir, exist_ok=True)

        start_epoch = 0
        if cfg.resume:
            latest = checkpoints.latest_path(ckpt_dir)
            if os.path.exists(latest):
                start_epoch = interop.load_checkpoint(latest, self.model, self.optimizer) or 0
                print(f"Resuming training from epoch {start_epoch}")
            else:
                print(f"resume requested but no checkpoint at {latest}; starting fresh")
        if eval_result_dir:
            os.makedirs(eval_result_dir, exist_ok=True)

        # Pipeline selection (JAX Trainer.fit): the fused pipeline on a stack
        # of same-shape cubes for 'auto'/'on' without accumulation, else the
        # host sampler.
        accum = max(int(cfg.grad_accum_steps), 1)
        if accum > 1 and cfg.fused_pipeline == "on":
            raise ValueError("grad_accum_steps > 1 requires the host pipeline; set "
                             "fused_pipeline to 'auto' or 'off'")
        cubes = sampler = None
        if accum == 1 and cfg.fused_pipeline in ("auto", "on"):
            cubes = stack_cubes(train_store, self.device)
            if cubes is None and cfg.fused_pipeline == "on":
                raise ValueError("fused_pipeline='on' requires all training cubes to share "
                                 "one shape; use 'auto' or 'off' for mixed-size datasets")
        k_steps = max(int(cfg.steps_per_dispatch), 1)
        self.pipeline = "host" if cubes is None else "fused"
        if cubes is not None:
            print(f"Patch sampler: fused on-device pipeline (fused_pipeline="
                  f"{cfg.fused_pipeline!r}, steps_per_dispatch={k_steps}, rng=numpy PCG64 "
                  "table of each epoch's draws from SeedSequence([seed_value, epoch]); "
                  "not the JAX threefry stream)")
        else:
            sampler = PatchSampler(train_store, cfg.batch_size, cfg.patch_size,
                                   seed=cfg.seed_value)
            if start_epoch > 0:
                sampler.skip_epochs(start_epoch)
            print(f"Patch sampler: PatchSampler (sampler={cfg.sampler!r}, "
                  f"fused_pipeline={cfg.fused_pipeline!r} -> host pipeline, "
                  f"grad_accum_steps={accum}, rng=numpy PCG64)")
        print("Ignored (speed only): "
              + ", ".join(f"{k}={getattr(cfg, k)!r}" for k in SPEED_ONLY_KEYS))
        num_batches = len(train_store) // cfg.batch_size

        for epoch in range(start_epoch, cfg.epoch):
            freeze = 0 < self.freeze_decom_epochs and epoch < self.freeze_decom_epochs
            if self.freeze_decom_epochs > 0:
                if freeze:
                    print(f"Epoch {epoch+1}: DecompositionNet frozen")
                elif epoch == self.freeze_decom_epochs:
                    # The reference recreates Adam at unfreeze: moments and counts reset.
                    self.optimizer = make_optimizer(self.model, cfg.start_lr)
                    print(f"Epoch {epoch+1}: DecompositionNet unfrozen")
            lr = self._lr_for_epoch(epoch)
            set_lr(self.optimizer, lr)
            sums: Optional[Dict[str, torch.Tensor]] = None
            count = 0
            host_s = 0.0
            start = time.perf_counter()
            if cubes is not None:
                # The epoch's draws, uploaded once; steps index them on the device.
                t = time.perf_counter()
                draws = torch.from_numpy(fused_draws(
                    cfg.seed_value, epoch, num_batches, cfg.batch_size, tuple(cubes.shape[1:3]),
                    cfg.patch_size)).to(self.device)
                host_s += time.perf_counter() - t
                for chunk_start in range(0, num_batches, k_steps):
                    ids = range(chunk_start, min(chunk_start + k_steps, num_batches))
                    terms = multistep_train_step(self.model, self.optimizer, cubes, draws, ids,
                                                 cfg.batch_size, cfg.patch_size, self.coeffs,
                                                 freeze)
                    sums = _add_terms(sums, terms)
                    count += len(ids)
                    # log_every_step's cadence: print when the chunk crossed an N boundary.
                    if cfg.log_every_step and ((ids[-1] + 1) // cfg.log_every_step
                                               > ids[0] // cfg.log_every_step):
                        print(f"Epoch [{epoch+1}/{cfg.epoch}] Batch [{ids[-1]+1}/{num_batches}] "
                              f"Loss: {float(terms['total_loss']) / len(ids):.6f}")
            else:
                for batch_id in range(num_batches):
                    t = time.perf_counter()
                    batch = self._upload(sampler.sample_batch(batch_id))
                    host_s += time.perf_counter() - t
                    if accum > 1:
                        terms = accum_train_step(self.model, self.optimizer, batch, self.coeffs,
                                                 accum, freeze)
                    else:
                        terms = train_step(self.model, self.optimizer, batch, self.coeffs, freeze)
                    sums = _add_terms(sums, terms)
                    count += 1
                    if cfg.log_every_step and (batch_id + 1) % cfg.log_every_step == 0:
                        print(f"Epoch [{epoch+1}/{cfg.epoch}] Batch [{batch_id+1}/{num_batches}] "
                              f"Loss: {float(terms['total_loss']):.6f}")
            # The one device-to-host sync of the epoch.
            host_sums = torch.stack([sums[k] for k in LOSS_KEYS]).cpu().tolist()
            self.epoch_seconds.append((host_s, time.perf_counter() - start))
            avg = {k: v / count for k, v in zip(LOSS_KEYS, host_sums)}
            for k in LOSS_KEYS:
                self.all_epoch_losses[k].append(avg[k])

            if (epoch + 1) % cfg.eval_every_epoch == 0:
                if evaluator is not None and eval_store is not None and eval_result_dir:
                    scores = evaluator(self, eval_store, eval_result_dir, epoch + 1, label_dir)
                    if scores is not None:
                        self.eval_metrics[epoch + 1] = scores
                self._save_epoch_ckpt(ckpt_dir, epoch + 1)
            print(f"Epoch [{epoch+1}/{cfg.epoch}] Average Loss: {avg['total_loss']:.6f} "
                  f"(host sampling {self.epoch_seconds[-1][0]:.3f} s of "
                  f"{self.epoch_seconds[-1][1]:.3f} s)")

        # Final-tail checkpoint (PARITY #22): the last epochs are saved even
        # when the epoch count is not a multiple of eval_every_epoch.
        if cfg.epoch > start_epoch and cfg.epoch % cfg.eval_every_epoch != 0:
            self._save_epoch_ckpt(ckpt_dir, cfg.epoch, label="Final checkpoint")
