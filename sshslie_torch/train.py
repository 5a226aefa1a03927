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
* Spans (``observability.span``, kept while a profiler records): each step
  is ``train.step``, with ``train.sample`` (the fused crop), ``train.forward``,
  ``train.loss``, ``train.backward``, ``train.allreduce`` (on a mesh) and
  ``train.adam`` (``zero_grad``, then the freeze mask and ``step``); an
  epoch of ``fit`` adds ``train.draws`` and ``train.epoch_sync``.
* Adam is ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` without weight
  decay, with each epoch's StepLR value written into its param groups:
  optax ``scale_by_adam`` followed by ``p - lr * u`` is the same update.
* Freeze (``freeze_decom_epochs`` with pretrained weights): the
  DecompositionNet's gradients are set to zero, not dropped, so Adam's
  moments and step counts advance as the JAX package's do; Adam is recreated
  at the unfreeze epoch (reference model.py:273-288).
* :class:`WindowedCubeFeeder` (``fused_window: K``) keeps K of the N cubes
  on the device an epoch, for datasets too large to stack (or on a
  disk-backed store): epoch e trains on cubes ``[(e*K + j) % N]``, the next
  window is read on a worker thread, and the fused step's cube index runs
  mod K; the draw table is unchanged, so windowing changes only which cube
  a sample reads. :func:`auto_fused_window` sizes K from the card's free
  memory (``fused_window: auto``).
* :class:`Trainer` is ``Trainer.fit``: pipeline selection as JAX (fused on
  same-shape cubes for ``fused_pipeline: auto|on``, resident or windowed,
  else the host sampler of ``data/native_sampler.py::make_sampler`` for the
  ``sampler`` key: the native xoshiro256** sampler for ``auto`` when its
  library loads and the store is in RAM and for ``native``,
  ``PatchSampler``'s numpy PCG64 stream for ``python``; its batches staged
  onto the device ``prefetch_batches`` ahead by ``datasets.Prefetcher``), per-epoch
  averages of the 7 terms with one device-to-host sync an epoch, eval and
  checkpoint on the ``eval_every_epoch`` cadence, the final-tail checkpoint
  (PARITY #22), resume from ``model_epoch_latest.pth`` with the optimizer
  state and the sampler fast-forwarded. Around it, as JAX: run-level
  tracking through ``mlflow`` (``observability.MLflowShim``) and plots and
  the model summary through ``observer``; ``async_eval``; ``checkpoint_best``;
  ``checkpoint_async`` (``checkpoints.AsyncWriter``); the cross-epoch eval
  saver; SIGTERM/SIGINT checkpoint-and-stop; a ``profile_dir`` trace of the
  first trained epoch; one device-memory line after the first epoch.
* ``async_eval``: nothing is donated in PyTorch, so the snapshot stays on the
  device: at the eval epoch the state dict is cloned on the training stream
  and an event recorded after it. One ``async-eval`` worker owns a model
  built with the trainer's config; on a side stream it waits on the event,
  loads the snapshot and runs the evaluator, then waits for its stream, so
  the snapshot is released only after every read of it. On the CPU the same
  code runs without streams.

* Data parallelism (``mesh``, a ``parallel.mesh.Mesh`` of N processes, one
  per GPU; JAX's ``mesh=`` of the step builders and of ``Trainer``): every
  rank holds the whole model and Adam's state, and computes its slice of
  the global batch; after its backward, on the current stream, one
  ``all_reduce`` over one flat buffer of every gradient and the step's
  terms, divided by the world size (:func:`_mean_over_ranks`), comes before
  the freeze mask and Adam. Every term is a mean over equally sized items
  and nothing in the model couples samples (no batch statistics), so the
  mean over ranks of the ranks' means is the global batch's mean, and every
  rank logs JAX's global terms. The accumulating step reduces once, after
  its last micro-batch; the fused step crops this rank's rows ``[r*b,
  (r+1)*b)`` of each step's global draws from the whole (replicated) stack,
  so the ranks' batches together are the one-process batch bit for bit;
  the host pipeline's ``Prefetcher`` keeps this rank's slice of each global
  batch. In ``fit`` rank 0 alone writes checkpoints, the best copy, tracking
  and plots, prints the memory line and runs an eval that is not sharded;
  a band-sharded eval (``eval_sharded``, ``eval_shard_mode: band``) runs on
  every rank, and never on the async worker (two threads issuing
  collectives in different orders would deadlock). A SIGTERM on any rank
  stops every rank after the same epoch. Checkpoints do not depend on the
  mesh: a run resumes on another number of ranks.
* The space axis (a 2-D ``mesh_shape`` "DxS" with ``space_axis``, JAX's
  dp×sp): the ``Trainer`` splits its model's height over the rank's space
  group (``models/enhance.py::shard_space``). A step takes the rank's data
  rows of the global batch (by its data index, ``process_batch_slice``), and
  :func:`_backward` its space rows of them after the crop and the
  augmentation, which move rows. The model's outputs are gathered along H
  within the space group (``gather_rows_replicated``, whose backward is the
  rank's slice) and every space rank computes the whole loss: the Fourier
  term's ``rfft2`` and ``_dy`` cross the rank boundary. So the gradients
  are partial sums over each rank's rows and the terms replicas:
  :func:`_mean_over_ranks` sums both over every rank in one ``all_reduce``
  and divides the gradients by the data axis's size, the terms by the
  world's. The patch must be a multiple of 8·S (``spatial.check_rows``).

Not ported (ROADMAP.md queue 1): a CUDA graph of a multistep chunk (item 11).
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from sshslie_torch import checkpoints, interop
from sshslie_torch.observability import Profiler, span
from sshslie_torch.config import SPEED_ONLY_KEYS, Config
from sshslie_torch.data.datasets import CubeStore, LazyCubeStore, Prefetcher
from sshslie_torch.data.native_sampler import NativePatchSampler, make_sampler
from sshslie_torch.device import resolve_device
from sshslie_torch.models.enhance import LowLightEnhanceNet, build_model, shard_space
from sshslie_torch.ops.losses import total_loss
from sshslie_torch.parallel import distributed, spatial
from sshslie_torch.parallel.mesh import Mesh, shard_batch_size
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
    gradients added into ``p.grad`` → the detached terms. A height-sharded
    model runs on its rank's rows of ``batch``; its outputs are gathered
    whole for the loss, which every rank of its space group computes."""
    space = model.space
    with span("train.forward"):
        if space is None:
            outs = model.forward_with_redecomposition(batch)
        else:
            spatial.check_rows(batch.shape[1], space, "the patch height")
            outs = spatial.gather_rows_replicated(
                model.forward_with_redecomposition(spatial.take_rows(batch, space, dim=1)),
                space, dim=1)
    with span("train.loss"):
        total, terms = total_loss(batch, *outs, coeffs)
    with span("train.backward"):
        total.backward()
    return {k: terms[k].detach() for k in LOSS_KEYS}


def _update(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
            freeze_decom: bool) -> None:
    """Freeze mask and Adam (JAX ``_apply_update``)."""
    with span("train.adam"):
        if freeze_decom:
            for p in model.decomposition_net.parameters():
                p.grad.zero_()
        optimizer.step()


def _zero_grad(optimizer: torch.optim.Optimizer) -> None:
    with span("train.adam"):
        optimizer.zero_grad(set_to_none=True)


def _mean_over_ranks(model: LowLightEnhanceNet, terms: Dict[str, torch.Tensor],
                     mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Data parallel: the rank's gradients and terms replaced by their means
    over the ranks (one ``all_reduce`` of one flat buffer, after the backward
    on the current stream) → the global terms. Without a mesh, ``terms``.
    A height-sharded model's gradients are partial sums over its rows: their
    sum over every rank is divided by the data axis's size alone."""
    if mesh is None:
        return terms
    with span("train.allreduce"):
        stacked = torch.stack([terms[k] for k in LOSS_KEYS])
        grads = [p.grad for p in model.parameters()]
        n = mesh.data_size if model.space is not None else mesh.size
        distributed.all_mean_(grads + [stacked], [n] * len(grads) + [mesh.size])
        return dict(zip(LOSS_KEYS, stacked.unbind()))


def _add_terms(sums: Optional[Dict[str, torch.Tensor]],
               terms: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return terms if sums is None else {k: sums[k] + terms[k] for k in LOSS_KEYS}


def train_step(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
               batch: torch.Tensor, coeffs: Dict[str, float],
               freeze_decom: bool = False, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One update on an NHWC batch (with ``mesh``, this rank's slice of the
    global batch, whole in height) → {LOSS_KEYS name: detached scalar tensor}."""
    with span("train.step"):
        return _step(model, optimizer, batch, coeffs, freeze_decom, mesh)


def _step(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer, batch: torch.Tensor,
          coeffs: Dict[str, float], freeze_decom: bool,
          mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """:func:`train_step`'s update, inside its caller's ``train.step`` span."""
    _zero_grad(optimizer)
    terms = _mean_over_ranks(model, _backward(model, batch, coeffs), mesh)
    _update(model, optimizer, freeze_decom)
    return terms


def accum_train_step(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
                     batch: torch.Tensor, coeffs: Dict[str, float], accum_steps: int,
                     freeze_decom: bool = False,
                     mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One update from ``accum_steps`` consecutive micro-batches of ``batch``:
    the gradients and terms summed in micro-batch order and scaled by
    1/accum_steps (every term is a mean over the batch, so this is the
    full-batch update up to rounding); with ``mesh``, averaged over the
    ranks once, after the last micro-batch."""
    b = batch.shape[0]
    if b % accum_steps != 0:
        raise ValueError(f"batch {b} not divisible by grad_accum_steps {accum_steps}")
    with span("train.step"):
        _zero_grad(optimizer)
        sums = None
        for micro in batch.chunk(accum_steps):
            sums = _add_terms(sums, _backward(model, micro, coeffs))
        inv = 1.0 / accum_steps
        for p in model.parameters():
            p.grad.mul_(inv)
        terms = _mean_over_ranks(model, {k: sums[k] * inv for k in LOSS_KEYS}, mesh)
        _update(model, optimizer, freeze_decom)
        return terms


def stack_cubes(store: CubeStore, device) -> Optional[torch.Tensor]:
    """The (N, H, W, C) float32 stack of the store's cubes on ``device``, or
    None when their shapes differ or the store is disk-backed (JAX
    ``stack_cubes``: a lazy store takes ``fused_window`` instead)."""
    if isinstance(store, LazyCubeStore) or len({tuple(s) for s in store.shapes}) != 1:
        return None
    return torch.from_numpy(np.stack(store.cubes)).to(device)


def device_memory_stats(device: torch.device) -> Optional[Dict[str, int]]:
    """The card's memory as JAX's ``Device.memory_stats()`` keys, or None on
    the CPU, which has none. ``bytes_limit`` is the card's total and
    ``bytes_in_use`` the total less what torch could still take: the free
    bytes ``torch.cuda.mem_get_info`` reports plus what the caching allocator
    holds without handing it out (reserved less allocated)."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return {"bytes_limit": int(total), "bytes_in_use": int(total - free)}


def auto_fused_window(store: CubeStore, batch_size: int, device=None, safety: float = 0.5,
                      memory_stats: Callable = device_memory_stats) -> int:
    """``fused_window: auto`` → a window size (JAX ``auto_fused_window``).

    0 when the whole stack fits (no window, the resident fused pipeline); K
    in [max(2, min(batch, N)), N - 1] when a window fits where the stack does
    not; -1 when no useful window fits or the shapes differ (the caller
    takes the host sampler). A window cube is charged twice, JAX's margin
    for the two windows its epoch boundary holds (the port releases the
    last window before it uploads the next), against ``safety`` of the free
    memory, ``bytes_limit - bytes_in_use`` of ``memory_stats``
    (:func:`device_memory_stats`; a test passes the same numbers as a fake
    JAX device). Without stats (the CPU) the result is 0, or for a
    disk-backed store ``min(max(k_min, 2 * batch), N - 1)``: a lazy store
    always windows, since its stack is never built. K is resolved again in
    each process, so a resumed run may pick another; pin an integer for a
    replay-exact resume."""
    device = resolve_device(device)
    shapes = {tuple(s) for s in store.shapes}
    if len(shapes) != 1:
        return -1
    h, w, c = next(iter(shapes))
    cube_bytes = h * w * c * 4
    n = len(store)
    lazy = isinstance(store, LazyCubeStore)
    k_min = max(2, min(batch_size, n))
    if lazy and n <= k_min:
        return -1  # a window must be a strict subset
    stats = memory_stats(device)
    if not stats or "bytes_limit" not in stats:
        return int(min(max(k_min, 2 * batch_size), n - 1)) if lazy else 0
    free = int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
    budget = int(free * safety)
    if n * cube_bytes <= budget and not lazy:
        return 0
    k = budget // (2 * cube_bytes)
    if k < k_min:
        return -1
    return int(min(k, n - 1))


class WindowedCubeFeeder:
    """K of the store's N cubes on the device an epoch (JAX
    ``WindowedCubeFeeder``).

    Epoch e trains on ``indices(e) = [(e*K + j) % N for j < K]``, so every
    cube comes back every ceil(N/K) epochs and a resumed run replays the
    same windows. The next epoch's cubes are read on one worker thread (disk
    loads through the store's cache overlap this epoch's steps), cube by
    cube, so :meth:`close` can stop it between two loads; :meth:`window`
    then stacks nothing more and only uploads. No prefetch is started past
    ``num_epochs``.
    """

    def __init__(self, store: CubeStore, k: int, device, num_epochs: Optional[int] = None):
        from concurrent.futures import ThreadPoolExecutor

        self.store = store
        self.n = len(store)
        self.k = min(int(k), self.n)
        self.device = device
        self.num_epochs = num_epochs
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fused-window")
        self._cancel = threading.Event()
        self._next = None  # (epoch, Future of the host stack)

    def indices(self, epoch: int) -> list:
        start = (epoch * self.k) % self.n
        return [(start + j) % self.n for j in range(self.k)]

    def _host_window(self, epoch: int) -> np.ndarray:
        cubes = []
        for i in self.indices(epoch):
            if self._cancel.is_set():
                raise RuntimeError("WindowedCubeFeeder closed mid-prefetch")
            cubes.append(self.store[i])
        return np.stack(cubes)

    def window(self, epoch: int) -> torch.Tensor:
        """Epoch ``epoch``'s (K, H, W, C) float32 stack on the device."""
        if self._next is not None and self._next[0] == epoch:
            host = self._next[1].result()
        else:  # the first epoch, or a resume
            host = self._host_window(epoch)
        if self.num_epochs is None or epoch + 1 < self.num_epochs:
            self._next = (epoch + 1, self._pool.submit(self._host_window, epoch + 1))
        else:
            self._next = None
        return torch.from_numpy(host).to(self.device)

    def close(self) -> None:
        self._cancel.set()
        self._pool.shutdown(wait=False, cancel_futures=True)


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
                     freeze_decom: bool = False,
                     mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One fused step: the batch sampled on the device, then :func:`train_step`.
    ``draws`` are the step's global rows; with ``mesh`` this rank crops its
    own, ``[d*b, (d+1)*b)`` for its data index d, which are samples
    ``batch_start + d*b`` on."""
    with span("train.step"):
        with span("train.sample"):
            if mesh is not None:
                rows = distributed.process_batch_slice(draws.shape[0], mesh)
                draws, batch_start = draws[rows], batch_start + rows.start
            batch = sample_fused_batch(cubes, draws, batch_start, patch_size)
        return _step(model, optimizer, batch, coeffs, freeze_decom, mesh)


def multistep_train_step(model: LowLightEnhanceNet, optimizer: torch.optim.Optimizer,
                         cubes: torch.Tensor, epoch_draws: torch.Tensor,
                         batch_ids: Iterable[int], batch_size: int, patch_size: int,
                         coeffs: Dict[str, float], freeze_decom: bool = False,
                         mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The fused steps ``batch_ids`` of an epoch in one host call, each
    exactly as :func:`fused_train_step` → their terms summed in step order.
    ``batch_size`` is the global batch."""
    sums = None
    for batch_id in batch_ids:
        sums = _add_terms(sums, fused_train_step(
            model, optimizer, cubes, epoch_draws[batch_id], batch_id * batch_size,
            patch_size, coeffs, freeze_decom, mesh))
    return sums


def report_hbm_pressure(device: torch.device, threshold: float = 0.92) -> Optional[str]:
    """One line of device-memory pressure, printed once after the first
    trained epoch: the caching allocator's peak reserved bytes against the
    card's total, with a warning at ``threshold``. None on the CPU."""
    if device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_reserved(device)
    total = torch.cuda.mem_get_info(device)[1]
    if peak <= 0 or total <= 0:
        return None
    gib = 1024.0 ** 3
    line = (f"Device memory pressure: peak reserved {peak / gib:.2f}/{total / gib:.2f} GiB "
            f"({100.0 * peak / total:.1f}%)")
    if peak >= threshold * total:
        line += " — near the ceiling: consider a smaller batch/patch or remat: true"
    print(line)
    return line


def host_copy(tree):
    """A host copy of a (nested) state dict that later in-place updates of the
    live tensors cannot reach: ``.cpu()`` of a CPU tensor is the tensor itself."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class _SnapshotView:
    """What the evaluator reads of a trainer (``.cfg``, ``.model``) for an
    async eval: the worker's own model, loaded with the eval epoch's weights."""

    def __init__(self, cfg: Config, model: torch.nn.Module):
        self.cfg = cfg
        self.model = model


class Trainer:
    """Epoch orchestration (reference train_model, model.py:236-341).

    The initial weights are drawn from a ``torch.Generator`` seeded with
    ``cfg.seed_value``, or taken from ``state_dict`` (the tests pass JAX
    ``init_params`` through ``interop.jax_params_to_state_dict``). ``mesh``
    (``parallel.mesh.make_mesh``) trains data parallel over its ranks.
    """

    def __init__(self, cfg: Config, channels: int, device=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 mlflow=None, observer=None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh              # evaluate._make_inferencer dispatches on it
        self.mlflow = mlflow          # observability.MLflowShim or None
        self.observer = observer      # observability.RunObserver or None
        self.eval_saver = None        # evaluate._OverlappedSaver while fit runs a sync eval
        self.channels = channels
        self.device = resolve_device(cfg.device if device is None else device)
        self.model = build_model(cfg, channels, self.device,
                                 generator=torch.Generator().manual_seed(cfg.seed_value), train=True)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        if mesh is not None and cfg.space_axis:
            shard_space(self.model, mesh.shard(cfg.space_axis))
        self.coeffs = loss_coeffs(cfg)
        self.optimizer = make_optimizer(self.model, cfg.start_lr)
        self.freeze_decom_epochs = int(cfg.freeze_decom_epochs or 0)
        self.all_epoch_losses: Dict[str, list] = {k: [] for k in LOSS_KEYS}
        self.eval_metrics: Dict[int, Dict[str, float]] = {}
        self.pipeline = ""           # 'fused' or 'host', set by fit
        # Per trained epoch: (seconds the host waited for the prefetched
        # batches, or spent drawing and uploading the fused draws and, when
        # windowed, waiting for and uploading the window; wall seconds of the
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
        # Data parallel: rank 0 alone writes files and tracks (JAX's single
        # writer); a band-sharded eval is collective and runs on every rank.
        mesh = self.mesh
        writer = distributed.rank() == 0
        mlflow, observer = (self.mlflow, self.observer) if writer else (None, None)
        eval_sharded = mesh is not None and cfg.eval_sharded
        if mesh is not None:
            shard_batch_size(cfg.batch_size, mesh, cfg.data_axis)
            if cfg.space_axis:
                n_sp = mesh.shape[cfg.space_axis]
                if cfg.patch_size % n_sp != 0:
                    raise ValueError(f"patch_size {cfg.patch_size} not divisible by the "
                                     f"'{cfg.space_axis}' mesh axis ({n_sp} shards)")
                spatial.check_rows(cfg.patch_size, self.model.space, "patch_size")

        start_epoch = 0
        if cfg.resume:
            # Every rank loads the latest checkpoint: it does not depend on the mesh.
            latest = checkpoints.latest_path(ckpt_dir)
            if os.path.exists(latest):
                start_epoch = interop.load_checkpoint(latest, self.model, self.optimizer) or 0
                print(f"Resuming training from epoch {start_epoch}")
            else:
                print(f"resume requested but no checkpoint at {latest}; starting fresh")
        if mesh is not None:
            # Replicated weights: rank 0's, whatever each rank was given.
            distributed.broadcast_(list(self.model.parameters()))
        if eval_result_dir:
            os.makedirs(eval_result_dir, exist_ok=True)

        # Pipeline selection (JAX Trainer.fit): the fused pipeline for
        # 'auto'/'on' without accumulation on same-shape cubes, on a resident
        # stack or a rotating window of fused_window cubes; else the host sampler.
        accum = max(int(cfg.grad_accum_steps), 1)
        if accum > 1 and cfg.fused_pipeline == "on":
            raise ValueError("grad_accum_steps > 1 requires the host pipeline; set "
                             "fused_pipeline to 'auto' or 'off'")
        fused_eligible = accum == 1 and cfg.fused_pipeline in ("auto", "on")
        # 'auto' is resolved only where the fused pipeline would act on it.
        fused_window = cfg.fused_window if fused_eligible else 0
        if fused_window == "auto":
            fused_window = auto_fused_window(train_store, cfg.batch_size, self.device)
            if mesh is not None:
                # Each rank reads its own card; all take the smallest demand
                # (-1 none, then K cubes, then 0: the whole stack of N).
                n = len(train_store)
                k = -int(distributed.all_max(-(fused_window or n), self.device))
                fused_window = 0 if k == n else k
            if fused_window < 0:
                print("fused_window=auto: no useful window fits the device memory budget "
                      "(or cube shapes are mixed) — degrading to the host sampler")
            elif fused_window == 0:
                print("fused_window=auto: full training stack fits resident (no windowing)")
            else:
                print(f"fused_window=auto: window={fused_window}/{len(train_store)} cube(s) "
                      "from device memory stats (pin an integer fused_window for bit-exact "
                      "resume across memory-state changes)")
        cubes = feeder = sampler = None
        if fused_eligible and fused_window >= 0:
            uniform = len({tuple(s) for s in shapes}) == 1
            if 0 < fused_window < len(train_store) and uniform:
                feeder = WindowedCubeFeeder(train_store, fused_window, self.device,
                                            num_epochs=cfg.epoch)
            else:
                cubes = stack_cubes(train_store, self.device)
                if cubes is None and fused_window > 0 and uniform:
                    # fused_window >= N on a lazy store: the window is the whole
                    # dataset, so its stack is built once.
                    cubes = torch.from_numpy(np.stack(
                        [train_store[i] for i in range(len(train_store))])).to(self.device)
                if cubes is None and cfg.fused_pipeline == "on":
                    raise ValueError(
                        "fused_pipeline='on' requires all training cubes to share one shape "
                        "(or fused_window for lazy stores); use 'auto' or 'off' for "
                        "mixed-size datasets")
        k_steps = max(int(cfg.steps_per_dispatch), 1)
        self.pipeline = "host" if cubes is None and feeder is None else "fused"
        rng_text = ("rng=numpy PCG64 table of each epoch's draws from "
                    "SeedSequence([seed_value, epoch]); not the JAX threefry stream)")
        if feeder is not None:
            print(f"Patch sampler: fused on-device pipeline, windowed (window={feeder.k}/"
                  f"{feeder.n} cubes, fused_pipeline={cfg.fused_pipeline!r}, "
                  f"steps_per_dispatch={k_steps}, {rng_text}")
        elif cubes is not None:
            print(f"Patch sampler: fused on-device pipeline (fused_pipeline="
                  f"{cfg.fused_pipeline!r}, steps_per_dispatch={k_steps}, {rng_text}")
        else:
            sampler = make_sampler(train_store, cfg.batch_size, cfg.patch_size,
                                   seed=cfg.seed_value, mode=cfg.sampler)
            if start_epoch > 0:
                sampler.skip_epochs(start_epoch)
            native = isinstance(sampler, NativePatchSampler)
            print(f"Patch sampler: {type(sampler).__name__} (sampler={cfg.sampler!r}, "
                  f"fused_pipeline={cfg.fused_pipeline!r} -> host pipeline, "
                  f"grad_accum_steps={accum}, "
                  f"rng={'xoshiro256**' if native else 'numpy PCG64'})")
        print("Ignored (speed only): "
              + ", ".join(f"{k}={getattr(cfg, k)!r}" for k in SPEED_ONLY_KEYS))
        num_batches = len(train_store) // cfg.batch_size
        if mlflow:
            mlflow.log_params({
                "epochs": cfg.epoch,
                "start_lr": cfg.start_lr,
                "adaptive_lr": abs(cfg.lr_update_factor - 1) > 1e-6,
                "batch_size": cfg.batch_size,
                "optimizer": "Adam",
            })
        if observer:
            observer.log_model_summary(self.model, ckpt_dir, mlflow)

        run_evals = (evaluator is not None and eval_store is not None and bool(eval_result_dir)
                     and (writer or eval_sharded))
        eval_pool = None
        pending_evals: list = []
        if cfg.async_eval and run_evals and not eval_sharded:
            eval_pool, eval_snapshot = self._async_evaluator(
                evaluator, eval_store, eval_result_dir, label_dir)
        # The sync eval's saver lives across epochs: an eval epoch's copies and
        # .mat writes overlap the next training epochs (the async worker runs
        # whole evals and keeps a saver a call).
        if run_evals and eval_pool is None:
            from sshslie_torch.evaluate import _OverlappedSaver

            self.eval_saver = _OverlappedSaver()
        ckpt_writer = checkpoints.AsyncWriter() if cfg.checkpoint_async and writer else None

        # checkpoint_best: per fit run, so a resumed run starts its best afresh
        # (the epoch files stay the durable record).
        best = {"psnr": float("-inf"), "ep": None, "written_ep": None}

        def _record_eval(ep: int, scores) -> None:
            if scores is None:
                return
            self.eval_metrics[ep] = scores
            if cfg.checkpoint_best and "psnr" in scores and scores["psnr"] > best["psnr"]:
                best["psnr"], best["ep"] = scores["psnr"], ep
            if observer and eval_result_dir:
                observer.plot_eval_metrics(
                    self.eval_metrics, os.path.join(eval_result_dir, "eval_metrics.png"))

        def _sync_best() -> None:
            """Copy the winning epoch file to model_epoch_best, FIFO behind the
            epoch save on the writer. The candidate is read here, on the
            training thread, where its epoch's save is already queued."""
            if (not writer or not cfg.checkpoint_best or best["ep"] is None
                    or best["ep"] == best["written_ep"]):
                return
            ep, psnr = best["ep"], best["psnr"]

            def _copy() -> None:
                src = checkpoints.epoch_path(ckpt_dir, ep)
                if not os.path.exists(src):
                    # A lagging async eval can outlive its epoch file under
                    # checkpoint_keep: fall back to the best still on disk, so
                    # a later epoch that beats it (but not the pruned one) is
                    # still copied. A newer candidate recorded meanwhile stays.
                    prev = best["written_ep"]
                    print(f"checkpoint_best: epoch {ep} checkpoint was already pruned; "
                          f"best left at epoch {prev}")
                    if best["ep"] == ep:
                        best["ep"] = prev
                        best["psnr"] = (self.eval_metrics.get(prev, {}).get("psnr", float("-inf"))
                                        if prev is not None else float("-inf"))
                    return
                checkpoints.copy_checkpoint(src, checkpoints.best_path(ckpt_dir))
                best["written_ep"] = ep
                print(f"Best checkpoint updated: epoch {ep} (PSNR {psnr:.4f})")

            if ckpt_writer is not None:
                ckpt_writer.submit(_copy)
            else:
                _copy()

        def _save_epoch_ckpt(ep: int, label: str = "Checkpoint") -> None:
            """Epoch file, latest byte-copy, retention prune. With
            checkpoint_async the weights and the Adam state are copied to the
            host now (the next step updates them in place) and the rest runs
            on the writer. Rank 0 only."""
            if not writer:
                return

            def _write(state_dict, opt_state) -> None:
                saved = interop.save_checkpoint(checkpoints.epoch_path(ckpt_dir, ep),
                                                state_dict, ep, opt_state)
                latest = checkpoints.copy_checkpoint(saved, checkpoints.latest_path(ckpt_dir))
                print(f"{label} saved at {latest}")
                if cfg.checkpoint_keep > 0:
                    checkpoints.prune_checkpoints(ckpt_dir, cfg.checkpoint_keep)

            if ckpt_writer is None:
                _write(self.model.state_dict(), self.optimizer)
            else:
                ckpt_writer.submit(_write, host_copy(self.model.state_dict()),
                                   host_copy(self.optimizer.state_dict()))

        def _drain_evals(block: bool) -> None:
            """Record the finished async evals in epoch order, each followed by
            its best-copy (its epoch's save is already queued), so that a
            winner pruned before its copy re-arms the tracker before the next
            eval is compared, however late the evals finish."""
            remaining = []
            for ep, fut in pending_evals:
                if block or fut.done():
                    try:
                        _record_eval(ep, fut.result())
                    except Exception as e:  # noqa: BLE001
                        # A failed eval is reported, never raised: it must not
                        # end training nor mask a training error in finally.
                        print(f"async eval for epoch {ep} failed: {type(e).__name__}: {e}")
                    _sync_best()
                else:
                    remaining.append((ep, fut))
            pending_evals[:] = remaining

        # Preemption: on SIGTERM/SIGINT finish the epoch, write a resumable
        # checkpoint and return. Handlers only in the main thread (the signal
        # API's rule), restored in finally.
        self._stop_requested = False
        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            def _request_stop(signum, _frame):
                if self._stop_requested:
                    # A second signal restores the handlers and stops mid-epoch.
                    for sig, handler in prev_handlers.items():
                        signal.signal(sig, handler)
                    raise KeyboardInterrupt
                self._stop_requested = True
                # os.write is async-signal-safe; print() into a buffered
                # stdout the signal interrupted would raise.
                os.write(2, f"\nsignal {signum}: will checkpoint and stop after this epoch "
                            "(repeat to force)\n".encode())

            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _request_stop)

        profiler = Profiler(cfg.profile_dir, self.device)
        try:
            # Trace the first trained epoch, its eval and checkpoint included.
            profiler.start()
            for epoch in range(start_epoch, cfg.epoch):
                avg, lr = self._train_epoch(epoch, cubes, feeder, sampler, num_batches, accum,
                                            k_steps)
                if epoch == start_epoch and writer:
                    report_hbm_pressure(self.device)
                if (eval_result_dir and observer
                        and (epoch + 1) % cfg.plot_every_epoch == 0):
                    observer.plot_loss_curve(
                        self.all_epoch_losses, os.path.join(eval_result_dir, "loss_curves.png"))
                if (epoch + 1) % cfg.eval_every_epoch == 0:
                    if eval_pool is not None:
                        pending_evals.append((epoch + 1, eval_snapshot(epoch + 1)))
                    elif run_evals:
                        _record_eval(epoch + 1, evaluator(self, eval_store, eval_result_dir,
                                                          epoch + 1, label_dir))
                    _save_epoch_ckpt(epoch + 1)
                    # After the epoch file is queued: the sync eval's scores
                    # are in, so the best copy can follow it.
                    _sync_best()
                if profiler.active:
                    print(f"Profiler trace written to {profiler.stop()}")
                if mlflow:
                    mlflow.log_metric("learning_rate", lr, step=epoch)
                    mlflow.log_metrics(avg, step=epoch)
                print(f"Epoch [{epoch+1}/{cfg.epoch}] Average Loss: {avg['total_loss']:.6f} "
                      f"(host sampling {self.epoch_seconds[-1][0]:.3f} s of "
                      f"{self.epoch_seconds[-1][1]:.3f} s)")
                if eval_pool is not None:
                    _drain_evals(block=False)
                if mesh is not None:
                    # A signal on any rank stops every rank after this epoch.
                    self._stop_requested = bool(distributed.all_max(self._stop_requested,
                                                                    self.device))
                if self._stop_requested:
                    # Queued saves also copy into latest: drain first, so the
                    # preemption write is the newest.
                    if ckpt_writer is not None:
                        ckpt_writer.drain()
                    if writer:
                        interop.save_checkpoint(checkpoints.latest_path(ckpt_dir),
                                                self.model.state_dict(), epoch + 1,
                                                self.optimizer)
                    print(f"Preemption checkpoint written at epoch {epoch+1}; "
                          "stopping (resume with resume: true)")
                    break

            # Final-tail checkpoint (PARITY #22): the last epochs are saved even
            # when the epoch count is not a multiple of eval_every_epoch.
            if (not self._stop_requested and cfg.epoch > start_epoch
                    and cfg.epoch % cfg.eval_every_epoch != 0):
                _save_epoch_ckpt(cfg.epoch, label="Final checkpoint")
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            if feeder is not None:
                feeder.close()
            if profiler.active:
                # A raise in the traced epoch still writes its trace.
                try:
                    print(f"Profiler trace written to {profiler.stop()}")
                except Exception as e:  # noqa: BLE001
                    print(f"profiler stop failed: {e}")
            # Evals are drained here, so a training error does not drop them;
            # a failed eval is reported, never raised.
            if eval_pool is not None:
                try:
                    _drain_evals(block=True)
                finally:
                    eval_pool.shutdown(wait=True)
            # A failed write raises when training succeeded (a lost checkpoint
            # is worse than a failed run), and is only reported when it would
            # mask the training error in flight.
            in_flight = sys.exc_info()[0] is not None
            eval_saver, self.eval_saver = self.eval_saver, None
            for name, closer in (("checkpoint write", ckpt_writer), ("eval save", eval_saver)):
                if closer is None:
                    continue
                try:
                    closer.close()
                except Exception as e:  # noqa: BLE001
                    if not in_flight:
                        raise
                    print(f"{name} failed during teardown: {type(e).__name__}: {e}")
            if observer is not None:
                observer.drain()

        if mesh is not None:
            # The checkpoints are on disk before any rank reads them.
            distributed.barrier(self.device)
        if mlflow:
            mlflow.log_param("model_path",
                                  os.path.normpath(checkpoints.latest_path(ckpt_dir)))

    def _async_evaluator(self, evaluator: Callable, eval_store: CubeStore,
                         eval_result_dir: str, label_dir: Optional[str]):
        """The async eval's worker → (its pool, ``submit(epoch)`` → a future of
        the scores). ``submit`` runs on the training thread: it clones the
        state dict there, in the training stream's order, and records an
        event after the clone."""
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="async-eval")
        view = _SnapshotView(self.cfg, build_model(
            self.cfg, self.channels, self.device,
            generator=torch.Generator().manual_seed(self.cfg.seed_value)))
        cuda = self.device.type == "cuda"
        eval_stream = torch.cuda.Stream(self.device) if cuda else None

        def run(snapshot, ready, epoch):
            with torch.cuda.stream(eval_stream) if cuda else contextlib.nullcontext():
                if cuda:
                    eval_stream.wait_event(ready)
                view.model.load_state_dict(snapshot)
                try:
                    return evaluator(view, eval_store, eval_result_dir, epoch, label_dir)
                finally:
                    # Every read of the snapshot (and of the saver's
                    # tensors) is done before the future completes and the
                    # snapshot is released to the training stream's pool.
                    if cuda:
                        eval_stream.synchronize()

        def submit(epoch: int):
            snapshot = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            return pool.submit(run, snapshot, ready, epoch)

        return pool, submit

    def _train_epoch(self, epoch: int, cubes: Optional[torch.Tensor],
                     feeder: Optional[WindowedCubeFeeder], sampler, num_batches: int,
                     accum: int, k_steps: int):
        """One epoch of steps → (the 7 average terms, the epoch's lr), with its
        one device-to-host sync; appends to ``all_epoch_losses`` and
        ``epoch_seconds``. With ``feeder`` the epoch's window is the stack."""
        cfg = self.cfg
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
        if feeder is not None:
            # The epoch's window (read ahead on the feeder's thread), uploaded;
            # rebinding releases the last epoch's.
            cubes = feeder.window(epoch)
            host_s += time.perf_counter() - start
        if cubes is not None:
            # The epoch's draws, uploaded once; steps index them on the device.
            t = time.perf_counter()
            with span("train.draws"):
                draws = torch.from_numpy(fused_draws(
                    cfg.seed_value, epoch, num_batches, cfg.batch_size, tuple(cubes.shape[1:3]),
                    cfg.patch_size)).to(self.device)
            host_s += time.perf_counter() - t
            for chunk_start in range(0, num_batches, k_steps):
                ids = range(chunk_start, min(chunk_start + k_steps, num_batches))
                terms = multistep_train_step(self.model, self.optimizer, cubes, draws, ids,
                                             cfg.batch_size, cfg.patch_size, self.coeffs, freeze,
                                             self.mesh)
                sums = _add_terms(sums, terms)
                count += len(ids)
                # log_every_step's cadence: print when the chunk crossed an N boundary.
                if cfg.log_every_step and ((ids[-1] + 1) // cfg.log_every_step
                                           > ids[0] // cfg.log_every_step):
                    print(f"Epoch [{epoch+1}/{cfg.epoch}] Batch [{ids[-1]+1}/{num_batches}] "
                          f"Loss: {float(terms['total_loss']) / len(ids):.6f}")
        else:
            # Batches staged onto the device prefetch_batches ahead (each
            # rank's slice of the global batch); closing the prefetcher
            # releases its worker if a step raises.
            rows = (distributed.process_batch_slice(cfg.batch_size, self.mesh)
                    if self.mesh is not None else None)
            with Prefetcher(sampler.epoch(), self.device, depth=cfg.prefetch_batches,
                            process_slice=rows) as batches:
                for batch_id in range(num_batches):
                    t = time.perf_counter()
                    batch = next(batches)
                    host_s += time.perf_counter() - t
                    if accum > 1:
                        terms = accum_train_step(self.model, self.optimizer, batch, self.coeffs,
                                                 accum, freeze, self.mesh)
                    else:
                        terms = train_step(self.model, self.optimizer, batch, self.coeffs,
                                           freeze, self.mesh)
                    sums = _add_terms(sums, terms)
                    count += 1
                    if cfg.log_every_step and (batch_id + 1) % cfg.log_every_step == 0:
                        print(f"Epoch [{epoch+1}/{cfg.epoch}] Batch [{batch_id+1}/"
                              f"{num_batches}] Loss: {float(terms['total_loss']):.6f}")
        # The one device-to-host sync of the epoch.
        with span("train.epoch_sync"):
            host_sums = torch.stack([sums[k] for k in LOSS_KEYS]).cpu().tolist()
        self.epoch_seconds.append((host_s, time.perf_counter() - start))
        avg = {k: v / count for k, v in zip(LOSS_KEYS, host_sums)}
        for k in LOSS_KEYS:
            self.all_epoch_losses[k].append(avg[k])
        return avg, lr
