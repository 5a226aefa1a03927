"""Whole-cube inference and the test phase, as ``sshslie_tpu/evaluate.py``.

* :func:`pad_forward_crop_batch` edge-pads H and W to a multiple
  (``F.pad(mode="replicate")`` for the JAX ``jnp.pad(mode="edge")``), runs the
  forward and crops the pad back out.
* :class:`Inferencer` runs the model under ``torch.inference_mode`` on
  stacks of host (H, W, C) cubes; the upload is part of the call, as in the
  JAX one. ``inf(weights, cube)`` (JAX ``Inferencer(params, cube)``) runs
  one cube with explicit weights, a state dict on the device, through
  ``torch.func.functional_call``: the serving path's hot reload swaps them
  without touching the module.
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

* :class:`ShardedInferencer` (``eval_sharded: true`` with a mesh, the
  default ``eval_shard_mode: spatial``; :func:`_make_inferencer`) splits the
  cube's height across the ranks of the mesh's data axis, and
  :class:`BandShardedInferencer` (``eval_shard_mode: band``) its bands.
  Under a mesh rank 0 alone saves and scores (JAX's single writer); every
  rank runs the forward, which a sharded eval needs.

Every inferencer runs the model under its own height split (None but for
the ``ShardedInferencer``), whatever split a trainer gave the model for its
steps (``models/enhance.py::sharded``).
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
from sshslie_torch.models.enhance import sharded
from sshslie_torch.ops import at_least_float32
from sshslie_torch.parallel import distributed, spatial
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
    """(R_low, I_low, I_delta, S) forward over host (H, W, C) cubes, with the
    model's own weights or explicit ones (a state dict on ``device``, the
    model's device unless given)."""

    shard: Optional[spatial.Shard] = None    # the height split of its forwards

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
        with torch.inference_mode(), sharded(self.model, self.shard):
            x = torch.as_tensor(stack, dtype=torch.float32).to(self.device)
            return pad_forward_crop_batch(self._fn(weights), x, m, m)

    def __call__(self, weights: Optional[Dict[str, torch.Tensor]], cube):
        """One (H, W, C) cube (host array or tensor) with ``weights`` (None:
        the model's own); outputs without the batch dim."""
        R, I, Id, S = self.batched(torch.as_tensor(cube)[None], weights)
        return R[0], I[0], Id[0], S[0]


class ShardedInferencer(Inferencer):
    """Height-sharded whole-cube inference over the ranks of a mesh's data
    axis (JAX ``ShardedInferencer``; on a 2-D mesh the space ranks compute
    replicas, as JAX's ``P(None, data_axis)`` leaves them).

    H is edge-padded to a multiple of 8·n and W to a multiple of 8, so that
    every rank's share of the stride-2 pyramid stays even; the pad is
    cropped from the outputs. Rank i uploads only its rows ``[i*H/n,
    (i+1)*H/n)`` of the padded cube and runs the model (its own weights, or
    explicit ones on ``device``) under a split of its height
    (``parallel/spatial.py``: halo rows at every conv, the attention on the
    gathered sequence). R, I_low, I_delta and S are gathered (one
    ``all_gather``), so that rank 0 holds them whole to save and score, as
    JAX replicates its outputs for its single writer. :meth:`from_rank0`
    runs a cube that only rank 0 holds (the mesh service). Without a process
    group (a 1-process mesh) it is the whole forward.
    """

    def __init__(self, model: torch.nn.Module, mesh, data_axis: str = "data",
                 device: Optional[torch.device] = None):
        super().__init__(model, pad_multiple=8, device=device)
        self.shard = mesh.shard(data_axis)
        self.n = self.shard.size

    def batched(self, stack, weights: Optional[Dict[str, torch.Tensor]] = None):
        """(N, H, W, C) stack of same-shape cubes in one height-sharded
        forward; only this rank's rows are uploaded."""
        with torch.inference_mode(), sharded(self.model, self.shard):
            x = torch.as_tensor(stack, dtype=torch.float32)
            _, h, w, _ = x.shape
            ph, pw = (-h) % (8 * self.n), (-w) % 8
            if ph or pw:
                x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                          mode="replicate").permute(0, 2, 3, 1)
            x = spatial.take_rows(x, self.shard, dim=1).contiguous().to(self.device)
            outs = self._fn(weights)(x)
            sizes = [t.shape[-1] for t in outs]
            whole = distributed.all_gather_cat(torch.cat(outs, dim=-1), 1, self.shard.group)
            return tuple(t[:, :h, :w] for t in whole.split(sizes, dim=-1))

    def from_rank0(self, weights: Optional[Dict[str, torch.Tensor]], cube=None, shape=None):
        """One (H, W, C) float32 cube that rank 0 holds: rank 0 passes it, the
        other ranks its ``shape``. It is broadcast whole from rank 0 over the
        group, on ``device``, and each rank keeps its rows; outputs as
        ``__call__``'s, whole on every rank."""
        x = distributed.broadcast_tensor(None if cube is None else torch.as_tensor(cube),
                                         shape, torch.float32, self.device)
        return self(weights, x)


class BandShardedInferencer(Inferencer):
    """Band-sharded whole-cube inference over the ranks of a mesh (JAX
    ``BandShardedInferencer``).

    Rank r of n on the data axis owns bands ``[r*C/n, (r+1)*C/n)`` (on a 2-D
    mesh the space ranks compute replicas): it uploads only those of
    the input and computes only those of R (recon's output channels), of the
    sigmoid split and of S. The fixed-width trunk (32 to 64 channels), I_low
    and I_delta are computed on every rank (replicated). The collectives sit
    at the three convs that mix all bands:

    * the decomposition's ``conv0`` and ``shallow_conv`` read every band of
      x: x's bands are gathered once (``all_gather``, C bands of H*W) and
      both run on the whole input, so the shallow conv keeps its CUDA kernel
      (the kernel takes 64 input channels only; JAX's ``pallas_call``, which
      GSPMD cannot partition, runs on the whole input too);
    * recon emits this rank's C/n bands of R plus the illumination channel
      (its weight's and bias's rows), no collective;
    * the illumination ``conv0`` on concat(R, I) is summed from partial
      products: each rank convolves its R bands with its slice of the
      weight's input channels, rank 0 adds I's channel and the bias once,
      and one ``all_reduce`` sums the 64-channel output before the trunk.

    R and S are gathered (``all_gather``) so that rank 0 holds them whole to
    save and score (JAX replicates its outputs for its single writer); I_low
    and I_delta are replicated already. H and W are edge-padded to a
    multiple of 8, as JAX's. Without a process group (a 1-process mesh) it
    is the whole forward.
    """

    def __init__(self, model: torch.nn.Module, mesh, band_axis: str = "data"):
        n = mesh.shape[band_axis]
        if model.input_channels % n != 0:
            raise ValueError(
                f"band sharding needs channels ({model.input_channels}) divisible "
                f"by the '{band_axis}' mesh axis ({n}); use the spatial "
                "ShardedInferencer (eval_shard_mode: spatial)")
        super().__init__(model, pad_multiple=8)
        axis = mesh.shard(band_axis)
        per = model.input_channels // n
        self.bands = slice(axis.index * per, (axis.index + 1) * per)
        self.rank, self.group = axis.index, axis.group

    def _forward(self, x: torch.Tensor):
        """This rank's bands (B, H, W, C/n) → (R, I_low, I_delta, S), NHWC,
        R and S with every band."""
        m, bands = self.model, self.bands
        dn, il = m.decomposition_net, m.illum_adjust_net
        c_all = m.input_channels
        own = list(range(bands.start, bands.stop))
        x = distributed.all_gather_cat(x, 3, self.group).permute(0, 3, 1, 2)
        recon_conv = dn.recon
        recon = at_least_float32(recon_conv.conv_with(
            dn.features(x), recon_conv.weight[own + [c_all]], recon_conv.bias[own + [c_all]]))
        R = torch.sigmoid(recon[:, :len(own)])
        L = torch.sigmoid(recon[:, len(own):])
        conv0 = il.conv0[0]
        w = conv0.weight
        if self.rank == 0:
            part = conv0.conv_with(torch.cat([R, L], dim=1),
                                   torch.cat([w[:, own], w[:, c_all:]], dim=1), conv0.bias)
        else:
            part = conv0.conv_with(R, w[:, own], None)
        # Summed in float32 at least, whatever the compute dtype.
        I_delta = il.adjust(distributed.all_sum_(part.float(), self.group).to(part.dtype))
        S = R * I_delta + R * L
        R, L, I_delta, S = (t.permute(0, 2, 3, 1) for t in (R, L, I_delta, S))
        return (distributed.all_gather_cat(R, 3, self.group), L, I_delta,
                distributed.all_gather_cat(S, 3, self.group))

    def batched(self, stack, weights: Optional[Dict[str, torch.Tensor]] = None):
        """(N, H, W, C) stack of same-shape cubes in one band-sharded forward;
        only this rank's bands are uploaded."""
        if weights is not None:
            raise ValueError("BandShardedInferencer runs the model's own weights")
        with torch.inference_mode(), sharded(self.model, None):
            x = torch.as_tensor(stack, dtype=torch.float32)[..., self.bands]
            return pad_forward_crop_batch(self._forward, x.contiguous().to(self.device), 8, 8)


def _make_inferencer(model: torch.nn.Module, cfg: Config, mesh=None) -> Inferencer:
    """Inferencer selection for eval/test (JAX ``_make_inferencer``):
    ``eval_sharded: true`` with a mesh → :class:`BandShardedInferencer` for
    ``eval_shard_mode: band``, else :class:`ShardedInferencer`; without, the
    one-device forward. Opt-in, as in JAX: the pad to a multiple of 8 (8·n
    in height) perturbs every output pixel of a cube whose H or W it pads,
    through the global attention."""
    if mesh is not None and cfg.eval_sharded:
        if cfg.eval_shard_mode == "band":
            return BandShardedInferencer(model, mesh, cfg.data_axis)
        return ShardedInferencer(model, mesh, cfg.data_axis)
    return Inferencer(model, cfg.eval_pad_multiple)


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
            # C order whatever the store's arrays (loadmat's are Fortran-ordered),
            # so that a cube gives the same S from a .mat file and an ENVI pair.
            stack = np.ascontiguousarray(np.stack([store[i] for i in chunk]))
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
    # Under a mesh every rank runs a sharded eval's forward (a collective);
    # rank 0 alone saves and scores. An eval that is not sharded reaches
    # here on rank 0 only (Trainer.fit).
    is_writer = distributed.rank() == 0
    if is_writer:
        print(f"--- Running evaluation for epoch {epoch} ---")
    cfg = trainer.cfg
    epoch_dir = os.path.join(eval_result_dir, f"epoch_{epoch}")
    if is_writer:
        os.makedirs(epoch_dir, exist_ok=True)
    infer = _make_inferencer(trainer.model, cfg, getattr(trainer, "mesh", None))
    from_memory = cfg.eval_metric_source != "disk"
    persistent = getattr(trainer, "eval_saver", None)
    saver = persistent if persistent is not None else _OverlappedSaver()
    per_file: Dict[str, tuple] = {}
    with contextlib.nullcontext() if persistent is not None else saver:
        for idx, R, I, Id, S, _sec in _inference_stream(infer, eval_store, cfg.eval_batch):
            if not is_writer:
                continue
            filename = os.path.basename(eval_store.files[idx])
            if from_memory and label_dir:
                sc = _score_in_memory(filename, S, cfg, label_dir)
                if sc is not None:
                    per_file[filename] = sc
            saver.submit(_save_outputs, cfg, epoch_dir, filename, S, R, I, Id, _ready_event(S))
    scores = None
    if not is_writer:
        return None
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
               save_dir: str, timings: Optional[Dict[str, float]] = None, mesh=None) -> float:
    """Test phase (reference model.py:406-443): load the latest checkpoint,
    run every cube timed, save the outputs on the background saver (outside
    the timed window). Returns the mean seconds a cube;
    ``timings``, when given, receives each file's seconds. Under a mesh
    every rank loads the checkpoint and runs the forward (band-sharded with
    ``eval_sharded``); rank 0 alone saves (JAX's single writer)."""
    interop.load_checkpoint(checkpoints.latest_path(model_dir), model)
    is_writer = distributed.rank() == 0
    if is_writer:
        os.makedirs(save_dir, exist_ok=True)
    infer = _make_inferencer(model, cfg, mesh)
    total = 0.0
    with _OverlappedSaver() as saver:
        for idx, R, I, Id, S, run_time in _inference_stream(infer, test_store, cfg.eval_batch,
                                                            timed=True):
            filename = os.path.basename(test_store.files[idx])
            print(f"Processing {filename}")
            total += run_time
            if timings is not None:
                timings[filename] = run_time
            if is_writer:
                saver.submit(_save_outputs, cfg, save_dir, filename, S, R, I, Id,
                             _ready_event(S))
            print(f"Processed {filename} in {run_time:.4f} seconds.")
    n = len(test_store)
    avg = total / n if n else 0.0
    print(f"Average run time: {avg:.4f} seconds.")
    return avg
