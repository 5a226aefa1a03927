#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``sshslie_torch`` (and nothing of the JAX package) through its main
paths at the stock configuration's full width: 64 bands, channel 64, the
TransformerBlock, random weights from a seed; float32 with TF32 off,
``matmul_precision: tensorfloat32`` (TF32 on the card), and ``precision:
bfloat16``.

1. Card: prints the card's name and power limit, sets both TF32 switches off
   (``device.set_matmul_precision``); every float32 path runs with them off.
2. Kernels: builds every ``sshslie_torch/csrc/*.cu`` with nvcc (in parallel).
3. Inputs: a synthetic dataset in a temporary directory (raw values
   238..4095, numpy seed): four 512x512x64 training cubes, sixteen
   256x256x64 training cubes for the bfloat16 run, two 512x512x64 test cubes
   with their ground truth (also the eval set), and a
   ``model_epoch_latest.pth`` of seeded weights for the test phases.
4. Main path, float32 test phase: ``runner.main`` with ``phase: test``. The
   launch counts are set to 0 just before and read just after; conv9 and
   flash must have launched in float32. The saved S cubes must be finite and
   of the right shape, PSNR, SSIM and SAM finite.
5. Main path, float32 training: ``runner.main`` with ``phase:
   train_and_test`` and the stock ``config/config.yml`` values (batch 2,
   128^2 patches, start_lr 1e-3, the six loss weights and both alphas,
   ``fused_pipeline: auto``, which takes the fused pipeline on these
   same-shape cubes), ``epoch: 2`` and ``eval_every_epoch: 1``: 4 steps, 2
   evals, then the test phase from the checkpoint the run wrote; with
   cuDNN's deterministic algorithms, so that path 9 (a) repeats it bit for bit. conv9 at
   least 3 a step (2 forwards, 1 input gradient) plus one a cube evaluated
   or tested, conv9_wgrad exactly 2 a step, flash at least once, all
   float32. Every epoch's 7 average terms finite; model_epoch_1/2/latest.pth
   with a non-empty optimizer state; the test phase's S cubes and scores
   finite.
5b. Main path, the rest of the stock train_and_test run: ``runner.main`` as
   in 5 with ``epoch: 3``, ``eval_every_epoch: 1``, ``plot_every_epoch: 1``,
   ``use_mlflow``, ``async_eval``, ``checkpoint_best``, ``checkpoint_async``,
   ``checkpoint_keep: 2`` and ``profile_dir``. Launch counts exact (conv9 3 a
   step plus 1 a cube evaluated or tested, conv9_wgrad 2 a step, flash 1 a
   cube, all float32); the three evals ran on the ``async-eval`` thread on a
   side stream and score, within 1e-6, as a synchronous re-eval of the same
   weights (``model_epoch_N.pth`` where it is still on disk), which scores
   the same from the saved files (``eval_metric_source: disk``);
   ``model_epoch_best.pth`` is the best-PSNR epoch's file; ``runs/<run>/``
   holds the run params, 3 x 8 epoch metrics, PSNR_dB/SSIM/SAM, the model
   summary and the console log; the trace file parses (its top device ops are
   printed when it holds CUDA kernels); the plots exist when matplotlib
   imports. Then SIGTERM, under ``torch.backends.cudnn.deterministic``: a
   50-epoch ``train`` run signalled after epoch 1 stops with
   ``model_epoch_latest.pth`` at epoch 1, and resumed to epoch 3 its epoch
   terms equal an uninterrupted 3-epoch run's bit for bit.
6. Main path, bfloat16 test phase: as 4 with ``precision: bfloat16``; the
   bfloat16 conv9 and flash entries must have launched, and no float32 one.
6b. Main path, serving (``serve.build_server_from_config``, real HTTP on
   127.0.0.1, port 0), on the test phases' 512^2 cubes and checkpoints; the
   launch counts are set to 0 before each request and read after it, conv9
   and flash exactly once a request in its dtype. (a) float32,
   ``serve_pad_multiple: 64``, warmed at 512^2 and 1024^2: a .mat request
   whose S equals the test phase's within 1e-5 of (max - min); a ragged
   500x460 request; a 1000x1000 u16 request (bucket 1024^2, flash at S =
   16384); a u16 body decoded on the card, equal to the host path; bf16, u16
   (the card's codes, within 1 LSB of a host re-quantization) and
   ``artifacts=1`` responses; ``/metrics`` with 0 errors; a dimension bomb and
   a deflate bomb answered 4xx, then a valid request. (e) ``/reload`` to a
   second seeded checkpoint with ``X-Reload-Token`` (a wrong token 403): S
   equals that checkpoint's test-phase S within 1e-5 of (max - min). (b)
   ``serve_max_batch: 4``, ``serve_batch_window_ms: 50``: four concurrent
   512^2 requests coalesce (fewer launches than requests) and each S equals
   its single request's within 1e-5 of (max - min). (c) ``precision:
   bfloat16``: the bfloat16 entries only, at 512^2 and 1024^2. (d)
   ``serve_quantize`` int8, fp8, int4: the kernels run the dequantized
   weights; S on the card equals the CPU's with the same quantized weights
   within 1e-4 on a 64^2 cube; PSNR against the float32 S at 512^2 (int8 at
   least int4's); then ``quantization_impact`` int4 with output calibration
   on one 256^2 cube. Times: X-Inference-Seconds (median of 5) and its
   upload and forward apart; the host round trip of each wire encoding,
   split by stage (the handler's decode, normalise, fetch and encode timed
   where it calls them, the client's encode and decode, HTTP and the rest
   by subtraction); SUSTAIN_CLIENTS closed-loop clients for SUSTAIN_S
   seconds (u16 in and out) on the float32 service and on the
   micro-batched one, launches counted: requests/s, p50/p90/max latency.
6c. Main path, ``matmul_precision: tensorfloat32``: ``runner.main`` test
   phase on the float32 test phase's cubes and checkpoint, ``train_and_test``
   as in 5 (2 epochs of 2 steps, the fused pipeline), and one 512^2 request
   to a service built with the key (``serve.build_server_from_config``).
   Launch counts exact by (pass, "tf32", shape), flash in float32, nothing
   else; both switches on at every whole-model forward of the path (a global
   forward pre-hook) and after each entry point, off again after the path.
   S against a float64 forward within TF32_S_REL of max|S| (the float32 S
   beside it); the TF32 S against the float32 test phase's S reported; the
   served S equals the TF32 test phase's within 1e-3 of max|S| (TF32's
   rounding level: the two normalise the input in other ways).
7. Main path, bfloat16 training at bench.py's "best" shape: b8 x 128^2 x 64,
   ``precision: bfloat16``, ``fused_pipeline: on``, ``steps_per_dispatch:
   2`` on the sixteen 256^2 cubes (one 2-step chunk an epoch), 2 epochs with
   an eval each, then the bfloat16 test phase from its checkpoint. The
   bfloat16 conv9 (forward and input gradient) and conv9_wgrad entries as in
   5, flash in the evals and the test; terms finite; checkpoints with the
   optimizer state.
   Then the CLI's parser (``config.parse_args``, the flags of ``python -m
   sshslie_torch``) with the stock values as flags: ``--precision bfloat16
   --grad_accum_steps 2 --fused_pipeline off`` (host pipeline, 2
   micro-batches: 6 conv9 and 4 conv9_wgrad launches a step; its console
   log's "Patch sampler:" line must name NativePatchSampler: ``sampler:
   auto`` takes the native sampler, as in JAX), ``--remat
   true --fused_pipeline on --steps_per_dispatch 2`` (5 conv9 launches a
   step: 2 recomputed forwards), and ``--phase test --precision bfloat16``
   from the first one's checkpoint.
7b. Main path 8, the disk-backed data path: the four training cubes, the
   two test cubes and their ground truth written again as ENVI pairs (BSQ,
   float32, ``utils/io_envi.py::save_envi``). (a) ``train_and_test`` as in 5
   on them with ``data_pattern: "*.hdr"``, ``lazy_loading``,
   ``cube_cache_size: 2`` and ``fused_window: 2``: the windowed fused
   pipeline, epoch 0 on cubes {0, 1} and epoch 1 on {2, 3}, each read from
   disk once (the lazy store's loads recorded), launches exact as in 5; (b)
   the same training on the ``.mat`` cubes in RAM (``phase: train``): epoch
   terms and weights equal (a)'s bit for bit, with cuDNN's deterministic
   algorithms; (c) ``fused_window: auto`` on the lazy store resolves to 3 of
   4 (its console line); (d) the host pipeline on the lazy store: ``sampler:
   auto`` takes PatchSampler, batches through the ``Prefetcher``
   (``prefetch_batches: 2``), terms equal the in-RAM ``sampler: python``
   run's bit for bit; (e) the test phase on the ENVI test cubes: S equals
   a ``.mat`` test phase's run beside it within 1e-6 of its span; (f) ``python -m
   sshslie_torch.doctor`` on path 2's values in a subprocess: exit 0, the
   device row names the card, the kernel build row PASS. In path 6b, (g):
   one request through ``sshslie_torch.serve_client`` (its ``main``), S
   equal to the service's direct ``enhance`` within 1e-5 of the span,
   launches counted as the other requests'.
7c. Main path 9, data parallelism on one card (``parallel/``), three
   processes at once, each reporting its launches by shape: (a) path 2's
   run through the CLI under ``torchrun --standalone --nproc_per_node 1``
   with ``--mesh_shape 1``, an NCCL group of one (``chip_smoke.py
   --cli-worker``: ``runner.main(parse_args(argv))`` with cuDNN's
   deterministic algorithms, as path 2 runs): epoch terms, launches by shape
   and saved S equal path 2's bit for bit (a one-rank ``all_reduce`` is the
   identity); (b) two gloo ranks sharing the card on CUDA tensors
   (``--rank-worker``, ``initialize_distributed(backend="gloo")``, ``device:
   cuda:0``): two fused data-parallel steps at global batch 2, b = 1 a rank
   (conv9 (1, 128, 128, 64) forward 2 and dgrad 1, conv9_wgrad 2 a step on
   each rank, exact), the ranks' terms equal, and step 1's terms and
   gradients within PERF.md's float32 step gates of a one-process b2 step;
   (c) the band-sharded test phase (``mesh_shape: "2"``, ``eval_sharded``,
   ``eval_shard_mode: band``) on the two 512^2 cubes through ``runner.main``
   on both ranks: conv9 (1, 512, 512, 64) and flash (1, 4, 4096, 16) once a
   cube on each rank, exact; rank 0 alone scores and saves, its S within
   1e-5 of the span of path 1's; (d) the space axis: two fused dp x sp steps
   on a ``1x2`` mesh (``shard_space`` on the mesh's space shard), each rank
   64 of the 128 rows, conv9 (2, 72, 128, 64) forward 2 and dgrad 1 and
   conv9_wgrad 2 a step on each rank (the shallow conv's kernel on the
   rank's rows plus a 4-row halo each side), exact, with (b)'s checks; (e)
   the height-sharded test phase (``mesh_shape: "2"``, ``eval_sharded``, the
   default ``eval_shard_mode: spatial``) as (c): conv9 (1, 264, 512, 64) and
   flash (1, 4, 4096, 16), the whole gathered sequence, once a cube on each
   rank, exact; (f) serving on the mesh: ``serve.build_server_from_config``
   with ``mesh_shape: "2"`` on the test phase's checkpoint, rank 0 answering
   HTTP on 127.0.0.1 port 0 and rank 1 following: a 512^2 .mat request, a
   ragged 500x460 one (bucket 512^2), a u16 body (decoded on the host on a
   mesh), ``/reload`` with the token to path 6b's second checkpoint and a
   request after it, each S within 1e-5 of the span of path 6b's one-device
   service's S for the same body and weights; five warm 512^2 requests for
   X-Inference-Seconds; then ``shutdown()``, after which rank 1 leaves its
   loop and exits 0. conv9 (1, 264, 512, 64) and flash (1, 4, 4096, 16) once
   a forward on each rank (the warmup, 4 checked and 5 timed requests: 10),
   exact. Two ranks of NCCL need two cards and are not run.
7d. Main path 10, float32 training at 224 bands: eight synthetic 160^2 x 224
   cubes, ``runner.main`` with ``phase: train``, ``channels: 224``, the Li
   et al. indoor recipe's loss weights and StepLR values, b8 x 128^2 on the
   fused pipeline, 2 epochs of one step. Launches exact by shape: the wide
   conv9 forward and conv9_wgrad ((8, 128, 128, 224) -> 64) 2 a step each
   and nothing else on the hand kernels; the shallow conv's input gradient
   on cuDNN once a step (``conv9.library_passes``) and no other pass of it
   there; epoch terms finite.
8. Kernels against their plain versions on the card, each dtype with its
   stated tolerance (float32 conv9 and flash also at the micro-batched
   serving shapes (4, 512, 512, 64) and (4, 4, 4096, 16); the float32 conv9
   in each split of its units (``conv9_fwd(..., parts=p)``, p in
   ``F32_PARTS``) at (1, 37, 45, 64) for k = 3, 9 and 13, forward and dgrad,
   every split bit for bit the others, and the b2 batch's forward and dgrad
   in each split, its sample 0 against (1, 128, 128, 64) and its rows 0..67
   against (2, 72, 128, 64), bit for bit; the wide float32 entries (224 ->
   64) at path 10's b8 x 128^2 batch and at (1, 37, 45, 224) for k = 3, 9 and
   13, forward (every split, bit for bit) and weight gradient, and
   ShallowConv's gradients at the wide weights (dx from cuDNN) against
   autograd through the plain version; the split each float32 conv9 row
   of the kernels line runs is printed before it; the bfloat16 conv9, its dgrad and conv9_wgrad also at
   (1, 37, 53, 64) for k = 3, 9 and 13; the bfloat16 flash kernel also
   against the Pallas kernel's float32 p, at S = 4096 and 16384);
   the TF32 entries (``tf32=True``) within 1e-5 of their TF32 plain versions
   and within (2u + u^2 + n 2^-23) conv(|x|, |w|) of a float64 conv, repeats
   bit-identical, at the main paths' shapes and (1, 37, 53, 64) for k = 3, 9,
   13;
   ShallowConv's and FlashAttention's gradients against autograd through
   the plain versions; one whole train step on the kernel
   path against the plain path (``conv_impl: torch``, ``attention_impl:
   dense``) and a float64 step, in float32 (b2), TF32 (b2, the TF32 plain
   path beside it: terms within TF32_TERMS_REL, gradients within
   TF32_GRAD_REL of each scale and TF32_GRAD_L2 together) and bfloat16 (b8);
   the whole model at 512^2 on the kernel path against the plain path in
   both dtypes, and on the card against the CPU on a small cube.
9. The pipelines on the card, with ``torch.backends.cudnn.deterministic``: a
   2-step multistep chunk equals two single fused steps bit for bit; one
   fused step equals the same step on the CPU for the same draw table; one
   step with ``remat: true`` equals the step without it, with 2 more conv9
   launches (the recomputed forwards).
10. Times by CUDA events after warm-up: the warm train step on both paths
   in float32 (b2) and bfloat16 (b8), and the TF32 step against the float32
   one on the kernel path (b2), its megapixel*bands/s, its device time and
   host dispatch apart (the TF32 and float32 steps also traced by kernel
   class, with the names of their cuDNN and cuBLAS kernels), the real loop's
   host clock on the host pipeline (PatchSampler's numpy stream and the
   native sampler, crop and augment split out) and on the fused pipeline;
   each kernel at the main paths' shapes
   in both dtypes (flash attention also at (1, 4, 16384, 16), the S of a
   1024^2 cube, in both dtypes; conv9 and flash at the micro-batched serving
   shapes; the wide conv9 and conv9_wgrad at path 10's), its plain version
   and one library call (cuDNN ``F.conv2d``, ``conv2d_input``, ``conv2d_weight``,
   ``F.scaled_dot_product_attention``, bfloat16 ones for the bfloat16 rows,
   cuDNN's TF32 for the TF32 rows) as a yardstick only; the port never calls
   those.

Prints one JSON line of kernels, then the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. A row's "launches" are the launches
the wrappers counted at its (pass, dtype or "tf32", shape) over the main
paths' reads (4, 5, 5b, 6, 6b, 6c, 7, 7b, 7c, every process of 7c, 7d); a row with
none fails the run. Any failure exits non-zero before
the last line. Needs one CUDA card, nvcc and the repository's files.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
SIZE, BANDS = 512, 64
N_TRAIN = 4
N_TRAIN_BF16, SIZE_BF16 = 16, 256        # the bfloat16 run's training cubes
GLOBAL_MIN, GLOBAL_MAX = 238.0, 4095.0   # config/config.yml
SUSTAIN_CLIENTS, SUSTAIN_S = 4, 15.0     # serving's closed-loop load, on each of two services
WIDE_BANDS, N_WIDE, SIZE_WIDE = 224, 8, 160  # main path 10's cubes: one b8 step an epoch
PEAK_F32_FLOPS = 67e12                   # H100 SXM, float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12                 # H100 SXM, dense bfloat16 on the tensor cores
PEAK_TF32_FLOPS = 495e12                 # H100 SXM, dense TF32 on the tensor cores
PEAK_EXP = 16 * 132 * 1.98e9             # H100 SXM: exponentials, 16 a clock per SM (SFU)
PEAK_BYTES = 3.35e12                     # H100 SXM HBM3
BF16_STEP = 2.0 ** -7                    # one bfloat16 step of a value's magnitude, at most
# The training values of config/config.yml.
STOCK_TRAIN = dict(
    seed_value=41, batch_size=2, patch_size=128, start_lr=1e-3, lr_update_factor=0.1,
    lr_update_period=250, c_loss_reconstruction=10.0, c_loss_r_fidelity=1.0,
    c_loss_i_smooth_low=1.0, c_loss_i_smooth_delta=2000.0, c_loss_fourier=20.0,
    c_loss_spectral_cons=1.0, alpha_i_smooth_low=1.0, alpha_i_smooth_delta=10.0,
    save_reflectance=True, save_illumination=True, precision="float32")
# The Li et al. indoor recipe's values (config/config_indoor_li_et_al_cv1.yml
# upstream) that differ from the stock ones.
LI_TRAIN = dict(c_loss_i_smooth_delta=20.0, c_loss_fourier=0.2, lr_update_factor=1.0,
                lr_update_period=400)


def log(msg: str) -> None:
    print(msg, flush=True)


def switches() -> tuple:
    """(cudnn.allow_tf32, cuda.matmul.allow_tf32)."""
    import torch

    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def check_switches(what: str, tf32: bool) -> None:
    if switches() != (tf32, tf32):
        raise AssertionError(f"{what}: TF32 switches {switches()}, expected both {tf32}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """ms of one ``fn()``: CUDA events around ``reps`` calls. ``queued``: the
    calls are enqueued while the card sleeps (~10 ms), so they run back to
    back and the host's dispatch is not timed (``tools/flash_bench.py``); the
    kernels line times them as the main path runs them, dispatch included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_work(shape, esize: int) -> tuple:
    """(operations, bytes, exponentials) of attention over (B, H, S, D):
    q, k, v read once and o written once, elements of ``esize`` bytes."""
    b, h, s, d = shape
    return 4.0 * b * h * s * s * d, 4.0 * esize * b * h * s * d, float(b * h * s * s)


def bound_ms(work, peak: float) -> tuple:
    """(ms, "operations" or "bytes"): the larger of the operations at ``peak``
    (the float32 FMA pipes; for bfloat16, the tensor cores' rate and the SFU's
    exponentials) and the bytes at the memory rate."""
    flops, nbytes, exps = work
    t_ops = max(flops / peak, exps / PEAK_EXP if peak == PEAK_BF16_FLOPS else 0.0) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_close(what: str, got, want, tol: float) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = float((got.double() - want.double()).abs().max())
    log(f"{what}: max|d| = {err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{what}: max|d| {err:.3e} over tolerance {tol:.1e}")
    return err


def check_rel(what: str, got, want, rel: float) -> float:
    """check_close with a tolerance of ``rel`` times the largest |want|."""
    return check_close(what, got, want, rel * float(want.abs().max()))


def write_inputs(root: str) -> None:
    """Training cubes, test cubes and their ground truth, raw values 238..4095."""
    import numpy as np
    import scipy.io as sio

    rng = np.random.default_rng(SEED)
    for sub in ("low/train", "low/train256", "low/test", "high/test"):
        os.makedirs(os.path.join(root, "data", sub), exist_ok=True)

    def scene(size):
        # A smooth spectral scene under a darkening illumination, plus noise.
        coarse = rng.random((size // 32, size // 32, BANDS), dtype=np.float32)
        smooth = np.kron(coarse, np.ones((32, 32, 1), np.float32))
        illum = np.linspace(0.15, 0.4, size, dtype=np.float32)[:, None, None]
        noise = rng.random((size, size, BANDS), dtype=np.float32)
        high = GLOBAL_MIN + (GLOBAL_MAX - GLOBAL_MIN) * (0.8 * smooth + 0.2 * noise)
        return GLOBAL_MIN + (high - GLOBAL_MIN) * illum, high

    for i in range(2 + N_TRAIN):
        low, high = scene(SIZE)
        if i < 2:
            sio.savemat(os.path.join(root, "data/low/test", f"cube{i}.mat"), {"data": low})
            sio.savemat(os.path.join(root, "data/high/test", f"cube{i}.mat"), {"data": high})
        else:
            sio.savemat(os.path.join(root, "data/low/train", f"train{i - 2}.mat"), {"data": low})
    for i in range(N_TRAIN_BF16):
        sio.savemat(os.path.join(root, "data/low/train256", f"train{i}.mat"),
                    {"data": scene(SIZE_BF16)[0]})


def read_counts(conv9, attention) -> dict:
    """Launches by kernel and dtype: {"conv9": {"float32": n, "bfloat16": m}, ...}."""
    def by_name(wrapper):
        return {str(dt).replace("torch.", ""): n for dt, n in wrapper.launches_by_dtype.items()}

    return {"conv9": by_name(conv9.conv9_fwd), "conv9_wgrad": by_name(conv9.conv9_wgrad),
            "flash_attention": by_name(attention.flash_attention)}


def zero_counts(conv9, attention) -> None:
    conv9.reset_counts()
    attention.reset_counts()


# Main-path launches by (kernel, pass, dtype, shape), as the wrappers count
# them (``launches_by_shape``), summed over every main path's read: each row
# of the kernels line takes its "launches" from here.
MAIN_SHAPES: dict = {}


def shape_counts(conv9, attention) -> dict:
    """The launches counted since the last zero_counts by (kernel, pass,
    dtype or "tf32", shape)."""
    out = {}
    for name, wrapper in (("conv9", conv9.conv9_fwd), ("conv9_wgrad", conv9.conv9_wgrad),
                          ("flash_attention", attention.flash_attention)):
        for (role, dt, shape), n in wrapper.launches_by_shape.items():
            out[(name, role, str(dt).replace("torch.", ""), tuple(shape))] = n
    return out


def tally_shapes(conv9, attention, counts: dict = None) -> None:
    """Add the launches counted since the last zero_counts (or ``counts``,
    another process's shape_counts) to MAIN_SHAPES."""
    for key, n in (shape_counts(conv9, attention) if counts is None else counts).items():
        MAIN_SHAPES[key] = MAIN_SHAPES.get(key, 0) + n


def counts_to_json(counts: dict) -> list:
    return [[*key[:3], list(key[3]), n] for key, n in counts.items()]


def counts_from_json(rows: list) -> dict:
    return {(name, role, label, tuple(shape)): n for name, role, label, shape, n in rows}


def check_launches(what: str, counts: dict, dtype: str, want: dict) -> None:
    """Each kernel's launches under ``dtype`` ("float32", "bfloat16" or "tf32")
    against ``want`` (name -> (min, max)), and none under any other label.
    Under "tf32" flash, which keeps its float32 entry, counts in float32."""
    for name, by in counts.items():
        label = "float32" if dtype == "tf32" and name == "flash_attention" else dtype
        if name in want:
            lo, hi = want[name]
            n = by.get(label, 0)
            if not lo <= n <= hi:
                raise AssertionError(f"{what}: {name} launched {n} times in {label}, expected "
                                     f"{lo}..{hi}")
        if any(n for other, n in by.items() if other != label):
            raise AssertionError(f"{what}: {name} launched outside {label}: {counts}")


def check_by_shape(what: str, conv9, attention, want: dict) -> None:
    """The launches counted since the last zero_counts by (pass, label,
    shape), all three wrappers together, against ``want``."""
    got = {**conv9.conv9_fwd.launches_by_shape, **conv9.conv9_wgrad.launches_by_shape,
           **attention.flash_attention.launches_by_shape}
    if got != want:
        raise AssertionError(f"{what}: launches by shape {got}, expected {want}")
    log(f"{what}: launches by (pass, label, shape) {got}")


def check_saved_s(cfg, load_hsi, np) -> None:
    for i in range(2):
        out = load_hsi(os.path.join(cfg.test_result_dir, f"cube{i}.mat"), mat_key=cfg.mat_key_prediction)
        if out.shape != (SIZE, SIZE, BANDS) or not np.isfinite(out).all():
            raise AssertionError(f"saved S of cube{i}: shape {out.shape}, finite {np.isfinite(out).all()}")
    log(f"saved S cubes under {cfg.test_result_dir}: shape (512, 512, 64), finite")


def check_training(what, trainer, tcfg, result, math, np, torch, load_hsi, LOSS_KEYS) -> None:
    """Epoch terms, eval metrics, checkpoints and the test phase of a train_and_test run."""
    for k in LOSS_KEYS:
        vals = trainer.all_epoch_losses[k]
        log(f"  {k}: {vals}")
        if len(vals) != tcfg.epoch or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{what}: epoch averages of {k}: {vals}")
    log(f"{what}: eval metrics {trainer.eval_metrics}")
    if sorted(trainer.eval_metrics) != list(range(1, tcfg.epoch + 1)) or not all(
            math.isfinite(v) for m in trainer.eval_metrics.values() for v in m.values()):
        raise AssertionError(f"{what}: eval metrics {trainer.eval_metrics}")
    names = [f"model_epoch_{e}.pth" for e in range(1, tcfg.epoch + 1)] + ["model_epoch_latest.pth"]
    for name in names:
        ck = torch.load(os.path.join(tcfg.test_model_dir, name), map_location="cpu",
                        weights_only=True)
        if not ck["optimizer_state_dict"]["state"]:
            raise AssertionError(f"{what}: {name}: empty optimizer state")
    log(f"{what}: checkpoints {', '.join(names)} hold the optimizer state")
    tscores = result["scores"]
    log(f"{what}: PSNR {tscores[0]!r}  SSIM {tscores[1]!r}  SAM {tscores[2]!r}")
    if not all(math.isfinite(s) for s in tscores):
        raise AssertionError(f"{what}: non-finite scores {tscores}")
    check_saved_s(tcfg, load_hsi, np)


def grad_errors(params, ref, lr, sd, rel_floor=1e-8):
    """Per-parameter errors of a train step against a float64 step's gradients:
    worst max|dg| over each gradient's scale, the L2 error of all gradients
    together and the worst per-parameter L2 error over parameters whose
    gradient norm is at least 1e-3 of the largest, both relative to the
    float64 norm; and the parameters' distance from Adam's first step on
    their own gradient, in units of lr."""
    import torch

    gmax = max(float(p.grad.abs().max()) for p in ref.values())
    top = max(float(p.grad.norm()) for p in ref.values())
    out = {"max": 0.0, "l2_worst": 0.0, "formula": 0.0}
    diff2 = ref2 = 0.0
    for n, p in params.items():
        g64, g = ref[n].grad, p.grad.double()
        denom = max(float(g64.abs().max()), rel_floor * gmax)
        out["max"] = max(out["max"], float((g - g64).abs().max()) / denom)
        d2, r2 = float((g - g64).norm()) ** 2, float(g64.norm()) ** 2
        diff2, ref2 = diff2 + d2, ref2 + r2
        if r2 ** 0.5 >= 1e-3 * top:
            out["l2_worst"] = max(out["l2_worst"], (d2 / r2) ** 0.5)
        step = sd[n] - lr * p.grad / (p.grad.abs() + 1e-8)
        out["formula"] = max(out["formula"], float((p.detach() - step).abs().max()) / lr)
    out["l2_all"] = (diff2 / ref2) ** 0.5
    return out


# Kernel classes of a trace, by name: the first pattern found in the name wins.
KERNEL_CLASSES = (
    ("hand kernels (conv9, conv9_wgrad, flash)", ("conv_c64", "wide_f32", "wgrad_c64", "wgrad_reduce",
                                                  "flash_")),
    ("FFT (cuFFT)", ("fft", "FFT")),
    ("Adam (foreach)", ("multi_tensor_apply", "foreach")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "index", "Memcpy", "Memset")),
    ("convolutions (cuDNN)", ("cudnn", "xmma_fprop", "xmma_dgrad", "xmma_wgrad", "implicit_gemm",
                              "wgrad_alg", "dgrad_", "conv")),
    ("matrix products (cuBLAS)", ("gemm", "cublas", "Kernel2")),
)


def kernel_class(name: str) -> str:
    """The class of a CUDA kernel, by its name (KERNEL_CLASSES)."""
    return next((c for c, pats in KERNEL_CLASSES if any(p in name for p in pats)), "other")


def trace_device_ops(path: str, top: int = 10) -> tuple:
    """The CUDA kernels of a Chrome trace: ([(name, total ms, count)] of the
    ``top`` largest by total time, {class: total ms} over all of them, their
    total ms); ([], {}, 0.0) when it holds none."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    totals: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            ms, n = totals.get(e["name"], (0.0, 0))
            totals[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    classes: dict = {}
    for name, (ms, _) in totals.items():
        cls = kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + ms
    rows = sorted(((k, ms, n) for k, (ms, n) in totals.items()), key=lambda r: -r[1])
    return rows[:top], classes, sum(ms for _, ms, _ in rows)


def run_engine(train_kw: dict, common: dict) -> dict:
    """Main path 5b: ``runner.main`` on ``train_and_test`` with the engine keys
    on, its checks, then the SIGTERM runs. Returns the first run's launch counts."""
    import builtins
    import signal
    import threading
    import types

    import torch

    from sshslie_torch import checkpoints, evaluate, interop, runner
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore
    from sshslie_torch.models.enhance import build_model
    from sshslie_torch.ops import attention, conv9

    t0 = time.perf_counter()
    ecfg = load_config(None, {**train_kw, "train_data": "./data/low/train",
                              "model_name": "chip_smoke_engine", "epoch": 3,
                              "eval_every_epoch": 1, "plot_every_epoch": 1, "use_mlflow": True,
                              "async_eval": True, "checkpoint_best": True,
                              "checkpoint_async": True, "checkpoint_keep": 2,
                              "profile_dir": "./profile"})
    steps = ecfg.epoch * (len(os.listdir(ecfg.train_data)) // ecfg.batch_size)
    cubes_run = 2 * ecfg.epoch + 2            # eval cubes at each epoch, then the test cubes
    evals = {}
    sync_evaluate = evaluate.evaluate_model

    def recording_evaluator(view, eval_store, out_dir, epoch, label_dir):
        side = torch.cuda.current_stream().cuda_stream != torch.cuda.default_stream().cuda_stream
        weights = {k: v.detach().to("cpu", copy=True) for k, v in view.model.state_dict().items()}
        scores = sync_evaluate(view, eval_store, out_dir, epoch, label_dir)
        evals[epoch] = (threading.current_thread().name, side, weights, scores)
        return scores

    evaluate.evaluate_model = recording_evaluator     # runner.run_train imports it at call time
    try:
        zero_counts(conv9, attention)
        t = time.perf_counter()
        result = runner.main(ecfg)
        torch.cuda.synchronize()
        counts = read_counts(conv9, attention)
        tally_shapes(conv9, attention)
    finally:
        evaluate.evaluate_model = sync_evaluate
    trainer = result["trainer"]
    log(f"main path (float32 engine run): {time.perf_counter() - t:.2f} s; {steps} steps on the "
        f"{trainer.pipeline} pipeline; launches {counts}; eval metrics {trainer.eval_metrics}")
    check_launches("float32 engine run", counts, "float32", {
        "conv9": (3 * steps + cubes_run,) * 2, "conv9_wgrad": (2 * steps,) * 2,
        "flash_attention": (cubes_run,) * 2})
    if sorted(evals) != [1, 2, 3] or sorted(trainer.eval_metrics) != [1, 2, 3]:
        raise AssertionError(f"engine run: evals {sorted(evals)}, recorded {trainer.eval_metrics}")
    for ep, (thread, side, _, scores) in evals.items():
        if not (thread.startswith("async-eval") and side) or scores != trainer.eval_metrics[ep]:
            raise AssertionError(f"engine run: eval {ep} on thread {thread!r}, side stream {side}")
    log("engine run: the three evals ran on the async-eval thread, on a side stream")

    # The async scores against synchronous re-evals of the same weights, from
    # memory and from the saved files. Epoch files pruned by checkpoint_keep
    # are re-evaluated from the weights the worker evaluated.
    ckdir = ecfg.test_model_dir
    on_disk = sorted(int(n[len("model_epoch_"):-4]) for n in os.listdir(ckdir)
                     if n[len("model_epoch_"):-4].isdigit())
    if on_disk != [2, 3]:
        raise AssertionError(f"engine run: epoch files on disk {on_disk} (checkpoint_keep 2)")
    store = CubeStore(ecfg.eval_data, normalization=ecfg.normalization,
                      global_min=ecfg.global_min, global_max=ecfg.global_max)
    worst = {"async_vs_sync": 0.0, "disk_vs_memory": 0.0}
    for ep in (1, 2, 3):
        model = build_model(ecfg, ecfg.channels)
        if ep in on_disk:
            interop.load_checkpoint(checkpoints.epoch_path(ckdir, ep), model)
            if any(not torch.equal(v.cpu(), evals[ep][2][k]) for k, v in model.state_dict().items()):
                raise AssertionError(f"engine run: model_epoch_{ep}.pth differs from the weights "
                                     "the async eval took")
        else:
            model.load_state_dict(evals[ep][2])
        got = {}
        for source in ("memory", "disk"):
            view = types.SimpleNamespace(model=model, cfg=load_config(None, {
                **common, "eval_metric_source": source, "phase": "train"}))
            got[source] = sync_evaluate(view, store, f"./reeval_{source}", ep, ecfg.label_dir)
        for key, want in trainer.eval_metrics[ep].items():
            worst["async_vs_sync"] = max(worst["async_vs_sync"], abs(got["memory"][key] - want))
            worst["disk_vs_memory"] = max(worst["disk_vs_memory"],
                                          abs(got["disk"][key] - got["memory"][key]))
    log(f"engine run: async eval vs a synchronous re-eval (epochs 2, 3 from model_epoch_N.pth, "
        f"epoch 1 from the evaluated weights) max|d| {worst['async_vs_sync']:.3e}; "
        f"eval_metric_source disk vs memory max|d| {worst['disk_vs_memory']:.3e} (tolerance 1e-6)")
    if not (worst["async_vs_sync"] <= 1e-6 and worst["disk_vs_memory"] <= 1e-6):
        raise AssertionError(f"engine run: re-eval differs: {worst}")

    # model_epoch_best: the best PSNR among the files still on disk and the
    # epoch it holds (a winner copied before its prune stays the best).
    best_file = checkpoints.best_path(ckdir)
    best_ep = torch.load(best_file, map_location="cpu", weights_only=True)["epoch"]
    psnr = {ep: m["psnr"] for ep, m in trainer.eval_metrics.items()}
    want_ep = max(set(on_disk) | {best_ep}, key=psnr.get)
    if best_ep != want_ep:
        raise AssertionError(f"engine run: model_epoch_best holds epoch {best_ep}, PSNR {psnr}")
    if best_ep in on_disk:
        with open(best_file, "rb") as fa, open(checkpoints.epoch_path(ckdir, best_ep), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"engine run: model_epoch_best != model_epoch_{best_ep}")
    log(f"engine run: model_epoch_best.pth is epoch {best_ep} (PSNR by epoch {psnr}; on disk "
        f"{on_disk}){', byte-equal to its file' if best_ep in on_disk else ''}")

    # runs/<experiment>/: params, 3 x 8 epoch metrics, the test scores, artifacts.
    rdir = os.path.join("runs", ecfg.full_model_name)
    with open(os.path.join(rdir, "params.json")) as fh:
        params = json.load(fh)
    with open(os.path.join(rdir, "metrics.jsonl")) as fh:
        metrics = [json.loads(line) for line in fh]
    want_params = {"phase", "data_min", "data_max", "seed", "patch_size", "model_name",
                   "c_loss_reconstruction", "alpha_i_smooth_delta", "data_train", "data_test",
                   "epochs", "start_lr", "adaptive_lr", "batch_size", "optimizer", "model_path"}
    per_epoch = [sum(len(m) - 1 for m in metrics if m["step"] == e) for e in range(ecfg.epoch)]
    tested = {k for m in metrics if m["step"] is None for k in m if k != "step"}
    arts = os.path.join(rdir, "artifacts")
    logs = os.listdir(os.path.join(arts, "run_logs"))
    if (not want_params <= set(params) or per_epoch != [8] * ecfg.epoch
            or tested != {"PSNR_dB", "SSIM", "SAM"}
            or not os.path.exists(os.path.join(arts, "model_summary.txt"))
            or logs != [f"console_output_{ecfg.full_model_name}.log"]):
        raise AssertionError(f"engine run: runs/ holds params {sorted(params)}, metrics a step "
                             f"{per_epoch}, test metrics {tested}, artifacts {os.listdir(arts)}")
    log(f"engine run: {rdir} holds {len(params)} params, {len(metrics)} metric lines (8 an epoch, "
        f"then PSNR_dB/SSIM/SAM), artifacts {sorted(os.listdir(arts))}")

    traces = [os.path.join("profile", n) for n in os.listdir("profile") if n.endswith(".json")]
    if len(traces) != 1:
        raise AssertionError(f"engine run: traces {traces}")
    top, classes, total_ms = trace_device_ops(traces[0])
    log(f"engine run: trace {traces[0]} ({os.path.getsize(traces[0])} bytes) parses; CUDA kernel "
        f"events: {'yes' if top else 'none'}")
    if top:
        steps_traced = len(os.listdir(ecfg.train_data)) // ecfg.batch_size
        log(f"  kernels of the traced first epoch ({steps_traced} steps, its checkpoint, the start "
            f"of its async eval): {total_ms:.3f} ms in all")
        for cls, ms in sorted(classes.items(), key=lambda r: -r[1]):
            log(f"  class {ms:9.3f} ms {100 * ms / total_ms:5.1f}%  {cls}")
    for name, ms, n in top:
        log(f"  device op {ms:9.3f} ms {n:5d}x  {name[:140]}")
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    plots = sorted(n for n in os.listdir(ecfg.eval_result_dir) if n.endswith(".png"))
    if have_mpl and plots != ["eval_metrics.png", "loss_curves.png"]:
        raise AssertionError(f"engine run: plots {plots}")
    log(f"engine run: matplotlib {'imports' if have_mpl else 'does not import'} on this machine; "
        f"plots {plots}")

    # SIGTERM and resume, against an uninterrupted run, on cuDNN's deterministic algorithms.
    torch.backends.cudnn.deterministic = True
    try:
        def train_run(name, **kw):
            cfg = load_config(None, {**train_kw, "train_data": "./data/low/train", "phase": "train",
                                     "eval_every_epoch": 100, "model_name": name, **kw})
            return cfg, runner.main(cfg)["trainer"]

        _, straight = train_run("chip_smoke_straight", epoch=3)
        fired = []
        orig_print = builtins.print

        def hooked(*args, **kw):
            orig_print(*args, **kw)
            if not fired and args and str(args[0]).startswith("Epoch [1/50] Average Loss"):
                fired.append(True)
                os.kill(os.getpid(), signal.SIGTERM)

        builtins.print = hooked
        try:
            scfg, stopped = train_run("chip_smoke_sigterm", epoch=50)
        finally:
            builtins.print = orig_print
        latest = torch.load(checkpoints.latest_path(scfg.test_model_dir), map_location="cpu",
                            weights_only=True)
        if not fired or len(stopped.all_epoch_losses["total_loss"]) != 1 or latest["epoch"] != 1 \
                or not latest["optimizer_state_dict"]["state"] \
                or signal.getsignal(signal.SIGTERM) != signal.SIG_DFL:
            raise AssertionError(f"SIGTERM run: {len(stopped.all_epoch_losses['total_loss'])} "
                                 f"epochs, latest at epoch {latest['epoch']}")
        _, resumed = train_run("chip_smoke_sigterm", epoch=3, resume=True,
                               test_timestamp=scfg.timestamp)
        same = all(stopped.all_epoch_losses[k] + resumed.all_epoch_losses[k]
                   == straight.all_epoch_losses[k] for k in straight.all_epoch_losses)
        log(f"SIGTERM after epoch 1 of 50: stopped with model_epoch_latest.pth at epoch 1; resumed "
            f"to epoch 3, epoch terms equal the uninterrupted run's bit for bit: {same} (total "
            f"{stopped.all_epoch_losses['total_loss'] + resumed.all_epoch_losses['total_loss']} vs "
            f"{straight.all_epoch_losses['total_loss']})")
        if not same:
            raise AssertionError("the run resumed after SIGTERM differs from the uninterrupted run")
    finally:
        torch.backends.cudnn.deterministic = False
    # Host I/O that the background writers take off the training thread: an
    # epoch checkpoint (the host copy stays on the training thread) and one
    # eval cube's outputs (S, R_low, I_low), host clock, 3 repeats each.
    from sshslie_torch.train import host_copy

    io = {"host copy": [], "checkpoint write": [], "cube save": []}
    model, opt = trainer.model, trainer.optimizer
    infer = evaluate.Inferencer(model)
    R, I, Id, S = (t[0] for t in infer.batched(store[0][None]))
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sd, od = host_copy(model.state_dict()), host_copy(opt.state_dict())
        io["host copy"].append(time.perf_counter() - t)
        t = time.perf_counter()
        saved = interop.save_checkpoint(f"./io_{i}.pth", sd, 3, od)
        checkpoints.copy_checkpoint(saved, f"./io_{i}_latest.pth")
        io["checkpoint write"].append(time.perf_counter() - t)
        t = time.perf_counter()
        evaluate._save_outputs(ecfg, f"./io_{i}", "cube0.mat", S, R, I, Id,
                               evaluate._ready_event(S))
        io["cube save"].append(time.perf_counter() - t)
    log(f"host I/O, ms: {', '.join(f'{k} {[round(v * 1e3, 2) for v in vs]}' for k, vs in io.items())}"
        f"; checkpoint {os.path.getsize('./io_0.pth')} bytes; one 512^2x64 cube's S, R_low, "
        f"I_low {sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk('./io_0') for f in fs)}"
        " bytes")
    log(f"main path 5b (engine run, re-evals, SIGTERM runs, host I/O): "
        f"{time.perf_counter() - t0:.2f} s")
    return counts


def _http(srv, method: str, path: str, body: bytes = None, headers: dict = None) -> tuple:
    """One request to a running server → (status, response headers, body)."""
    import http.client

    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


def _median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def run_serving(cfg, bcfg, test_kw: dict, card: str) -> dict:
    """Main path 6b: the serving path (``serve.build_server_from_config``, its
    HTTP server on 127.0.0.1, port 0) on the float32 test phase's cubes and
    checkpoint. Launch counts are set to 0 before each request and read after
    it. Returns the serving launches by kernel and dtype, plus the launches at
    the shapes only serving gives the kernels."""
    import concurrent.futures as cf
    import threading
    import zlib

    import numpy as np
    import scipy.io as sio
    import torch

    from sshslie_torch import checkpoints, interop, metrics, runner, serve
    from sshslie_torch.config import load_config
    from sshslie_torch.models.enhance import LowLightEnhanceNet, build_model
    from sshslie_torch.ops import attention, conv9, quant
    from sshslie_torch.utils.io_hsi import load_hsi, normalize_like_load

    t0 = time.perf_counter()
    span = GLOBAL_MAX - GLOBAL_MIN
    tol = 1e-5 * span                       # 1e-5 on the normalised scale
    token = "chip-smoke-reload-token"
    serve_kw = dict(test_kw, phase="serve", serve_port=0, serve_pad_multiple=64,
                    use_mlflow=False)
    total = {k: {} for k in ("conv9", "conv9_wgrad", "flash_attention")}

    def counted(what, dtype, fn, want=1):
        """fn() with the launch counts set to 0 before and read after; conv9
        and flash exactly ``want`` times in ``dtype``, nothing else."""
        zero_counts(conv9, attention)
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts(conv9, attention)
        tally_shapes(conv9, attention)
        check_launches(what, counts, dtype, {"conv9": (want, want), "flash_attention": (want, want),
                                             "conv9_wgrad": (0, 0)})
        for k, by in counts.items():
            for dt, n in by.items():
                total[k][dt] = total[k].get(dt, 0) + n
        return out

    def enhance(srv, body, headers=None, query="", ok=True):
        status, rh, data = _http(srv, "POST", "/enhance" + query, body, headers)
        if ok and status != 200:
            raise AssertionError(f"POST /enhance{query}: HTTP {status}: {data[:300]!r}")
        return status, rh, data

    def f32_body(cube):
        return serve.encode_cube(cube, "f32")

    def s_of(rh, data):
        return serve.decode_cube_response(data, rh, mat_key="data")

    def sustained(what, srv, body, headers, query, batch_sizes=None):
        """Closed-loop load over real HTTP: SUSTAIN_CLIENTS threads, started
        before the timed span, post ``body`` back to back until SUSTAIN_S
        seconds have passed; every request started before then completes.
        Launch counts are set to 0 before and read after: conv9 and flash
        once a forward (a request, or a batch when ``batch_sizes`` records
        the batcher's runs). Returns (requests, span s, sorted latencies s)."""
        lat, errors = [], []
        gate = threading.Barrier(SUSTAIN_CLIENTS + 1)
        stop = [0.0]

        def client():
            gate.wait()
            try:
                while time.perf_counter() < stop[0]:
                    t = time.perf_counter()
                    status, _, data = _http(srv, "POST", "/enhance" + query, body, headers)
                    if status != 200:
                        raise AssertionError(f"{what}: HTTP {status}: {data[:300]!r}")
                    lat.append((t, time.perf_counter()))
            except BaseException as e:  # noqa: BLE001 — raised below, on the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, daemon=True) for _ in range(SUSTAIN_CLIENTS)]
        for th in threads:
            th.start()
        before = len(batch_sizes) if batch_sizes is not None else 0
        zero_counts(conv9, attention)
        start = time.perf_counter()
        stop[0] = start + SUSTAIN_S
        gate.wait()
        for th in threads:
            th.join(timeout=SUSTAIN_S + 300)
        torch.cuda.synchronize()
        counts = read_counts(conv9, attention)
        tally_shapes(conv9, attention)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"{what}: client errors {errors[:3]}")
        runs = len(lat) if batch_sizes is None else len(batch_sizes) - before
        check_launches(what, counts, "float32", {"conv9": (runs, runs),
                                                 "flash_attention": (runs, runs),
                                                 "conv9_wgrad": (0, 0)})
        for k, by in counts.items():
            for dt, n in by.items():
                total[k][dt] = total[k].get(dt, 0) + n
        span = max(end for _, end in lat) - start
        return len(lat), span, sorted(end - t for t, end in lat)

    def load_line(what, n, span, lats, extra=""):
        pct = lambda p: lats[min(len(lats) - 1, int(p * len(lats)))]  # noqa: E731
        log(f"serving times ({card}): {what}, {SUSTAIN_CLIENTS} closed-loop clients for "
            f"{SUSTAIN_S} s: {n} requests in {span!r} s, {n / span!r} requests/s; latency "
            f"p50 {pct(0.5)!r} s, p90 {pct(0.9)!r} s, max {lats[-1]!r} s{extra}")

    def metric(srv, name):
        _, _, text = _http(srv, "GET", "/metrics")
        return float([l for l in text.decode().splitlines() if l.startswith(name + " ")][0].split()[-1])

    cubes = [np.ascontiguousarray(sio.loadmat(os.path.join(cfg.test_data, f"cube{i}.mat"))["data"],
                                  dtype=np.float32) for i in range(2)]
    s_test = load_hsi(os.path.join(cfg.test_result_dir, "cube0.mat"), mat_key=cfg.mat_key_prediction)
    # A 1000^2 cube (bucket 1024^2) and a ragged 500x460 one (bucket 512^2).
    n_big = 2 * SIZE - 24
    big = np.ascontiguousarray(np.pad(cubes[0], ((0, n_big - SIZE),) * 2 + ((0, 0),),
                                      mode="reflect"))
    ragged_hw = (SIZE - 12, SIZE - 52)

    # ---- (a) float32, one request at a time ----
    t = time.perf_counter()
    acfg = load_config(None, {**serve_kw, "model_name": cfg.model_name,
                              "serve_warmup": f"{SIZE}x{SIZE},{2 * SIZE}x{2 * SIZE}",
                              "serve_reload_token": token})
    srv = serve.build_server_from_config(acfg).start()
    svc = srv.service
    n_direct = 0
    try:
        log(f"serving (a): float32 service built and warmed (512^2, 1024^2) in "
            f"{time.perf_counter() - t:.2f} s")
        _, _, health = _http(srv, "GET", "/health")
        health = json.loads(health)
        if health["backend"] != "cuda" or health["channels"] != BANDS:
            raise AssertionError(f"/health: {health}")
        log(f"serving /health: {health}")
        with open(os.path.join(cfg.test_data, "cube0.mat"), "rb") as fh:
            mat_body = fh.read()
        rh, data = counted("serve float32 512^2 .mat", "float32",
                           lambda: enhance(srv, mat_body)[1:])
        s1 = sio.loadmat(io.BytesIO(data))["data"]
        check_close("serving S 512^2 (.mat) vs the test phase's S, raw scale", torch.from_numpy(s1),
                    torch.from_numpy(s_test), tol)
        log(f"  X-Inference-Seconds {rh['X-Inference-Seconds']}")
        # (g) One request through the port's client (``python -m
        # sshslie_torch.serve_client``), against the service's direct enhance.
        from sshslie_torch import serve_client

        out = counted("serve float32 512^2 through serve_client", "float32", lambda: serve_client.main([
            os.path.join(cfg.test_data, "cube0.mat"), "client_s.mat", "--url",
            f"http://{srv.host}:{srv.port}", "--request_encoding", "f32", "--encoding", "f32"]))
        direct = counted("serve float32 512^2 direct enhance", "float32",
                         lambda: svc.enhance(cubes[0])["S"])
        n_direct += 1
        check_close("serve_client S vs the service's direct enhance, raw scale",
                    torch.from_numpy(out["data"]), torch.from_numpy(direct), tol)
        blob, hd = f32_body(cubes[0][:ragged_hw[0], :ragged_hw[1]])
        rh, data = counted("serve float32 500x460 (bucket 512^2)", "float32",
                           lambda: enhance(srv, blob, hd, "?encoding=f32")[1:])
        ragged = s_of(rh, data)
        if ragged.shape != ragged_hw + (BANDS,) or not np.isfinite(ragged).all():
            raise AssertionError(f"ragged request: S {ragged.shape}")
        blob, hd = serve.encode_cube(big, "u16")
        rh, data = counted("serve float32 1000^2 u16 body (bucket 1024^2, flash at S = 16384)",
                           "float32", lambda: enhance(srv, blob, hd, "?encoding=u16")[1:])
        sbig = s_of(rh, data)
        if sbig.shape != (n_big, n_big, BANDS) or not np.isfinite(sbig).all():
            raise AssertionError(f"1000^2 request: S {sbig.shape}")
        # The u16 body takes the device-decode path (one call of the service's
        # u16 decode function), and gives the same S as the host path on the
        # same payload.
        decodes = []
        encoded_fn = svc._encoded_fn

        def counting_encoded_fn(encoding):
            fn = encoded_fn(encoding)

            def decode(*args):
                decodes.append(encoding)
                return fn(*args)
            return decode

        svc._encoded_fn = counting_encoded_fn
        try:
            blob, hd = serve.encode_cube(cubes[0], "u16")
            rh, data = counted("serve float32 512^2 u16 body", "float32",
                               lambda: enhance(srv, blob, hd, "?encoding=f32")[1:])
        finally:
            del svc._encoded_fn
        if decodes != ["u16"]:
            raise AssertionError(f"the u16 request body took the device decode {decodes} times, "
                                 f"expected once")
        host = counted("serve float32 512^2 host decode", "float32",
                       lambda: svc.enhance(serve.decode_cube_response(blob, hd))["S"])
        n_direct += 1
        check_close("serving S, u16 body decoded on the card vs on the host", torch.from_numpy(
            s_of(rh, data)), torch.from_numpy(host), tol)
        # Responses: bf16, u16 (the card's codes), artifacts.
        blob, hd = f32_body(cubes[0])
        rh, data = counted("serve float32 512^2 bf16 response", "float32",
                           lambda: enhance(srv, blob, hd, "?encoding=bf16")[1:])
        # Rounded twice (S on the card, then the denormalised S on the wire),
        # half a bfloat16 step each.
        check_rel("serving bf16 response vs the f32 S", torch.from_numpy(s_of(rh, data)),
                  torch.from_numpy(s1), BF16_STEP)
        rh, data = counted("serve float32 512^2 u16 response", "float32",
                           lambda: enhance(srv, blob, hd, "?encoding=u16")[1:])
        codes = np.frombuffer(data, "<u2").reshape(s1.shape).astype(np.int64)
        lo, hi = float(s1.min()), float(s1.max())
        host_codes = np.round((s1.astype(np.float64) - lo) / ((hi - lo) / 65535.0))
        lsb = int(np.abs(codes - host_codes).max())
        log(f"serving u16 response: codes vs a host re-quantization of the f32 S, max |d| = {lsb} "
            f"LSB (tolerance 1)")
        if lsb > 1:
            raise AssertionError(f"u16 passthrough off by {lsb} LSB")
        check_close("serving u16 response decoded vs the f32 S", torch.from_numpy(s_of(rh, data)),
                    torch.from_numpy(s1), (hi - lo) / 65000.0)
        rh, data = counted("serve float32 512^2 artifacts=1", "float32",
                           lambda: enhance(srv, blob, hd, "?artifacts=1")[1:])
        arts = sio.loadmat(io.BytesIO(data))
        if {k: arts[k].shape for k in ("R_low", "I_low", "I_delta")} != {
                "R_low": (SIZE, SIZE, BANDS), "I_low": (SIZE, SIZE, 1), "I_delta": (SIZE, SIZE, 1)}:
            raise AssertionError(f"artifacts: {[(k, v.shape) for k, v in arts.items()]}")
        check_close("serving artifacts=1 S vs the f32 S", torch.from_numpy(arts["data"]),
                    torch.from_numpy(s1), tol)
        n_http = 8
        requests, errors = metric(srv, "sshslie_requests_total"), metric(srv, "sshslie_request_errors_total")
        log(f"serving /metrics: requests {requests}, errors {errors}")
        if requests != n_http + n_direct or errors != 0:
            raise AssertionError(f"/metrics: requests {requests} (want {n_http + n_direct}), errors {errors}")
        # Two hostile requests, then a valid one.
        status, _, data = enhance(srv, b"\x00" * 64, {"X-Cube-Encoding": "f32",
                                                      "X-Cube-Shape": "100000x100000x224"}, ok=False)
        status2, _, data2 = enhance(srv, zlib.compress(b"\x00" * (16 << 20), 9), {
            "X-Cube-Encoding": "f32", "X-Cube-Shape": f"8x8x{BANDS}", "Content-Encoding": "deflate"},
            ok=False)
        log(f"serving hostile requests: dimension bomb HTTP {status} {data[:90]!r}; deflate bomb "
            f"HTTP {status2} {data2[:90]!r}")
        if not (400 <= status < 500 and 400 <= status2 < 500):
            raise AssertionError(f"hostile requests got HTTP {status}, {status2}")
        blob, hd = f32_body(cubes[1][:64, :64])
        enhance(srv, blob, hd, "?encoding=f32")
        if metric(srv, "sshslie_request_errors_total") != 2:
            raise AssertionError("/metrics does not count the two hostile requests")

        log(f"serving (a): requests and checks {time.perf_counter() - t0:.2f} s into path 6b")
        # Singles for (b), on this service's weights.
        mb_inputs = [cubes[0], cubes[1], np.ascontiguousarray(cubes[0][::-1]),
                     np.ascontiguousarray(cubes[1][:, ::-1])]
        singles = [svc.enhance(c)["S"] for c in mb_inputs]

        # Times: X-Inference-Seconds (the service's seconds), median of 5.
        def seconds(fn, n=5):
            fn()
            return [fn()["seconds"] for _ in range(n)]

        t512 = seconds(lambda: svc.enhance(cubes[0], wire="u16_wire"))
        t1024 = seconds(lambda: svc.enhance(big, wire="u16_wire"))

        def in_new_thread(fn):
            out = []
            th = threading.Thread(target=lambda: out.append(fn()))
            th.start()
            th.join()
            return out[0]

        # As the HTTP server runs a request: on a thread of its own.
        t512_thread = seconds(lambda: in_new_thread(lambda: svc.enhance(cubes[0], wire="u16_wire")))
        # X-Inference-Seconds split: the upload of the normalised 512^2 cube
        # (pageable host memory) and the forward on it once resident, each
        # ending in a synchronize, median of 5.
        x_host = normalize_like_load(cubes[0].copy(), cfg.normalization, GLOBAL_MAX, GLOBAL_MIN)

        def upload():
            t = time.perf_counter()
            x_dev = torch.from_numpy(x_host).to(svc.device)
            torch.cuda.synchronize()
            return time.perf_counter() - t, x_dev

        x_dev = upload()[1]

        def forward():
            t = time.perf_counter()
            with svc._device_lock:
                svc._infer(svc.params, x_dev)
                torch.cuda.synchronize()
            return time.perf_counter() - t

        t_upload = [upload()[0] for _ in range(5)]
        forward()
        t_forward = [forward() for _ in range(5)]
        # Host round trip of one 512^2 request per wire encoding (request and
        # response in one encoding), median of 3, split by stage: the server's
        # decode, normalisation (host-decoded bodies), upload + forward +
        # synchronize (X-Inference-Seconds), fetch (S off the card,
        # denormalised) and encode, timed where the handler calls them; the
        # client's encode and decode; HTTP and the rest by subtraction.
        stage = {}
        originals = (serve.decode_cube_response, serve.encode_cube, serve.encode_cube_prequantized,
                     serve.io_hsi.normalize_like_load)
        decode0, encode0 = originals[:2]

        def timed(name, fn):
            def wrapper(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    stage[name] = stage.get(name, 0.0) + time.perf_counter() - t
            return wrapper

        (serve.decode_cube_response, serve.encode_cube, serve.encode_cube_prequantized,
         serve.io_hsi.normalize_like_load) = (
            timed("server decode", originals[0]), timed("server encode", originals[1]),
            timed("server encode", originals[2]), timed("server normalise", originals[3]))
        svc._finalize = timed("server fetch", svc._finalize)
        trips, splits = {}, {}
        try:
            for enc in ("mat", "f32", "bf16", "u16"):
                ts, parts = [], []
                for _ in range(3):
                    stage.clear()
                    t = time.perf_counter()
                    blob, hd = encode0(cubes[0], enc)
                    t_sent = time.perf_counter()
                    rh, data = enhance(srv, blob, hd, f"?encoding={enc}")[1:]
                    t_back = time.perf_counter()
                    decode0(data, rh, mat_key="data")
                    t_end = time.perf_counter()
                    part = {"client encode": t_sent - t, **stage,
                            "server upload+forward": float(rh["X-Inference-Seconds"]),
                            "client decode": t_end - t_back}
                    part["HTTP and the rest"] = (t_end - t) - sum(part.values())
                    ts.append(t_end - t)
                    parts.append(part)
                trips[enc] = ts
                split = {k: _median([p.get(k, 0.0) for p in parts]) for k in parts[-1]}
                splits[enc] = dict(sorted(split.items(), key=lambda kv: -kv[1]))
        finally:
            (serve.decode_cube_response, serve.encode_cube, serve.encode_cube_prequantized,
             serve.io_hsi.normalize_like_load) = originals
            del svc._finalize
        # Sustained load on this one-at-a-time service: u16 bodies (decoded on
        # the card) and u16 responses (the card's codes).
        u16_body = serve.encode_cube(cubes[0], "u16")
        load_single = sustained("serve float32 512^2, one at a time, sustained", srv,
                                *u16_body, "?encoding=u16")

        log(f"serving (a): times taken, {time.perf_counter() - t0:.2f} s into path 6b")
        # ---- (e) /reload to a second seeded checkpoint ----
        rcfg = load_config(None, dict(test_kw, model_name="chip_smoke_reload", precision="float32"))
        os.makedirs(rcfg.test_model_dir)
        rpath = interop.save_checkpoint(
            checkpoints.latest_path(rcfg.test_model_dir),
            LowLightEnhanceNet(BANDS, generator=torch.Generator().manual_seed(SEED + 1)).state_dict(),
            epoch=7)
        runner.main(rcfg)
        s_reload_test = load_hsi(os.path.join(rcfg.test_result_dir, "cube0.mat"),
                                 mat_key=rcfg.mat_key_prediction)
        status, _, data = _http(srv, "POST", f"/reload?checkpoint={os.path.abspath(rpath)}",
                                headers={"X-Reload-Token": "wrong"})
        if status != 403:
            raise AssertionError(f"/reload with a wrong token: HTTP {status}")
        status, _, data = _http(srv, "POST", f"/reload?checkpoint={os.path.abspath(rpath)}",
                                headers={"X-Reload-Token": token})
        info = json.loads(data)
        if status != 200 or info["epoch"] != 7:
            raise AssertionError(f"/reload: HTTP {status} {info}")
        blob, hd = f32_body(cubes[0])
        rh, data = counted("serve float32 512^2 after /reload", "float32",
                           lambda: enhance(srv, blob, hd, "?encoding=f32")[1:])
        s_r = s_of(rh, data)
        moved = float(np.abs(s_r - s1).max())
        log(f"serving /reload: {info}; S moved by max|d| {moved:.3f} (raw scale)")
        if not moved > 100 * tol:
            raise AssertionError("S did not change after /reload")
        check_close("serving S after /reload vs the new weights' test-phase S, raw scale",
                    torch.from_numpy(s_r), torch.from_numpy(s_reload_test), tol)
    finally:
        srv.shutdown()

    log(f"serving (e): reload done, {time.perf_counter() - t0:.2f} s into path 6b")
    # ---- (b) micro-batching ----
    t = time.perf_counter()
    mcfg = load_config(None, {**serve_kw, "model_name": cfg.model_name, "serve_warmup": f"{SIZE}x{SIZE}",
                              "serve_max_batch": 4, "serve_batch_window_ms": 50})
    srv = serve.build_server_from_config(mcfg).start()
    msvc = srv.service
    sizes = []
    run_batch = msvc.batcher._run_batch

    def recording(xs):
        sizes.append(len(xs))
        return run_batch(xs)

    msvc.batcher._run_batch = recording
    bodies = [f32_body(c) for c in mb_inputs]
    try:
        log(f"serving (b): micro-batched service built and warmed (B = 1, 2, 4 at 512^2) in "
            f"{time.perf_counter() - t:.2f} s")
        def concurrent_round(n, what):
            """``n`` requests released together; launches counted around them,
            one conv9 and one flash a batch; each S = its single request's."""
            before = len(sizes)
            gate = threading.Barrier(n)

            def one(i):
                gate.wait()
                return enhance(srv, bodies[i][0], bodies[i][1], "?encoding=f32")[1:]

            zero_counts(conv9, attention)
            with cf.ThreadPoolExecutor(n) as pool:
                outs = list(pool.map(one, range(n)))
            torch.cuda.synchronize()
            counts = read_counts(conv9, attention)
            tally_shapes(conv9, attention)
            batch = sizes[before:]
            log(f"serving (b) {what}: batches {batch}, launches {counts}")
            runs = len(batch)
            check_launches("serve micro-batched round", counts, "float32", {
                "conv9": (runs, runs), "flash_attention": (runs, runs), "conv9_wgrad": (0, 0)})
            for k, by in counts.items():
                total[k]["float32"] += by["float32"]
            for i, (rh, data) in enumerate(outs):
                check_close(f"micro-batched S {i} vs the single request's, raw scale",
                            torch.from_numpy(s_of(rh, data)), torch.from_numpy(singles[i]), tol)
            return batch

        for attempt in range(3):
            if max(concurrent_round(4, f"round {attempt + 1} of 4 requests")) >= 2:
                break
        stats = msvc.stats()
        log(f"serving (b): stats {stats}")
        if stats["max_batch_seen"] < 2:
            raise AssertionError(f"no micro-batch coalesced in 3 rounds: batches {sizes}")
        concurrent_round(2, "a round of 2 requests")
        before = len(sizes)
        load_batched = sustained("serve float32 512^2, micro-batched, sustained", srv,
                                 *u16_body, "?encoding=u16", batch_sizes=sizes)
        window = sizes[before:]
        load_batches = {b: window.count(b) for b in sorted(set(window))}
    finally:
        srv.shutdown()

    log(f"serving (b): done, {time.perf_counter() - t0:.2f} s into path 6b")
    # ---- (c) bfloat16 ----
    ccfg = load_config(None, {**serve_kw, "model_name": bcfg.model_name, "precision": "bfloat16",
                              "serve_warmup": f"{SIZE}x{SIZE}"})
    srv = serve.build_server_from_config(ccfg).start()
    try:
        blob, hd = f32_body(cubes[0])
        rh, data = counted("serve bfloat16 512^2", "bfloat16",
                           lambda: enhance(srv, blob, hd, "?encoding=f32")[1:])
        sb = s_of(rh, data)
        if sb.shape != s1.shape or not np.isfinite(sb).all():
            raise AssertionError(f"bf16 S {sb.shape}")
        log(f"serving bf16 S vs the f32 S: max|d| {float(np.abs(sb - s1).max()) / span:.3e}, "
            f"mean|d| {float(np.abs(sb - s1).mean()) / span:.3e} (normalised scale)")
        blob, hd = serve.encode_cube(big, "u16")
        counted("serve bfloat16 1000^2 (flash at S = 16384)", "bfloat16",
                lambda: enhance(srv, blob, hd, "?encoding=u16"))
        t512_bf16 = seconds(lambda: srv.service.enhance(cubes[0], wire="u16_wire"))
    finally:
        srv.shutdown()

    log(f"serving (c): done, {time.perf_counter() - t0:.2f} s into path 6b")
    # ---- (d) quantized serving ----
    x_small = normalize_like_load(cubes[0][:64, :64].copy(), cfg.normalization, GLOBAL_MAX, GLOBAL_MIN)
    psnr = {}
    t512_int8 = None
    for fmt in ("int8", "fp8", "int4"):
        qcfg = load_config(None, {**serve_kw, "model_name": cfg.model_name, "serve_quantize": fmt,
                                  "serve_warmup": f"{SIZE}x{SIZE}"})
        srv = serve.build_server_from_config(qcfg).start()
        qsvc = srv.service
        try:
            blob, hd = f32_body(cubes[0])
            rh, data = counted(f"serve {fmt} 512^2", "float32",
                               lambda: enhance(srv, blob, hd, "?encoding=f32")[1:])
            sq = s_of(rh, data)
            psnr[fmt] = float(metrics.psnr(torch.from_numpy((sq - GLOBAL_MIN) / span),
                                           torch.from_numpy((s1 - GLOBAL_MIN) / span), 1.0))
            if not math.isfinite(psnr[fmt]):
                raise AssertionError(f"{fmt}: PSNR {psnr[fmt]}")
            on_card = qsvc._infer(qsvc.params, x_small)[3].cpu()
            on_cpu = quant.QuantizedInferencer(qsvc.model, quant.to_device(qsvc.params, "cpu"),
                                               device=torch.device("cpu"))(None, x_small)[3]
            check_close(f"{fmt} quantized S 64^2, card vs CPU with the same quantized weights",
                        on_card, on_cpu, 1e-4)
            if fmt == "int8":
                t512_int8 = seconds(lambda: qsvc.enhance(cubes[0], wire="u16_wire"))
        finally:
            srv.shutdown()
    log(f"serving quantized S vs the float32 S at 512^2, PSNR (data range 1): {psnr}")
    if not psnr["int8"] >= psnr["int4"]:
        raise AssertionError(f"int8 PSNR below int4's: {psnr}")
    t = time.perf_counter()
    model = build_model(cfg, BANDS)
    interop.load_checkpoint(checkpoints.latest_path(cfg.test_model_dir), model)
    x512 = normalize_like_load(cubes[0].copy(), cfg.normalization, GLOBAL_MAX, GLOBAL_MIN)
    x256 = normalize_like_load(np.ascontiguousarray(cubes[1][:SIZE // 2, :SIZE // 2]),
                               cfg.normalization,
                               GLOBAL_MAX, GLOBAL_MIN)
    impact = quant.quantization_impact(model, [x512], "int4", calib_cubes=[x256])
    log(f"quantization_impact int4 (output calibration on one 256^2 cube, scored at 512^2): "
        f"{impact} in {time.perf_counter() - t:.2f} s")
    if impact["calibration"] != "output" or not math.isfinite(impact["psnr_vs_fp32_avg"]):
        raise AssertionError(f"quantization_impact: {impact}")

    log(f"serving times ({card}): X-Inference-Seconds, median of 5: 512^2 float32 "
        f"{_median(t512)!r} s (runs {t512}), 512^2 bfloat16 {_median(t512_bf16)!r} s (runs "
        f"{t512_bf16}), 512^2 int8 {_median(t512_int8)!r} s (runs {t512_int8}), 1024^2 float32 "
        f"(1000^2 request) {_median(t1024)!r} s (runs {t1024})")
    log(f"serving times ({card}): 512^2 float32 X-Inference-Seconds with each request on a new "
        f"thread (as the HTTP server runs them), median of 5: {_median(t512_thread)!r} s (runs "
        f"{t512_thread})")
    log(f"serving times ({card}): 512^2 float32 X-Inference-Seconds split, median of 5: upload "
        f"of the normalised cube (67 MB, pageable) {_median(t_upload)!r} s (runs {t_upload}), "
        f"forward on the resident cube {_median(t_forward)!r} s (runs {t_forward})")
    log(f"serving times ({card}): host round trip at 512^2 (encode, POST, response, decode; "
        f"request and response in one encoding), median of 3: "
        + ", ".join(f"{k} {_median(v)!r} s" for k, v in trips.items()) + f" (runs {trips})")
    for enc, split in splits.items():
        log(f"serving times ({card}): {enc} round trip by stage, median of 3, largest first: "
            + ", ".join(f"{k} {v!r} s" for k, v in split.items()))
    load_line("512^2 float32 one at a time, u16 in and out", *load_single)
    load_line("512^2 float32 micro-batched (max 4, window 50 ms), u16 in and out", *load_batched,
              extra=f"; batches by size {load_batches}")
    log(f"main path 6b (serving): {time.perf_counter() - t0:.2f} s; launches {total}")
    # What path 9 (f)'s mesh service is held against: this one-device
    # service's S (raw scale) of the 512^2 .mat request, the ragged request,
    # the u16 body decoded on the host and the request after /reload.
    return {"counts": total, "s": s1, "ragged": ragged, "u16": host, "reload": s_r,
            "reload_path": os.path.abspath(rpath), "t512": t512}


# Per-cube seconds of the test phases, by path.
TEST_SECONDS: dict = {}
# The TF32 path's tolerances against float64, written before its first chip
# run: S within 2e-2 of max|S|, each of the step's terms within 1e-2 of its
# value, each gradient within 5e-2 of its largest magnitude. That run
# measured 5.6e-2 on the worst gradient (7.3e-2 in its own L2 norm, 1.0e-2
# for all gradients together; PERF.md, PR 9): TF32's rounding carried
# through the loss's L1 terms, as float32's is at ~1/8 the size. So the
# gradients are held at 0.15 of each scale and all together at 5e-2 in L2,
# and the 5e-2 prediction is reported, not gated.
TF32_S_REL, TF32_TERMS_REL, TF32_GRAD_PREDICTED = 2e-2, 1e-2, 5e-2
TF32_GRAD_REL, TF32_GRAD_L2 = 0.15, 5e-2


def run_tf32(cfg, test_kw: dict, train_kw: dict) -> dict:
    """Main path 6c: ``matmul_precision: tensorfloat32`` through ``runner.main``
    (the float32 test phase's cubes and checkpoint; ``train_and_test`` at the
    stock values) and ``serve.build_server_from_config`` (one 512^2 request).
    Launch counts set to 0 before each and read after it, exact by (pass,
    "tf32", shape); flash in float32. The switches are on in every forward
    of the path and after it. Returns the launches by kernel and label."""
    import dataclasses

    import numpy as np
    import scipy.io as sio
    import torch

    from sshslie_torch import checkpoints, interop, runner, serve
    from sshslie_torch.config import load_config
    from sshslie_torch.device import resolve_device, set_matmul_precision
    from sshslie_torch.models.enhance import LowLightEnhanceNet, build_model
    from sshslie_torch.ops import attention, conv9
    from sshslie_torch.train import LOSS_KEYS
    from sshslie_torch.utils.io_hsi import load_hsi

    t0 = time.perf_counter()
    tf32_kw = {"matmul_precision": "tensorfloat32"}
    # The legacy switches beside torch's fp32_precision settings: set under
    # warnings-as-errors, and read back through the newer API where it exists.
    import warnings

    def fp32_precision():
        return {"cuda.matmul": getattr(torch.backends.cuda.matmul, "fp32_precision", None),
                "cudnn.conv": getattr(getattr(torch.backends.cudnn, "conv", None),
                                      "fp32_precision", None),
                "float32_matmul_precision": torch.get_float32_matmul_precision()}

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        set_matmul_precision(load_config(None, tf32_kw))
        on = fp32_precision()
        set_matmul_precision(cfg)
        off = fp32_precision()
    log(f"TF32 switches through the newer API: on {on}, off {off}")
    if on["cuda.matmul"] is not None and (on["cuda.matmul"] != "tf32" or on["cudnn.conv"] != "tf32"
                                          or "tf32" in (off["cuda.matmul"], off["cudnn.conv"])):
        raise AssertionError(f"fp32_precision does not follow the switches: on {on}, off {off}")
    seen = []                                    # the switches at each whole-model forward
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, args: seen.append(switches()) if isinstance(m, LowLightEnhanceNet) else None)
    total: dict = {}

    def read(what, dtype, want, by_shape):
        torch.cuda.synchronize()
        counts = read_counts(conv9, attention)
        tally_shapes(conv9, attention)
        check_launches(what, counts, dtype, want)
        check_by_shape(what, conv9, attention, by_shape)
        for k, by in counts.items():
            for dt, n in by.items():
                total.setdefault(k, {})[dt] = total.get(k, {}).get(dt, 0) + n

    cube_shape = (1, SIZE, SIZE, BANDS)
    attn_shape = (1, 4, (SIZE // 8) ** 2, 16)
    f32 = torch.float32
    try:
        # ---- the test phase on the float32 test phase's cubes and checkpoint ----
        tcfg = load_config(None, dict(test_kw, model_name=cfg.model_name, **tf32_kw))
        zero_counts(conv9, attention)
        t = time.perf_counter()
        result = runner.main(tcfg)
        log(f"main path (TF32 test): {time.perf_counter() - t:.2f} s; per-cube seconds "
            f"{result['seconds']}")
        read("TF32 test", "tf32", {"conv9": (2, 2), "flash_attention": (2, 2), "conv9_wgrad": (0, 0)},
             {("forward", "tf32", cube_shape): 2, ("forward", f32, attn_shape): 2})
        check_switches("after the TF32 test phase", True)
        TEST_SECONDS["TF32 test"] = result["seconds"]
        scores = result["scores"]
        log(f"TF32 test: PSNR {scores[0]!r}  SSIM {scores[1]!r}  SAM {scores[2]!r}")
        if not all(math.isfinite(v) for v in scores):
            raise AssertionError(f"TF32 test: scores {scores}")
        check_saved_s(tcfg, load_hsi, np)
        s_tf32 = load_hsi(os.path.join(tcfg.test_result_dir, "cube0.mat"), mat_key=cfg.mat_key_prediction)
        s_f32 = load_hsi(os.path.join(cfg.test_result_dir, "cube0.mat"), mat_key=cfg.mat_key_prediction)
        gap = float(np.abs(s_tf32.astype(np.float64) - s_f32).max())
        log(f"TF32 test phase S vs the float32 test phase's S (raw scale, reported, not gated): "
            f"max|d| {gap:.4e}, {gap / float(np.abs(s_f32).max()):.3e} of max|S|")

        # S against a float64 forward of the same cube and weights.
        cube = load_hsi(os.path.join(cfg.test_data, "cube0.mat"), mat_key=cfg.mat_key,
                        normalization=cfg.normalization, max_val=GLOBAL_MAX, min_val=GLOBAL_MIN)
        x = torch.from_numpy(np.ascontiguousarray(cube))[None].to(resolve_device(cfg.device))
        ckpt = checkpoints.latest_path(cfg.test_model_dir)
        outs, n_seen = {}, len(seen)
        for name, c, dtype in (("tf32", tcfg, f32), ("float32", cfg, f32),
                               ("float64", dataclasses.replace(cfg, conv_impl="torch",
                                                               attention_impl="dense"), torch.float64)):
            m = build_model(c, BANDS).to(dtype)
            interop.load_checkpoint(ckpt, m)
            set_matmul_precision(c)
            with torch.inference_mode():
                outs[name] = m(x.to(dtype))[3].double()
            del m
        del seen[n_seen:]                        # forwards of the comparison, not of the path
        smax = float(outs["float64"].abs().max())
        err = {k: float((outs[k] - outs["float64"]).abs().max()) / smax for k in ("tf32", "float32")}
        log(f"model 512^2 S against float64, max|d| over max|S|: TF32 {err['tf32']:.3e} (tolerance "
            f"{TF32_S_REL:.0e}), float32 {err['float32']:.3e}; TF32 vs float32 "
            f"{float((outs['tf32'] - outs['float32']).abs().max()) / smax:.3e}")
        if not err["tf32"] <= TF32_S_REL:
            raise AssertionError(f"TF32 S off float64 by {err['tf32']:.3e} of max|S|")
        del outs, x

        # ---- train_and_test at the stock values, the fused pipeline ----
        trcfg = load_config(None, {**train_kw, "train_data": "./data/low/train",
                                   "model_name": "chip_smoke_train_tf32", **tf32_kw})
        steps = trcfg.epoch * (len(os.listdir(trcfg.train_data)) // trcfg.batch_size)
        batch_shape = (trcfg.batch_size, trcfg.patch_size, trcfg.patch_size, BANDS)
        cubes_run = 2 * trcfg.epoch + 2          # eval cubes at each epoch, then the test cubes
        zero_counts(conv9, attention)
        t = time.perf_counter()
        tresult = runner.main(trcfg)
        trainer = tresult["trainer"]
        log(f"main path (TF32 train_and_test): {time.perf_counter() - t:.2f} s; {steps} steps on the "
            f"{trainer.pipeline} pipeline; epoch (host s, wall s) {trainer.epoch_seconds}")
        read("TF32 train_and_test", "tf32", {"conv9": (3 * steps + cubes_run,) * 2,
                                             "conv9_wgrad": (2 * steps,) * 2,
                                             "flash_attention": (cubes_run,) * 2},
             {("forward", "tf32", batch_shape): 2 * steps, ("dgrad", "tf32", batch_shape): steps,
              ("forward", "tf32", cube_shape): cubes_run, ("wgrad", "tf32", batch_shape): 2 * steps,
              ("forward", f32, attn_shape): cubes_run})
        if trainer.pipeline != "fused":
            raise AssertionError(f"TF32 train_and_test: {trainer.pipeline} pipeline")
        check_switches("after the TF32 train_and_test", True)
        check_training("TF32 train_and_test", trainer, trcfg, tresult, math, np, torch, load_hsi,
                       LOSS_KEYS)

        # ---- serving: one 512^2 request to a service built with the key ----
        set_matmul_precision(cfg)
        scfg = load_config(None, dict(test_kw, phase="serve", serve_port=0, serve_pad_multiple=64,
                                      use_mlflow=False, model_name=cfg.model_name, **tf32_kw))
        t = time.perf_counter()
        srv = serve.build_server_from_config(scfg).start()
        try:
            check_switches("TF32 service built", True)
            with open(os.path.join(cfg.test_data, "cube0.mat"), "rb") as fh:
                body = fh.read()
            zero_counts(conv9, attention)
            status, rh, data = _http(srv, "POST", "/enhance", body)
            if status != 200:
                raise AssertionError(f"TF32 serving: HTTP {status}: {data[:300]!r}")
            read("TF32 serve 512^2 .mat", "tf32", {"conv9": (1, 1), "flash_attention": (1, 1),
                                                   "conv9_wgrad": (0, 0)},
                 {("forward", "tf32", cube_shape): 1, ("forward", f32, attn_shape): 1})
        finally:
            srv.shutdown()
        # Serving normalises the body on the host, the test phase while it
        # loads: inputs an ulp apart here and there, which TF32 rounds to
        # operands 2^-11 apart. The two S then differ at TF32's rounding level
        # (the TF32 S is ~2e-4 of max|S| off float64), not at float32's.
        served = sio.loadmat(io.BytesIO(data))["data"]
        check_rel("TF32 serving S 512^2 (.mat) vs the TF32 test phase's S, raw scale",
                  torch.from_numpy(served), torch.from_numpy(s_tf32), 1e-3)
        log(f"  X-Inference-Seconds {rh['X-Inference-Seconds']}; TF32 service: "
            f"{time.perf_counter() - t:.2f} s")
    finally:
        hook.remove()
        set_matmul_precision(cfg)
    if not seen or set(seen) != {(True, True)}:
        raise AssertionError(f"TF32 path: switches at its forwards {sorted(set(seen))}")
    check_switches("after the TF32 path (reset for the float32 paths)", False)
    log(f"TF32 path: both switches on at each of its {len(seen)} whole-model forwards; off again "
        f"after it")
    log(f"main path 6c (TF32): {time.perf_counter() - t0:.2f} s; launches {total}")
    return total


def console_lines(c, prefix: str) -> list:
    """The lines of a run's console log (the runner tees stdout to it) that
    start with ``prefix``."""
    path = os.path.join("logs", f"console_output_{c.full_model_name}.log")
    with open(path) as fh:
        return [ln.strip() for ln in fh if ln.startswith(prefix)]


def run_disk(cfg, test_kw: dict, train_kw: dict, card: str, doctor_flags: list) -> dict:
    """Main path 8: the disk-backed data path. The float32 training cubes,
    test cubes and ground truth written a second time as ENVI pairs (BSQ,
    float32, ``save_envi``); then, each through ``runner.main`` with the
    launch counts set to 0 before and read after:
    (a) ``train_and_test`` at path 2's values on the ENVI cubes with
        ``lazy_loading``, ``cube_cache_size: 2`` and ``fused_window: 2``: the
        windowed fused pipeline, epoch 0 on cubes {0, 1} and epoch 1 on
        {2, 3} (each read once), launches exact;
    (b) the same training on the ``.mat`` cubes in RAM with ``fused_window:
        2`` (``phase: train``): its epoch terms and weights equal (a)'s bit
        for bit (cuDNN's deterministic algorithms; the inputs are the same
        float32 values);
    (c) ``fused_window: auto`` on the lazy ENVI store: K = N - 1 = 3 (a lazy
        store always windows; the card's free memory holds far more);
    (d) the host pipeline (``fused_pipeline: off``) on the lazy store:
        ``sampler: auto`` takes PatchSampler, batches through the Prefetcher
        (``prefetch_batches: 2``); its terms equal the in-RAM ``.mat`` run's
        with ``sampler: python`` bit for bit;
    (e) the test phase on the ENVI test cubes (a lazy store): S equals a
        ``.mat`` test phase's run beside it within 1e-6 of its span (path 1's
        S, from the script's start, is compared for the record);
    (f) ``python -m sshslie_torch.doctor`` on path 2's values in a
        subprocess: exit 0, the device row names the card, the kernel build
        row PASS.
    Returns the launches by kernel and dtype of (a)-(e)."""
    import numpy as np
    import scipy.io as sio
    import torch

    from sshslie_torch import runner
    from sshslie_torch.config import load_config
    from sshslie_torch.data import datasets
    from sshslie_torch.ops import attention, conv9
    from sshslie_torch.train import LOSS_KEYS
    from sshslie_torch.utils.io_envi import save_envi
    from sshslie_torch.utils.io_hsi import load_hsi

    t0 = time.perf_counter()
    for src, dst in (("low/train", "envi/train"), ("low/test", "envi/test"),
                     ("high/test", "envi/high")):
        os.makedirs(os.path.join("data", dst), exist_ok=True)
        for f in sorted(os.listdir(os.path.join("data", src))):
            cube = np.ascontiguousarray(sio.loadmat(os.path.join("data", src, f))["data"],
                                        dtype=np.float32)
            save_envi(os.path.join("data", dst, os.path.splitext(f)[0]), cube)
            if src == "high/test":
                # The test phase scores its saved .mat outputs against .mat labels.
                shutil.copy(os.path.join("data", src, f), os.path.join("data", dst, f))
    log(f"disk (8): ENVI pairs written in {time.perf_counter() - t0:.2f} s")

    # Every store the runs build, and every disk load of a lazy one, in order.
    stores, loads = [], []
    build_store, lazy_load = datasets.store_from_config, datasets.LazyCubeStore._load

    def recording_store(c, path, pattern=None):
        store = build_store(c, path, pattern)
        stores.append((os.path.normpath(path), store))
        return store

    def recording_load(store, idx):
        loads.append(store.files[idx])
        return lazy_load(store, idx)

    total = {}

    def counted(what, c, want):
        zero_counts(conv9, attention)
        t = time.perf_counter()
        result = runner.main(c)
        torch.cuda.synchronize()
        counts = read_counts(conv9, attention)
        tally_shapes(conv9, attention)
        check_launches(what, counts, "float32", want)
        for k, by in counts.items():
            for dt, n in by.items():
                total.setdefault(k, {})[dt] = total.get(k, {}).get(dt, 0) + n
        trainer = result.get("trainer")
        log(f"main path (disk {what}): {time.perf_counter() - t:.2f} s; launches {counts}"
            + (f"; {trainer.pipeline} pipeline, epoch (host s, wall s) {trainer.epoch_seconds}"
               if trainer else ""))
        return result

    def train_want(steps, cubes_run):
        return {"conv9": (3 * steps + cubes_run,) * 2, "conv9_wgrad": (2 * steps,) * 2,
                "flash_attention": (cubes_run,) * 2}

    def same_run(what, got, want):
        """Epoch terms and final weights of two trainers, bit for bit."""
        g_sd, w_sd = got.model.state_dict(), want.model.state_dict()
        same = (all(got.all_epoch_losses[k] == want.all_epoch_losses[k] for k in LOSS_KEYS)
                and all(torch.equal(g_sd[n], w_sd[n]) for n in w_sd))
        log(f"disk {what}: total loss {got.all_epoch_losses['total_loss']} vs "
            f"{want.all_epoch_losses['total_loss']}; terms and weights bit for bit: {same}")
        if not same:
            raise AssertionError(f"disk {what}: the runs differ")

    envi = dict(data_pattern="*.hdr", lazy_loading=True, cube_cache_size=2,
                train_data="./data/envi/train", eval_data="./data/envi/test",
                test_data="./data/envi/test", label_dir="./data/envi/high")
    ram = dict(train_data="./data/low/train", phase="train", eval_every_epoch=100)
    datasets.store_from_config = recording_store
    datasets.LazyCubeStore._load = recording_load
    torch.backends.cudnn.deterministic = True
    try:
        # ---- (a) train_and_test, lazy ENVI store, a window of 2 of the 4 cubes ----
        acfg = load_config(None, {**train_kw, **envi, "fused_window": 2,
                                  "model_name": "chip_smoke_disk"})
        steps = acfg.epoch * (N_TRAIN // acfg.batch_size)
        a = counted("(a) lazy ENVI train_and_test, fused_window 2", acfg,
                    train_want(steps, 2 * acfg.epoch + 2))
        trainer_a = a["trainer"]
        check_training("disk (a)", trainer_a, acfg, a, math, np, torch, load_hsi, LOSS_KEYS)
        lines = console_lines(acfg, "Patch sampler:")
        train_store = [s for p, s in stores if p == os.path.normpath(acfg.train_data)][0]
        train_loads = [os.path.basename(f) for f in loads if f in train_store.files]
        log(f"disk (a): {lines}; train store {type(train_store).__name__}, load_count "
            f"{train_store.load_count}, loads in order {train_loads}; epoch (host s, wall s) "
            f"{trainer_a.epoch_seconds}")
        if (trainer_a.pipeline != "fused" or len(lines) != 1 or "windowed (window=2/4 cubes"
                not in lines[0] or not isinstance(train_store, datasets.LazyCubeStore)
                or train_store.load_count != 4
                or train_loads != [f"train{i}.hdr" for i in range(4)]):
            raise AssertionError("disk (a): not the windowed pipeline over {0,1} then {2,3}")

        # ---- (b) the same training on the .mat cubes in RAM ----
        bcfg = load_config(None, {**train_kw, **ram, "fused_window": 2,
                                  "model_name": "chip_smoke_disk_ram"})
        b = counted("(b) in-RAM .mat train, fused_window 2", bcfg, train_want(steps, 0))
        same_run("(b) in RAM vs (a) lazy ENVI", b["trainer"], trainer_a)

        # ---- (c) fused_window auto on the lazy ENVI store ----
        ccfg = load_config(None, {**train_kw, **envi, "phase": "train", "epoch": 1,
                                  "eval_every_epoch": 100, "fused_window": "auto",
                                  "model_name": "chip_smoke_disk_auto"})
        free, total_mem = torch.cuda.mem_get_info()
        c = counted("(c) lazy ENVI train, fused_window auto", ccfg, train_want(2, 0))
        lines = console_lines(ccfg, "fused_window=auto:")
        log(f"disk (c): {lines} (card memory free {free} of {total_mem} bytes before the run)")
        if (len(lines) != 1 or "window=3/4 cube(s)" not in lines[0]
                or c["trainer"].pipeline != "fused"):
            raise AssertionError(f"disk (c): fused_window auto resolved {lines}")

        # ---- (d) the host pipeline on the lazy store, then in RAM with sampler python ----
        host = {"phase": "train", "epoch": 1, "eval_every_epoch": 100, "fused_pipeline": "off",
                "prefetch_batches": 2}
        dcfg = load_config(None, {**train_kw, **envi, **host, "sampler": "auto",
                                  "model_name": "chip_smoke_disk_host"})
        d = counted("(d) lazy ENVI train, host pipeline", dcfg, train_want(2, 0))
        lines = console_lines(dcfg, "Patch sampler:")
        log(f"disk (d): {lines}")
        if len(lines) != 1 or not lines[0].startswith("Patch sampler: PatchSampler (sampler='auto',"):
            raise AssertionError(f"disk (d): sampler lines {lines}")
        rcfg = load_config(None, {**train_kw, **ram, **host, "sampler": "python",
                                  "model_name": "chip_smoke_disk_host_ram"})
        r = counted("(d) in-RAM .mat train, host pipeline, sampler python", rcfg, train_want(2, 0))
        same_run("(d) lazy ENVI vs in RAM, host pipeline", d["trainer"], r["trainer"])

        # ---- (e) the test phase on the ENVI test cubes, beside a .mat one ----
        # The two run back to back on the same algorithms; the float32 test
        # phase of path 1, at the script's start, is compared too, for the record.
        tests = {}
        for key, extra in (("mat", {}), ("envi", dict(data_pattern="*.hdr", lazy_loading=True,
                                                      test_data="./data/envi/test"))):
            tests[key] = load_config(None, dict(test_kw, model_name=cfg.model_name,
                                                timestamp=f"disk_{key}", **extra))
            counted(f"(e) {key} test phase", tests[key], {
                "conv9": (2, 2), "flash_attention": (2, 2), "conv9_wgrad": (0, 0)})
            check_saved_s(tests[key], load_hsi, np)
        for i in range(2):
            want, got, first = (torch.from_numpy(load_hsi(
                os.path.join(c.test_result_dir, f"cube{i}.mat"), mat_key=cfg.mat_key_prediction))
                for c in (tests["mat"], tests["envi"], cfg))
            check_close(f"disk (e): ENVI test S of cube{i} vs the .mat test phase's", got, want,
                        1e-6 * float(want.max() - want.min()))
            log(f"disk (e): ENVI test S of cube{i} vs path 1's .mat test phase: max|d| "
                f"{float((got.double() - first.double()).abs().max())!r} (raw scale; S spans "
                f"{float(first.max() - first.min())!r})")
    finally:
        torch.backends.cudnn.deterministic = False
        datasets.store_from_config = build_store
        datasets.LazyCubeStore._load = lazy_load

    # ---- (f) the doctor, as a user runs it ----
    t = time.perf_counter()
    flags = ["--config", "", "--model_name", "chip_smoke_doctor", *doctor_flags]
    for key, val in train_kw.items():
        flags += [f"--{key}", str(val)]
    proc = subprocess.run([sys.executable, "-m", "sshslie_torch.doctor", *flags + [
        "--train_data", "./data/low/train"]], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")))
    rows = proc.stdout.strip().splitlines()
    log(f"disk (f): python -m sshslie_torch.doctor exit {proc.returncode} in "
        f"{time.perf_counter() - t:.2f} s:\n  " + "\n  ".join(rows))
    device_row = [r for r in rows if r.startswith("[PASS] torch device")]
    build_row = [r for r in rows if r.startswith("[PASS] kernel build")]
    if (proc.returncode != 0 or not device_row or torch.cuda.get_device_name(0) not in device_row[0]
            or not build_row):
        raise AssertionError(f"disk (f): doctor exit {proc.returncode}: {proc.stdout}{proc.stderr}")
    log(f"main path 8 (disk-backed data, {card}): {time.perf_counter() - t0:.2f} s")
    return total


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_worker(out: str, argv: list) -> int:
    """Path 9 (a), under ``torchrun``: the CLI's ``runner.main(parse_args(argv))``
    with cuDNN's deterministic algorithms (as path 2 ran), then its epoch
    terms, launches by shape and output directories written to ``out``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sshslie_torch import runner
    from sshslie_torch.config import parse_args
    from sshslie_torch.ops import attention, conv9

    torch.backends.cudnn.deterministic = True
    zero_counts(conv9, attention)
    result = runner.main(parse_args(argv))
    torch.cuda.synchronize()
    trainer = result["trainer"]
    with open(out, "w") as fh:
        json.dump({"losses": trainer.all_epoch_losses, "mesh": str(trainer.mesh),
                   "backend": trainer.mesh.backend, "device": str(trainer.device),
                   "test_result_dir": trainer.cfg.test_result_dir,
                   "test_model_dir": trainer.cfg.test_model_dir,
                   "counts": counts_to_json(shape_counts(conv9, attention))}, fh)
    return 0


def rank_worker(rank: int, port: int, out: str) -> int:
    """Path 9 (b) to (f), one of two gloo ranks sharing the card: two fused
    data-parallel steps at global batch 2 (rank 0 then holds the first
    against a one-process b2 step), the band-sharded test phase through
    ``runner.main``, two fused dp x sp steps on a 1x2 mesh (each rank 64 of
    the 128 rows; rank 0 holds the first against the same one-process step),
    the height-sharded test phase through ``runner.main``, and the mesh
    service (rank 0 answers HTTP, rank 1 follows; rank 0 writes its S to
    ``f_S.npz``); launches by shape around each, written to ``out``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import scipy.io as sio

    from sshslie_torch import runner, serve
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore
    from sshslie_torch.device import set_matmul_precision
    from sshslie_torch.models.enhance import LowLightEnhanceNet, shard_space
    from sshslie_torch.ops import attention, conv9
    from sshslie_torch.parallel import distributed
    from sshslie_torch.parallel.mesh import make_mesh
    from sshslie_torch.train import (LOSS_KEYS, fused_draws, fused_train_step, loss_coeffs,
                                     make_optimizer, stack_cubes)

    with open(os.path.join(os.path.dirname(out), "path9.json")) as fh:
        kw = json.load(fh)
    tcfg = load_config(None, kw["train"])
    set_matmul_precision(tcfg)
    distributed.initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                                       world_size=2, rank=rank)
    dev = torch.device("cuda:0")
    mesh = make_mesh("2")
    coeffs = loss_coeffs(tcfg)
    store = CubeStore(tcfg.train_data, normalization=tcfg.normalization,
                      global_min=tcfg.global_min, global_max=tcfg.global_max)
    cubes = stack_cubes(store, dev)
    b, p = tcfg.batch_size, tcfg.patch_size
    draws = torch.from_numpy(fused_draws(tcfg.seed_value, 0, 2, b, (SIZE, SIZE), p)).to(dev)

    def fresh():
        model = LowLightEnhanceNet(BANDS, generator=torch.Generator().manual_seed(SEED))
        model = model.to(dev).train()
        return model, make_optimizer(model, tcfg.start_lr)

    report = {"rank": rank, "mesh": str(mesh)}
    ref = None

    def two_steps(part, on, shard=None):
        """Two fused steps on ``on`` from the seeded weights (the model's height
        split over ``shard``); rank 0 holds step 1 against the one-process b2
        step on the same draws and weights (not counted)."""
        nonlocal ref
        model, opt = fresh()
        if shard is not None:
            shard_space(model, shard)
        zero_counts(conv9, attention)
        t = time.perf_counter()
        terms = [fused_train_step(model, opt, cubes, draws[0], 0, p, coeffs, mesh=on)]
        grads = {n: q.grad.clone() for n, q in model.named_parameters()}
        terms.append(fused_train_step(model, opt, cubes, draws[1], b, p, coeffs, mesh=on))
        torch.cuda.synchronize()
        report[f"{part}_s"] = time.perf_counter() - t
        report[f"{part}_counts"] = counts_to_json(shape_counts(conv9, attention))
        report[f"{part}_terms"] = [[float(tt[k]) for k in LOSS_KEYS] for tt in terms]
        if rank != 0:
            return
        if ref is None:
            ref_model, ref_opt = fresh()
            ref_terms = fused_train_step(ref_model, ref_opt, cubes, draws[0], 0, p, coeffs)
            ref = ([float(ref_terms[k]) for k in LOSS_KEYS],
                   {n: q.grad for n, q in ref_model.named_parameters()})
        got = torch.tensor(report[f"{part}_terms"][0], dtype=torch.float64)
        want = torch.tensor(ref[0], dtype=torch.float64)
        report[f"{part}_terms_rel"] = float(((got - want).abs() / want.abs()).max())
        # Each gradient's scale, floored at 1e-8 of the largest (grad_errors'
        # floor: k_linear's bias has an exact gradient of zero).
        gmax = max(float(g.abs().max()) for g in ref[1].values())
        report[f"{part}_grad_rel"] = max(
            float((grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-8 * gmax)
            for n, g in ref[1].items())
        # PERF.md section 2's float32 step gates: terms 2e-5 relative,
        # gradients 2e-2 of each one's scale.
        if not (report[f"{part}_terms_rel"] <= 2e-5 and report[f"{part}_grad_rel"] <= 2e-2):
            raise AssertionError(
                f"path 9 ({part}): step 1 against the one-process b2 step: terms "
                f"{report[f'{part}_terms_rel']:.3e}, gradients {report[f'{part}_grad_rel']:.3e}")

    def test_phase(part, test_kw):
        zero_counts(conv9, attention)
        t = time.perf_counter()
        cfg = load_config(None, test_kw)
        # Each test phase saves to its own directory (the names are from rank 0).
        cfg.test_result_dir += f"_{part}"
        result = runner.main(cfg)
        torch.cuda.synchronize()
        report[f"{part}_s"] = time.perf_counter() - t
        report[f"{part}_result_dir"] = cfg.test_result_dir
        report[f"{part}_counts"] = counts_to_json(shape_counts(conv9, attention))
        report[f"{part}_scores"] = result.get("scores")
        report[f"{part}_seconds"] = result["seconds"]

    two_steps("b", mesh)
    test_phase("c", kw["test"])
    # (d): the patch height split over a 1x2 mesh's space axis, 64 rows a rank.
    sp_mesh = make_mesh("1x2")
    report["sp_mesh"] = str(sp_mesh)
    two_steps("d", sp_mesh, sp_mesh.shard("space"))
    del cubes
    test_phase("e", dict(kw["test"], eval_shard_mode="spatial"))

    # (f): the mesh service on the test phase's checkpoint; rank 0 answers
    # HTTP on 127.0.0.1, rank 1 follows.
    scfg = load_config(None, kw["serve"])
    zero_counts(conv9, attention)
    t = time.perf_counter()
    srv = serve.build_server_from_config(scfg, mesh)
    if rank != 0:
        srv.serve_forever()
    else:
        srv.start()
        try:
            status, _, health = _http(srv, "GET", "/health")
            report["f_health"] = json.loads(health)
            cube = np.ascontiguousarray(sio.loadmat(os.path.join(scfg.test_data, "cube0.mat"))[
                "data"], dtype=np.float32)
            with open(os.path.join(scfg.test_data, "cube0.mat"), "rb") as fh:
                mat_body = fh.read()
            f32_body = serve.encode_cube(cube, "f32")
            got = {}

            def post(key, body, headers, query):
                status, rh, data = _http(srv, "POST", "/enhance" + query, body, headers)
                if status != 200:
                    raise AssertionError(f"path 9 (f) {key}: HTTP {status}: {data[:300]!r}")
                got[key] = serve.decode_cube_response(data, rh, mat_key="data")
                return float(rh["X-Inference-Seconds"])

            post("s", mat_body, {}, "")
            post("ragged", *serve.encode_cube(cube[:SIZE - 12, :SIZE - 52], "f32"), "?encoding=f32")
            post("u16", *serve.encode_cube(cube, "u16"), "?encoding=f32")
            status, _, data = _http(srv, "POST", f"/reload?checkpoint={kw['reload_path']}",
                                    headers={"X-Reload-Token": scfg.serve_reload_token})
            report["f_reload"] = [status, json.loads(data)]
            post("reload", *f32_body, "?encoding=f32")
            report["f_x_seconds"] = [post("warm", *f32_body, "?encoding=f32") for _ in range(5)]
            np.savez(os.path.join(os.path.dirname(out), "f_S.npz"),
                     **{k: v for k, v in got.items() if k != "warm"})
        finally:
            srv.shutdown()
    torch.cuda.synchronize()
    report["f_s"] = time.perf_counter() - t
    report["f_counts"] = counts_to_json(shape_counts(conv9, attention))
    report["backend"] = mesh.backend
    distributed.leave()
    with open(out, "w") as fh:
        json.dump(report, fh)
    return 0


def run_wide(common: dict) -> dict:
    """Main path 10: float32 training at 224 bands. Writes N_WIDE synthetic
    SIZE_WIDE^2 x 224 cubes (raw values 238..4095) and runs ``runner.main``
    with ``phase: train``, ``channels: 224``, the Li et al. loss weights, b8 x
    128^2 on the fused pipeline, 2 epochs of one step. Launches exact by
    shape: the wide conv9 forward and conv9_wgrad 2 a step each at (8, 128,
    128, 224, 64), nothing else on the hand kernels; the shallow conv's
    input gradient on cuDNN, one a step, and no other pass of it there
    (``conv9.library_passes``). Epoch terms finite. Returns the launches by
    shape."""
    import numpy as np
    import scipy.io as sio
    import torch

    from sshslie_torch import runner
    from sshslie_torch.config import load_config
    from sshslie_torch.ops import attention, conv9

    rng = np.random.default_rng(SEED + WIDE_BANDS)
    os.makedirs("data/low/train224")
    illum = np.linspace(0.15, 0.4, SIZE_WIDE, dtype=np.float32)[:, None, None]
    for i in range(N_WIDE):
        raw = rng.random((SIZE_WIDE, SIZE_WIDE, WIDE_BANDS), dtype=np.float32) * illum
        sio.savemat(f"data/low/train224/train{i}.mat",
                    {"data": GLOBAL_MIN + (GLOBAL_MAX - GLOBAL_MIN) * raw})
    tcfg = load_config(None, {**common, **STOCK_TRAIN, **LI_TRAIN, "channels": WIDE_BANDS,
                              "phase": "train", "train_data": "./data/low/train224",
                              "batch_size": 8, "epoch": 2, "fused_pipeline": "on",
                              "model_name": "chip_smoke_train224"})
    steps = tcfg.epoch * (N_WIDE // tcfg.batch_size)
    what = "float32 train at 224 bands"
    zero_counts(conv9, attention)
    t = time.perf_counter()
    trainer = runner.main(tcfg)["trainer"]
    torch.cuda.synchronize()
    check_switches(what, False)
    f32 = torch.float32
    shape = (tcfg.batch_size, tcfg.patch_size, tcfg.patch_size, WIDE_BANDS, 64)
    check_by_shape(what, conv9, attention, {("wide_forward", f32, shape): 2 * steps,
                                            ("wide_wgrad", f32, shape): 2 * steps})
    if conv9.library_passes != {("dgrad", f32, shape): steps}:
        raise AssertionError(f"{what}: shallow-conv passes on cuDNN {conv9.library_passes}, "
                             f"expected the input gradient {steps} times")
    losses = trainer.all_epoch_losses["total_loss"]
    log(f"main path ({what}): {time.perf_counter() - t:.2f} s; {steps} steps on the "
        f"{trainer.pipeline} pipeline; cuDNN passes {conv9.library_passes}; total loss {losses}")
    if trainer.pipeline != "fused" or len(losses) != tcfg.epoch or not all(
            math.isfinite(v) for vals in trainer.all_epoch_losses.values() for v in vals):
        raise AssertionError(f"{what}: pipeline {trainer.pipeline}, terms "
                             f"{trainer.all_epoch_losses}")
    return shape_counts(conv9, attention)


def run_multi(work: str, test_kw: dict, train_kw: dict, path1_cfg, path2: dict,
              served: dict, card: str) -> dict:
    """Main path 9, data parallel on one card: (a) path 2's run through the
    CLI under ``torchrun`` with ``--mesh_shape 1`` (an NCCL group of one),
    equal to path 2 bit for bit; (b) to (f) two gloo ranks sharing the card
    (``rank_worker``), (f) held against path 6b's one-device service
    (``served``). The three processes run at once. Returns the launches by
    shape of every process, summed."""
    import numpy as np

    from sshslie_torch.utils.io_hsi import load_hsi

    t0 = time.perf_counter()
    out = os.path.join(work, "path9")
    os.makedirs(out)
    test = dict(test_kw, model_name=path1_cfg.model_name, precision="float32", mesh_shape="2",
                eval_sharded=True, eval_shard_mode="band", device="cuda:0")
    train = dict(train_kw, train_data="./data/low/train")
    serve_kw = dict(test, phase="serve", serve_port=0, serve_pad_multiple=64,
                    serve_warmup=f"{SIZE}x{SIZE}", serve_reload_token="chip-smoke-mesh-token",
                    use_mlflow=False)
    with open(os.path.join(out, "path9.json"), "w") as fh:
        json.dump({"test": test, "train": train, "serve": serve_kw,
                   "reload_path": served["reload_path"]}, fh)
    argv = ["--config", "", "--mesh_shape", "1", "--model_name", "chip_smoke_nccl",
            "--train_data", "./data/low/train"]
    for key, val in train_kw.items():
        argv += [f"--{key}", str(val)]
    script = os.path.join(ROOT, "chip_smoke.py")
    procs = {"(a)": subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         script, "--cli-worker", os.path.join(out, "cli.json"), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    port = free_port()
    for r in range(2):
        procs[f"rank {r}"] = subprocess.Popen(
            [sys.executable, script, "--rank-worker", str(r), str(port),
             os.path.join(out, f"rank{r}.json")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    try:
        for what, proc in procs.items():
            logs[what] = proc.communicate(timeout=300)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for what, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"path 9 {what} exited {proc.returncode}:\n{logs[what][-6000:]}")
    with open(os.path.join(out, "cli.json")) as fh:
        a = json.load(fh)
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))

    # (a): an NCCL group of one through the CLI = path 2, bit for bit.
    log(f"path 9 (a): {a['mesh']} on {a['device']}")
    if a["backend"] != "nccl":
        raise AssertionError(f"path 9 (a): backend {a['backend']}")
    if a["losses"] != path2["losses"]:
        raise AssertionError(f"path 9 (a): epoch terms {a['losses']} != path 2's {path2['losses']}")
    a_counts = counts_from_json(a["counts"])
    if a_counts != path2["counts"]:
        raise AssertionError(f"path 9 (a): launches {a_counts} != path 2's {path2['counts']}")
    for i in range(2):
        got = load_hsi(os.path.join(a["test_result_dir"], f"cube{i}.mat"), mat_key="data")
        want = load_hsi(os.path.join(path2["test_result_dir"], f"cube{i}.mat"), mat_key="data")
        if not np.array_equal(got, want):
            raise AssertionError(f"path 9 (a): saved S of cube{i} differs from path 2's by "
                                 f"{float(np.abs(got - want).max()):.3e}")
    log("path 9 (a): epoch terms, launches by shape and saved S = path 2's, bit for bit")

    # (b) and (d): two fused steps at b2, dp (b = 1 a rank) and dp x sp (each
    # rank 64 of the 128 rows plus a 4-row halo each side at the shallow conv).
    p = train_kw["patch_size"]
    f32 = (1, p, p, BANDS)
    sp = (2, p // 2 + 8, p, BANDS)
    for part, what, shape in (("b", "dp", f32), ("d", "dp x sp", sp)):
        want = {("conv9", "forward", "float32", shape): 4, ("conv9", "dgrad", "float32", shape): 2,
                ("conv9_wgrad", "wgrad", "float32", shape): 4}
        for rep in ranks:
            got = counts_from_json(rep[f"{part}_counts"])
            if got != want:
                raise AssertionError(f"path 9 ({part}) rank {rep['rank']}: launches {got}, "
                                     f"expected {want}")
        if ranks[0][f"{part}_terms"] != ranks[1][f"{part}_terms"]:
            raise AssertionError(f"path 9 ({part}): the ranks' terms differ: "
                                 f"{ranks[0][f'{part}_terms']} {ranks[1][f'{part}_terms']}")
        log(f"path 9 ({part}): {ranks[0]['mesh' if part == 'b' else 'sp_mesh']}; 2 fused {what} "
            f"steps in {ranks[0][f'{part}_s']:.2f} s, terms equal on both ranks; step 1 against "
            f"the one-process b2 step: terms {ranks[0][f'{part}_terms_rel']:.3e} relative (gate "
            f"2e-5), gradients {ranks[0][f'{part}_grad_rel']:.3e} of their scale (gate 2e-2); "
            f"launches a rank {want}")

    # (c) and (e): the band- and height-sharded test phases, rank 0 the writer.
    flash = ("flash_attention", "forward", "float32", (1, 4, (SIZE // 8) ** 2, 16))
    for part, what, conv in (("c", "band", (1, SIZE, SIZE, BANDS)),
                             ("e", "height", (1, SIZE // 2 + 8, SIZE, BANDS))):
        want = {("conv9", "forward", "float32", conv): 2, flash: 2}
        for rep in ranks:
            got = counts_from_json(rep[f"{part}_counts"])
            if got != want:
                raise AssertionError(f"path 9 ({part}) rank {rep['rank']}: launches {got}, "
                                     f"expected {want}")
        scores = ranks[0][f"{part}_scores"]
        if (scores is None or not all(math.isfinite(v) for v in scores)
                or ranks[1][f"{part}_scores"] is not None):
            raise AssertionError(f"path 9 ({part}): scores {scores}, rank 1's "
                                 f"{ranks[1][f'{part}_scores']}")
        errs = []
        for i in range(2):
            got = load_hsi(os.path.join(ranks[0][f"{part}_result_dir"], f"cube{i}.mat"),
                           mat_key="data")
            ref = load_hsi(os.path.join(path1_cfg.test_result_dir, f"cube{i}.mat"), mat_key="data")
            span = float(ref.max() - ref.min())
            errs.append(float(np.abs(got.astype(np.float64) - ref).max()))
            if not errs[-1] <= 1e-5 * span:
                raise AssertionError(f"path 9 ({part}): S of cube{i} {errs[-1]:.3e} from path "
                                     f"1's, over 1e-5 of its span {span:.1f}")
        log(f"path 9 ({part}): {what}-sharded test phase in {ranks[0][f'{part}_s']:.2f} s "
            f"(per-cube seconds {ranks[0][f'{part}_seconds']}); S against path 1's: max|d| {errs} "
            f"(gate 1e-5 of the span); PSNR {scores[0]!r}; launches a rank {want}")
    # (f): the mesh service against path 6b's one-device service: the
    # warmup, 4 checked requests and 5 timed ones, one forward each a rank.
    want = {("conv9", "forward", "float32", (1, SIZE // 2 + 8, SIZE, BANDS)): 10, flash: 10}
    for rep in ranks:
        got = counts_from_json(rep["f_counts"])
        if got != want:
            raise AssertionError(f"path 9 (f) rank {rep['rank']}: launches {got}, expected {want}")
    f0 = ranks[0]
    if f0["f_health"]["backend"] != "cuda" or f0["f_reload"][0] != 200:
        raise AssertionError(f"path 9 (f): /health {f0['f_health']}, /reload {f0['f_reload']}")
    got = np.load(os.path.join(out, "f_S.npz"))
    errs = {}
    for key in ("s", "ragged", "u16", "reload"):
        ref = served[key]
        span = float(ref.max() - ref.min())
        if got[key].shape != ref.shape:
            raise AssertionError(f"path 9 (f) {key}: S {got[key].shape}, path 6b's {ref.shape}")
        errs[key] = float(np.abs(got[key].astype(np.float64) - ref).max())
        if not errs[key] <= 1e-5 * span:
            raise AssertionError(f"path 9 (f) {key}: S {errs[key]:.3e} from path 6b's, over 1e-5 "
                                 f"of its span {span:.1f}")
    log(f"path 9 (f): mesh service (2 gloo ranks, rank 0 on HTTP) built, warmed, 9 requests "
        f"and a reload in {f0['f_s']:.2f} s; S against path 6b's one-device service (512^2 "
        f".mat, 500x460, u16 body, after /reload): max|d| {errs} (gate 1e-5 of the span); "
        f"launches a rank {want}")
    log(f"path 9 (f) times ({card}): 512^2 float32 X-Inference-Seconds on the 2-rank mesh "
        f"(the cube's broadcast, halos and gathers staged through the host by gloo), median of "
        f"5: {_median(f0['f_x_seconds'])!r} s (runs {f0['f_x_seconds']}); path 6b's one-device "
        f"{_median(served['t512'])!r} s")
    total = dict(a_counts)
    for rep in ranks:
        for part in "bcdef":
            for key, n in counts_from_json(rep[f"{part}_counts"]).items():
                total[key] = total.get(key, 0) + n
    log(f"main path 9: {time.perf_counter() - t0:.2f} s")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from sshslie_torch import checkpoints, interop, runner
    from sshslie_torch.config import load_config, parse_args
    from sshslie_torch.data.datasets import CubeStore, PatchSampler
    from sshslie_torch.data.native_sampler import NativePatchSampler
    from sshslie_torch.models.enhance import LowLightEnhanceNet, build_model
    from sshslie_torch.ops import _build, attention, conv9
    from sshslie_torch.train import (LOSS_KEYS, fused_draws, fused_train_step, loss_coeffs,
                                     make_optimizer, multistep_train_step, sample_fused_batch,
                                     stack_cubes, train_step)
    from sshslie_torch.utils.io_hsi import load_hsi

    t_all = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from sshslie_torch.device import set_matmul_precision

    set_matmul_precision(load_config(None, {}))    # full float32: both TF32 switches off
    check_switches("start", False)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    t = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t:.1f} s")

    work = tempfile.mkdtemp(prefix="sshslie_chip_smoke_")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t = time.perf_counter()
        write_inputs(work)
        common = dict(channels=BANDS, global_min=GLOBAL_MIN, global_max=GLOBAL_MAX,
                      normalization="global_normalization", test_data="./data/low/test",
                      label_dir="./data/high/test", conv_impl="auto", attention_impl="auto")
        test_kw = dict(common, phase="test", test_timestamp="smoke", save_reflectance=True,
                       save_illumination=True, seed_value=41)
        cfg = load_config(None, dict(test_kw, model_name="chip_smoke", precision="float32"))
        bcfg = load_config(None, dict(test_kw, model_name="chip_smoke_bf16", precision="bfloat16"))
        weights = LowLightEnhanceNet(BANDS, generator=torch.Generator().manual_seed(SEED))
        for c in (cfg, bcfg):
            os.makedirs(c.test_model_dir)
            interop.save_checkpoint(checkpoints.latest_path(c.test_model_dir), weights.state_dict(),
                                    epoch=0)
        log(f"inputs written in {time.perf_counter() - t:.1f} s under {work}")

        def run_test_phase(what, c, dtype):
            zero_counts(conv9, attention)
            t = time.perf_counter()
            result = runner.main(c)
            torch.cuda.synchronize()
            counts = read_counts(conv9, attention)
            tally_shapes(conv9, attention)
            log(f"main path ({what}): {time.perf_counter() - t:.2f} s; launches {counts}; "
                f"per-cube seconds {result['seconds']}")
            TEST_SECONDS[what] = result["seconds"]
            scores = result["scores"]
            log(f"{what}: PSNR {scores[0]!r}  SSIM {scores[1]!r}  SAM {scores[2]!r}")
            if not all(math.isfinite(s) for s in scores):
                raise AssertionError(f"{what}: non-finite scores {scores}")
            check_launches(what, counts, dtype, {"conv9": (2, 2), "flash_attention": (2, 2),
                                                 "conv9_wgrad": (0, 0)})
            check_saved_s(c, load_hsi, np)
            return counts

        def run_training(what, tcfg, dtype):
            steps = tcfg.epoch * (len(os.listdir(tcfg.train_data)) // tcfg.batch_size)
            cubes_run = 2 * tcfg.epoch + 2          # eval cubes at each epoch, then the test cubes
            zero_counts(conv9, attention)
            t = time.perf_counter()
            tresult = runner.main(tcfg)
            torch.cuda.synchronize()
            counts = read_counts(conv9, attention)
            tally_shapes(conv9, attention)
            trainer = tresult["trainer"]
            log(f"main path ({what}): {time.perf_counter() - t:.2f} s; {steps} steps on the "
                f"{trainer.pipeline} pipeline; launches {counts}; epoch (host s, wall s) "
                f"{trainer.epoch_seconds}")
            if trainer.pipeline != "fused":
                raise AssertionError(f"{what}: trained on the {trainer.pipeline} pipeline")
            check_launches(what, counts, dtype, {
                "conv9": (3 * steps + cubes_run, 3 * steps + cubes_run),
                "conv9_wgrad": (2 * steps, 2 * steps), "flash_attention": (1, cubes_run)})
            check_training(what, trainer, tcfg, tresult, math, np, torch, load_hsi, LOSS_KEYS)
            return counts, trainer

        # ---- main path 1: the float32 test phase, launch counts read around it ----
        test_counts = run_test_phase("float32 test", cfg, "float32")

        # ---- main path 2: float32 training (stock values, fused_pipeline auto), then its test ----
        train_kw = {**common, **STOCK_TRAIN, "phase": "train_and_test",
                    "eval_data": "./data/low/test", "eval_every_epoch": 1, "epoch": 2}
        tcfg = load_config(None, {**train_kw, "train_data": "./data/low/train",
                                  "model_name": "chip_smoke_train"})
        # cuDNN's deterministic algorithms, so that path 9 (a) can repeat it bit for bit.
        torch.backends.cudnn.deterministic = True
        try:
            train_counts, path2_trainer = run_training("float32 train_and_test", tcfg, "float32")
        finally:
            torch.backends.cudnn.deterministic = False
        path2 = {"losses": path2_trainer.all_epoch_losses, "test_result_dir": tcfg.test_result_dir,
                 "counts": shape_counts(conv9, attention)}

        # ---- main path 5b: the rest of the stock run (tracking, async eval, best, trace, SIGTERM) ----
        engine_counts = run_engine(train_kw, common)

        # ---- main path 3: the bfloat16 test phase ----
        btest_counts = run_test_phase("bfloat16 test", bcfg, "bfloat16")

        # ---- main path 6b: serving, on the test phases' cubes and checkpoints ----
        served = run_serving(cfg, bcfg, test_kw, card)

        # ---- main path 6c: matmul_precision tensorfloat32 (test, train_and_test, serving) ----
        tf32_counts = run_tf32(cfg, test_kw, train_kw)
        log(f"test phase per-cube seconds ({card}): float32 {TEST_SECONDS['float32 test']}, TF32 "
            f"{TEST_SECONDS['TF32 test']} (the second cube is the warm one)")

        # ---- main path 4: bfloat16 training at b8 on the fused pipeline, 2 steps a dispatch ----
        bt = load_config(None, {**train_kw, "train_data": "./data/low/train256",
                                "model_name": "chip_smoke_train_bf16", "batch_size": 8,
                                "precision": "bfloat16", "fused_pipeline": "on",
                                "steps_per_dispatch": 2})
        btrain_counts, _ = run_training("bfloat16 train_and_test", bt, "bfloat16")

        # ---- the CLI's parser, as a user runs it: the other training variants ----
        def cli_run(what, argv, dtype, want, pipeline=None, sampler=None):
            zero_counts(conv9, attention)
            t = time.perf_counter()
            result = runner.main(parse_args(argv))
            torch.cuda.synchronize()
            counts = read_counts(conv9, attention)
            trainer = result.get("trainer")
            log(f"CLI {what}: {time.perf_counter() - t:.2f} s; launches {counts}"
                + (f"; {trainer.pipeline} pipeline, total loss {trainer.all_epoch_losses['total_loss']}"
                   if trainer else ""))
            check_launches(f"CLI {what}", counts, dtype, want)
            if trainer and (trainer.pipeline != pipeline or not all(
                    math.isfinite(v) for vals in trainer.all_epoch_losses.values() for v in vals)):
                raise AssertionError(f"CLI {what}: pipeline {trainer.pipeline}, losses "
                                     f"{trainer.all_epoch_losses}")
            if not all(math.isfinite(v) for v in result["scores"]):
                raise AssertionError(f"CLI {what}: scores {result['scores']}")
            if sampler:
                # The run's console log names the host sampler that the sampler
                # key resolved to.
                lines = console_lines(trainer.cfg, "Patch sampler:")
                log(f"CLI {what}: {lines}")
                if len(lines) != 1 or not lines[0].startswith(f"Patch sampler: {sampler} "):
                    raise AssertionError(f"CLI {what}: sampler lines {lines}, expected {sampler}")
            return result

        # The stock training values as flags (no YAML reader needed), 1 epoch
        # of 2 steps with an eval, then the test phase: 4 cubes forwarded.
        cli = ["--config", "", "--phase", "train_and_test", "--epoch", "1", "--eval_every_epoch", "1",
               "--train_data", "./data/low/train", "--eval_data", "./data/low/test"]
        for key, val in {**common, **STOCK_TRAIN}.items():
            cli += [f"--{key}", str(val)]
        accum = cli_run("--precision bfloat16 --grad_accum_steps 2 --fused_pipeline off",
                        cli + ["--precision", "bfloat16", "--grad_accum_steps", "2",
                               "--fused_pipeline", "off", "--model_name", "cli_accum"],
                        "bfloat16", {"conv9": (16, 16), "conv9_wgrad": (8, 8),
                                     "flash_attention": (1, 4)}, pipeline="host",
                        sampler="NativePatchSampler (sampler='auto',")
        cli_run("--remat true --fused_pipeline on --steps_per_dispatch 2",
                cli + ["--remat", "true", "--fused_pipeline", "on", "--steps_per_dispatch", "2",
                       "--model_name", "cli_remat"],
                "float32", {"conv9": (14, 14), "conv9_wgrad": (4, 4), "flash_attention": (1, 4)},
                pipeline="fused")
        cli_run("--phase test --precision bfloat16", cli + [
            "--phase", "test", "--precision", "bfloat16", "--model_name", "cli_accum",
            "--test_timestamp", accum["trainer"].cfg.timestamp],
            "bfloat16", {"conv9": (2, 2), "conv9_wgrad": (0, 0), "flash_attention": (2, 2)})

        # ---- main path 8: the disk-backed data path (ENVI, lazy store, windows, prefetch) ----
        disk_counts = run_disk(cfg, test_kw, train_kw, card, [])

        # ---- main path 9: data parallel on one card (NCCL of one via torchrun; two gloo ranks) ----
        multi_counts = run_multi(work, test_kw, train_kw, cfg, path2, served, card)
        tally_shapes(conv9, attention, multi_counts)

        # ---- main path 10: float32 training at 224 bands (the wide shallow conv) ----
        wide_counts = run_wide(common)
        tally_shapes(conv9, attention, wide_counts)

        # ---- kernels against their plain versions on the card ----
        cube = load_hsi(os.path.join(cfg.test_data, "cube0.mat"), mat_key=cfg.mat_key,
                        normalization=cfg.normalization, max_val=GLOBAL_MAX, min_val=GLOBAL_MIN)
        x = torch.from_numpy(np.ascontiguousarray(cube))[None].to(dev)
        w9 = weights.decomposition_net.shallow_conv[0].weight.detach().permute(2, 3, 1, 0).contiguous().to(dev)
        g = torch.Generator().manual_seed(SEED)
        x_odd = torch.randn(1, 37, 53, 64, generator=g).to(dev)
        w_odd = (torch.randn(9, 9, 64, 64, generator=g) * 0.02).to(dev)
        store = CubeStore("./data/low/train", normalization=tcfg.normalization,
                          global_min=GLOBAL_MIN, global_max=GLOBAL_MAX)
        sampler = PatchSampler(store, tcfg.batch_size, tcfg.patch_size, seed=SEED)
        xt = torch.from_numpy(sampler.sample_batch(0)).to(dev)          # (2, 128, 128, 64)
        gt = (torch.randn(xt.shape, generator=g) * 1e-3).to(dev)        # a gradient's scale
        wd = conv9.conv9_dgrad_weights(w9)
        errs = {}
        # float32 sums of 5184 products in another order: 2e-5 of the output's scale.
        for key, what, xx, ww in (("conv9_512", "conv9 (1, 512, 512, 64) k9", x, w9),
                                  ("odd", "conv9 (1, 37, 53, 64) k9", x_odd, w_odd),
                                  ("conv9_128", "conv9 (2, 128, 128, 64) k9", xt, w9),
                                  ("dgrad_128", "conv9 dgrad (2, 128, 128, 64) k9", gt, wd)):
            err = check_rel(what, conv9.conv9_fwd(xx, ww), conv9.conv9_plain(xx, ww), 2e-5)
            errs[key] = max(err, errs.get(key, 0.0))
        # Path 9 (b)'s shape: one sample a rank of the b2 batch.
        x1, g1 = xt[:1].contiguous(), gt[:1].contiguous()
        errs["conv9_128_b1"] = check_rel("conv9 (1, 128, 128, 64) k9", conv9.conv9_fwd(x1, w9),
                                         conv9.conv9_plain(x1, w9), 2e-5)
        errs["dgrad_128_b1"] = check_rel("conv9 dgrad (1, 128, 128, 64) k9", conv9.conv9_fwd(g1, wd),
                                         conv9.conv9_plain(g1, wd), 2e-5)
        # Path 9 (d)'s shape: a rank's 64 rows of the b2 batch plus a 4-row
        # halo each side; (e)'s: a rank's 256 rows of the test cube plus its halo.
        xs, gs = xt[:, :72].contiguous(), gt[:, :72].contiguous()
        x264 = x[:, :264].contiguous()
        errs["conv9_72"] = check_rel("conv9 (2, 72, 128, 64) k9", conv9.conv9_fwd(xs, w9),
                                     conv9.conv9_plain(xs, w9), 2e-5)
        errs["dgrad_72"] = check_rel("conv9 dgrad (2, 72, 128, 64) k9", conv9.conv9_fwd(gs, wd),
                                     conv9.conv9_plain(gs, wd), 2e-5)
        errs["conv9_264"] = check_rel("conv9 (1, 264, 512, 64) k9", conv9.conv9_fwd(x264, w9),
                                      conv9.conv9_plain(x264, w9), 2e-5)
        # Sums over up to 262,144 pixels, in slices, in another order: 5e-5 of the scale.
        for key, what, xx, dy in (
                ("wgrad_128_b1", "(1, 128, 128, 64)", x1, g1),
                ("wgrad_72", "(2, 72, 128, 64)", xs, gs),
                ("wgrad_128", "(2, 128, 128, 64)", xt, gt),
                ("wgrad_512", "(1, 512, 512, 64)", x, torch.randn(x.shape, generator=g).to(dev)),
                ("odd", "(1, 37, 53, 64)", x_odd, torch.randn(x_odd.shape, generator=g).to(dev))):
            err = check_rel(f"conv9_wgrad {what} k9", conv9.conv9_wgrad(xx, dy, 9),
                            conv9.conv9_wgrad_plain(xx, dy, 9), 5e-5)
            errs[key] = max(err, errs.get(key, 0.0))
        qkv = [torch.randn(1, 4, 4096, 16, generator=g).to(dev) for _ in range(3)]
        qkv_odd = [torch.randn(1, 4, 4100, 16, generator=g).to(dev) for _ in range(3)]
        # S of a 1024^2 cube, where attention grows to the scale of conv9.
        qkv_1024 = [torch.randn(1, 4, 16384, 16, generator=g).to(dev) for _ in range(3)]
        for key, what, (q, k, v) in (("flash", "flash (1, 4, 4096, 16)", qkv),
                                     ("odd", "flash (1, 4, 4100, 16)", qkv_odd),
                                     ("flash_1024", "flash (1, 4, 16384, 16)", qkv_1024)):
            # exp2 with a folded scale against exp, sums in another order: 1e-5 absolute.
            err = check_close(what, attention.flash_attention(q, k, v), attention.sdpa_chunked(q, k, v), 1e-5)
            errs[key] = max(err, errs.get(key, 0.0))
        # The micro-batched serving shapes: four 512^2 test cubes (flipped), and
        # attention over them (its own generator, so the draws below stay).
        g4 = torch.Generator().manual_seed(SEED + 8)
        cube1 = load_hsi(os.path.join(cfg.test_data, "cube1.mat"), mat_key=cfg.mat_key,
                         normalization=cfg.normalization, max_val=GLOBAL_MAX, min_val=GLOBAL_MIN)
        x4 = torch.from_numpy(np.ascontiguousarray(
            np.stack([cube, cube1, cube[::-1], cube1[:, ::-1]]))).to(dev)
        qkv4 = [torch.randn(4, 4, 4096, 16, generator=g4).to(dev) for _ in range(3)]
        errs["conv9_b4"] = check_rel("conv9 (4, 512, 512, 64) k9", conv9.conv9_fwd(x4, w9),
                                     conv9.conv9_plain(x4, w9), 2e-5)
        errs["flash_b4"] = check_close("flash (4, 4, 4096, 16)", attention.flash_attention(*qkv4),
                                       attention.sdpa_chunked(*qkv4), 1e-5)
        # B = 2 (the micro-batcher's most frequent batch under load), and the
        # 1024^2 bucket: the test cube mirrored into four quadrants.
        x2, qkv2 = x4[:2], [t[:2] for t in qkv4]
        errs["conv9_b2"] = check_rel("conv9 (2, 512, 512, 64) k9", conv9.conv9_fwd(x2, w9),
                                     conv9.conv9_plain(x2, w9), 2e-5)
        errs["flash_b2"] = check_close("flash (2, 4, 4096, 16)", attention.flash_attention(*qkv2),
                                       attention.sdpa_chunked(*qkv2), 1e-5)
        x1024 = torch.cat([torch.cat([x, x.flip(2)], 2), torch.cat([x.flip(1), x.flip(1, 2)], 2)], 1)
        errs["conv9_1024"] = check_rel("conv9 (1, 1024, 1024, 64) k9", conv9.conv9_fwd(x1024, w9),
                                       conv9.conv9_plain(x1024, w9), 2e-5)
        # The float32 entry in every split of its units (conv9_f32_parts picks
        # one by shape): ragged (1, 37, 45, 64) at k = 3, 9 and 13, forward
        # and dgrad, against the plain version (2e-5 of the largest output),
        # every split's bits equal; and where two splits or two shapes compute
        # the same pixels, the same bits: the b2 batch in every split, sample
        # 0 of it against (1, 128, 128, 64), its rows 0..67 against the rank
        # slice (2, 72, 128, 64) (rows 68..71 see the slice's edge).
        t_f32 = time.perf_counter()
        g_f32 = torch.Generator().manual_seed(SEED + 10)
        x37 = torch.randn(1, 37, 45, 64, generator=g_f32).to(dev)
        worst = 0.0
        for kk in (3, 9, 13):
            wk = (torch.randn(kk, kk, 64, 64, generator=g_f32) * 0.02).to(dev)
            for what, ww in (("", wk), (" dgrad", conv9.conv9_dgrad_weights(wk))):
                plain = conv9.conv9_plain(x37, ww)
                outs = [conv9.conv9_fwd(x37, ww, parts=p) for p in conv9.F32_PARTS]
                torch.cuda.synchronize()
                for p, o in zip(conv9.F32_PARTS, outs):
                    err = float((o - plain).abs().max() / plain.abs().max())
                    if not (err <= 2e-5 and bool(torch.isfinite(o).all())):
                        raise AssertionError(f"conv9{what} (1, 37, 45, 64) k{kk} parts {p}: "
                                             f"max|d| / max|plain| {err:.3e} over 2e-5")
                    if not torch.equal(o, outs[0]):
                        raise AssertionError(f"conv9{what} (1, 37, 45, 64) k{kk}: parts {p}'s "
                                             f"bits differ from the unsplit units'")
                    worst = max(worst, err)
        for what, xx, ww in (("", xt, w9), (" dgrad", gt, wd)):
            b2 = [conv9.conv9_fwd(xx, ww, parts=p) for p in conv9.F32_PARTS]
            for p, o in zip(conv9.F32_PARTS, b2):
                same = (torch.equal(o, b2[0])
                        and torch.equal(conv9.conv9_fwd(xx[:1].contiguous(), ww, parts=p), b2[0][:1])
                        and torch.equal(conv9.conv9_fwd(xx[:, :72].contiguous(), ww, parts=p)[:, :68],
                                        b2[0][:, :68]))
                if not same:
                    raise AssertionError(f"conv9{what} parts {p}: (2, 128, 128, 64), its sample 0 or "
                                         f"its rows 0..67 as (2, 72, 128, 64) differ bit for bit")
        log(f"float32 conv9 splits (parts) {conv9.F32_PARTS}: (1, 37, 45, 64) k = 3, 9, 13, forward "
            f"and dgrad, max|d| / max|plain| {worst:.3e} (tolerance 2e-5), the splits bit for bit "
            f"equal; (2, 128, 128, 64) forward and dgrad in every split, its sample 0 and rows 0..67 "
            f"as (1, 128, 128, 64) and (2, 72, 128, 64), bit for bit equal; "
            f"{time.perf_counter() - t_f32:.2f} s")
        # The wide float32 entries (Cin -> 64) at main path 10's shapes, a b8
        # x 128^2 batch of its 224-band cubes and a gradient's scale: the
        # forward within 2e-5 of the largest output (sums of 18,144 products in
        # another order), every split bit for bit; the weight gradient within
        # 5e-5 (sums over 131,072 pixels in slices); ragged (1, 37, 45, 224) at
        # k = 3, 9, 13 the same; ShallowConv's gradients at the wide weights
        # (dx from cuDNN) against autograd through the plain version, 5e-5.
        t_wide = time.perf_counter()
        g_wide = torch.Generator().manual_seed(SEED + 11)
        wstore = CubeStore("./data/low/train224", normalization=tcfg.normalization,
                           global_min=GLOBAL_MIN, global_max=GLOBAL_MAX)
        x224 = torch.from_numpy(PatchSampler(wstore, 8, 128, seed=SEED).sample_batch(0)).to(dev)
        del wstore
        wide_conv = LowLightEnhanceNet(WIDE_BANDS, generator=torch.Generator().manual_seed(SEED)
                                       ).decomposition_net.shallow_conv[0]
        w224 = wide_conv.weight.detach().permute(2, 3, 1, 0).contiguous().to(dev)  # (9, 9, 224, 64)
        b224 = wide_conv.bias.detach().to(dev)
        g224 = (torch.randn((*x224.shape[:3], 64), generator=g_wide) * 1e-3).to(dev)
        errs["conv9_224"] = check_rel("conv9 (8, 128, 128, 224) -> 64 k9",
                                      conv9.conv9_fwd(x224, w224), conv9.conv9_plain(x224, w224),
                                      2e-5)
        errs["wgrad_224"] = check_rel("conv9_wgrad (8, 128, 128, 224) -> (9, 9, 224, 64)",
                                      conv9.conv9_wgrad(x224, g224, 9),
                                      conv9.conv9_wgrad_plain(x224, g224, 9), 5e-5)
        outs = [conv9.conv9_fwd(x224, w224, parts=p) for p in conv9.F32_PARTS]
        if not all(torch.equal(o, outs[0]) for o in outs):
            raise AssertionError("conv9 (8, 128, 128, 224) -> 64: the splits' bits differ")
        x37w = torch.randn(1, 37, 45, WIDE_BANDS, generator=g_wide).to(dev)
        dy37w = torch.randn(1, 37, 45, 64, generator=g_wide).to(dev)
        for kk in (3, 9, 13):
            wk = (torch.randn(kk, kk, WIDE_BANDS, 64, generator=g_wide) * 0.02).to(dev)
            plain = conv9.conv9_plain(x37w, wk)
            outs = [conv9.conv9_fwd(x37w, wk, parts=p) for p in conv9.F32_PARTS]
            for p, o in zip(conv9.F32_PARTS, outs):
                check_rel(f"conv9 (1, 37, 45, 224) -> 64 k{kk} parts {p}", o, plain, 2e-5)
                if not torch.equal(o, outs[0]):
                    raise AssertionError(f"conv9 (1, 37, 45, 224) k{kk}: parts {p}'s bits differ")
            check_rel(f"conv9_wgrad (1, 37, 45, 224) k{kk}", conv9.conv9_wgrad(x37w, dy37w, kk),
                      conv9.conv9_wgrad_plain(x37w, dy37w, kk), 5e-5)

        def wide_grads(fn):
            ts = [t.clone().requires_grad_() for t in (x224, w224, b224)]
            return torch.autograd.grad(fn(*ts), ts, g224)

        for name, a, b in zip(("dx", "dw", "db"), wide_grads(conv9.shallow_conv),
                              wide_grads(lambda xx, w_, bb: conv9.conv9_plain(xx, w_) + bb)):
            check_rel(f"ShallowConv {name} (8, 128, 128, 224) -> 64", a, b, 5e-5)
        log(f"wide float32 checks (224 -> 64 at b8 x 128^2 and (1, 37, 45, 224) k = 3, 9, 13, "
            f"splits {conv9.F32_PARTS} bit for bit): {time.perf_counter() - t_wide:.2f} s")

        # The bfloat16 entries at the bfloat16 main paths' shapes: the test
        # cube, and a b8 batch of the fused pipeline with a gradient's scale.
        bstore = CubeStore("./data/low/train256", normalization=bt.normalization,
                           global_min=GLOBAL_MIN, global_max=GLOBAL_MAX)
        bcubes = stack_cubes(bstore, dev)
        bdraws = torch.from_numpy(fused_draws(SEED, 0, 2, bt.batch_size, (SIZE_BF16, SIZE_BF16),
                                              bt.patch_size)).to(dev)
        xt8 = sample_fused_batch(bcubes, bdraws[0], 0, bt.patch_size)  # (8, 128, 128, 64)
        xb, w9b, xt8b = x.to(bf16), w9.to(bf16), xt8.to(bf16)
        gt8b = (torch.randn(xt8.shape, generator=g) * 1e-3).to(dev).to(bf16)
        wdb = conv9.conv9_dgrad_weights(w9b)
        # Both sum in float32 and round once: one bfloat16 step of the largest output.
        xb1024 = x1024.to(bf16)
        for key, what, xx, ww in (("conv9_512_bf16", "conv9 bf16 (1, 512, 512, 64) k9", xb, w9b),
                                  ("conv9_1024_bf16", "conv9 bf16 (1, 1024, 1024, 64) k9", xb1024, w9b),
                                  ("conv9_128_bf16", "conv9 bf16 (8, 128, 128, 64) k9", xt8b, w9b),
                                  ("dgrad_128_bf16", "conv9 bf16 dgrad (8, 128, 128, 64) k9", gt8b, wdb)):
            errs[key] = check_rel(what, conv9.conv9_fwd(xx, ww).float(),
                                  conv9.conv9_plain(xx, ww).float(), BF16_STEP)
        # float32 output, sums over 131,072 pixels in another order: 5e-5 of the scale.
        errs["wgrad_128_bf16"] = check_rel("conv9_wgrad bf16 (8, 128, 128, 64) k9",
                                           conv9.conv9_wgrad(xt8b, gt8b, 9),
                                           conv9.conv9_wgrad_plain(xt8b, gt8b, 9), 5e-5)
        # The tensor-core bfloat16 entries off the main path's shapes too: ragged
        # 8 x 64 tiles and 64-pixel segments, k = 3, 9 and 13 (their own
        # generator, so the draws below stay as they were).
        t_odd = time.perf_counter()
        g_odd = torch.Generator().manual_seed(SEED + 5)
        x_oddb = x_odd.to(bf16)
        dy_oddb = torch.randn(x_odd.shape, generator=g_odd).to(dev).to(bf16)
        for kk in (3, 9, 13):
            wk = (torch.randn(kk, kk, 64, 64, generator=g_odd) * 0.02).to(dev).to(bf16)
            for what, ww in (("", wk), (" dgrad", conv9.conv9_dgrad_weights(wk))):
                check_rel(f"conv9 bf16{what} (1, 37, 53, 64) k{kk}", conv9.conv9_fwd(x_oddb, ww).float(),
                          conv9.conv9_plain(x_oddb, ww).float(), BF16_STEP)
            check_rel(f"conv9_wgrad bf16 (1, 37, 53, 64) k{kk}", conv9.conv9_wgrad(x_oddb, dy_oddb, kk),
                      conv9.conv9_wgrad_plain(x_oddb, dy_oddb, kk), 5e-5)
        log(f"bf16 checks at (1, 37, 53, 64), k = 3, 9, 13: {time.perf_counter() - t_odd:.2f} s")
        # The TF32 entries against their tf32=True plain versions (the same
        # rounding, exact products, float32 sums in another order) within
        # 1e-5 of the largest output, repeats bit-identical; and against a
        # float64 conv of the unrounded operands, elementwise within
        # (2u + u^2 + n 2^-23) conv(|x|, |w|), u = 2^-11 (each operand's
        # rounding), n 2^-23 the float32 sums of the n products however they
        # round. At the main paths' shapes, then ragged at k = 3, 9, 13.
        check_switches("TF32 kernel checks", False)
        t_tf32 = time.perf_counter()

        def tf32_check(what, fn, plain, f64, f64_abs, n):
            got = fn()
            err = check_rel(what, got, plain(), 1e-5)
            if not torch.equal(got, fn()):
                raise AssertionError(f"{what}: repeats differ")
            bound = (2 * 2.0 ** -11 + 2.0 ** -22 + n * 2.0 ** -23) * f64_abs()
            excess = float(((got.double() - f64()).abs() - bound).max())
            if excess > 0:
                raise AssertionError(f"{what}: over the float64 bound by {excess:.3e}")
            return err

        def conv_tf32_check(what, xx, ww):
            return tf32_check(what, lambda: conv9.conv9_fwd(xx, ww, tf32=True),
                              lambda: conv9.conv9_plain(xx, ww, tf32=True),
                              lambda: conv9.conv9_plain(xx.double(), ww.double()),
                              lambda: conv9.conv9_plain(xx.double().abs(), ww.double().abs()),
                              ww.shape[0] ** 2 * 64)

        def wgrad_tf32_check(what, xx, dy, kk):
            return tf32_check(what, lambda: conv9.conv9_wgrad(xx, dy, kk, tf32=True),
                              lambda: conv9.conv9_wgrad_plain(xx, dy, kk, tf32=True),
                              lambda: conv9.conv9_wgrad_plain(xx.double(), dy.double(), kk),
                              lambda: conv9.conv9_wgrad_plain(xx.double().abs(), dy.double().abs(), kk),
                              xx.numel() // 64)

        errs["conv9_512_tf32"] = conv_tf32_check("conv9 tf32 (1, 512, 512, 64) k9", x, w9)
        errs["conv9_128_tf32"] = conv_tf32_check("conv9 tf32 (2, 128, 128, 64) k9", xt, w9)
        errs["dgrad_128_tf32"] = conv_tf32_check("conv9 tf32 dgrad (2, 128, 128, 64) k9", gt, wd)
        errs["wgrad_128_tf32"] = wgrad_tf32_check("conv9_wgrad tf32 (2, 128, 128, 64) k9", xt, gt, 9)
        g_tf32 = torch.Generator().manual_seed(SEED + 9)
        dy_odd = torch.randn(x_odd.shape, generator=g_tf32).to(dev)
        for kk in (3, 9, 13):
            wk = (torch.randn(kk, kk, 64, 64, generator=g_tf32) * 0.02).to(dev)
            conv_tf32_check(f"conv9 tf32 (1, 37, 53, 64) k{kk}", x_odd, wk)
            conv_tf32_check(f"conv9 tf32 dgrad (1, 37, 53, 64) k{kk}", x_odd,
                            conv9.conv9_dgrad_weights(wk))
        # The weight gradient at every k its TF32 entry takes (one or two
        # blocks a kernel row, taps split 5 + 4 at k = 9): the largest error
        # over the largest |dW| is logged against the 1e-5 tolerance.
        wgrad_rel = {}
        for kk in conv9.KERNEL_SIZES:
            dw_plain = conv9.conv9_wgrad_plain(x_odd, dy_odd, kk, tf32=True)
            wgrad_rel[kk] = (wgrad_tf32_check(f"conv9_wgrad tf32 (1, 37, 53, 64) k{kk}", x_odd, dy_odd, kk)
                             / float(dw_plain.abs().max()))
        wgrad_rel[9, "main"] = errs["wgrad_128_tf32"] / float(
            conv9.conv9_wgrad_plain(xt, gt, 9, tf32=True).abs().max())
        log("conv9_wgrad tf32 max|err| / max|dW| (tolerance 1e-5): "
            + ", ".join(f"{k}: {v:.3e}" for k, v in wgrad_rel.items()))
        log(f"TF32 checks (main shapes; (1, 37, 53, 64) at k = 3, 9, 13, wgrad at k = 3 .. 13): "
            f"{time.perf_counter() - t_tf32:.2f} s")
        # The bfloat16 flash kernel carries p as a bfloat16 hi + lo pair, ~16
        # bits: against sdpa_chunked on the operands widened to float32 (the
        # Pallas kernel's float32 p) within one bfloat16 step of max|o|.
        # Against the plain version, which rounds p to bfloat16 before P V,
        # within that plus twice the plain version's own distance from the
        # float32-p result on these inputs (the rounding of p; the 2^-9 of
        # max|v| it can reach is ~1e-2 here, the size of o). max_abs_err is
        # the distance from the plain version, as in every row.
        qkvb = [t.to(bf16) for t in qkv]
        qkvb_1024 = [t.to(bf16) for t in qkv_1024]
        for key, what, qkv_ in (("flash_bf16", "(1, 4, 4096, 16)", qkvb),
                                ("flash_1024_bf16", "(1, 4, 16384, 16)", qkvb_1024)):
            got = attention.flash_attention(*qkv_).float()
            want = attention.sdpa_chunked(*qkv_).float()
            want32 = attention.sdpa_chunked(*(t.float() for t in qkv_))
            check_close(f"flash bf16 {what} vs float32 p", got, want32,
                        BF16_STEP * float(want32.abs().max()))
            p_gap = float((want - want32).abs().max())
            log(f"flash bf16 {what}: plain vs float32 p, max|d| = {p_gap:.3e}")
            errs[key] = check_close(f"flash bf16 {what} vs plain", got, want,
                                    BF16_STEP * float(want.abs().max()) + 2.0 * p_gap)

        # The autograd Functions' gradients against autograd through the plain versions.
        bias = weights.decomposition_net.shallow_conv[0].bias.detach().to(dev)

        def conv_grads(fn):
            ts = [t.clone().requires_grad_() for t in (xt, w9, bias)]
            return torch.autograd.grad(fn(*ts), ts, gt)

        for name, a, b in zip(("dx", "dw", "db"), conv_grads(conv9.shallow_conv),
                              conv_grads(lambda xx, ww, bb: conv9.conv9_plain(xx, ww) + bb)):
            check_rel(f"ShallowConv {name} (2, 128, 128, 64)", a, b, 5e-5)
        go = torch.randn(qkv[0].shape, generator=g).to(dev)

        def attn_grads(fn):
            ts = [t.clone().requires_grad_() for t in qkv]
            return torch.autograd.grad(fn(*ts), ts, go)

        for name, a, b in zip(("dq", "dk", "dv"), attn_grads(attention.flash_attention),
                              attn_grads(attention.sdpa_chunked)):
            check_rel(f"FlashAttention {name} (1, 4, 4096, 16)", a, b, 1e-5)

        # One whole float32 train step: the kernel path against the plain
        # path, and both against the plain path in float64. Float32 gradients
        # of this loss (L1 terms, c_loss_i_smooth_delta 2000) carry rounding
        # of up to ~7e-3 of their scale on any float32 path, and where that
        # worst case falls changes from run to run (cuDNN's backward is not
        # deterministic), so the kernel path is held to the float64 step at
        # 2e-2 of each gradient's scale, with the plain path's error beside
        # it; a wrong kernel pass would be off by ~1e-1 to 1 of the scale.
        coeffs = loss_coeffs(tcfg)
        lr = tcfg.start_lr
        sd = {k: v.to(dev) for k, v in weights.state_dict().items()}
        plain_cfg = dataclasses.replace(tcfg, conv_impl="torch", attention_impl="dense")

        def step_paths(kernel_cfg, batch):
            paths = {}
            plain = dataclasses.replace(kernel_cfg, conv_impl="torch", attention_impl="dense")
            f64 = dataclasses.replace(plain, precision="float32")
            for name, c, dtype in (("kernel", kernel_cfg, torch.float32),
                                   ("plain", plain, torch.float32), ("float64", f64, torch.float64)):
                m = build_model(c, BANDS, dev, train=True).to(dtype)
                m.load_state_dict(sd)
                opt = make_optimizer(m, lr)
                paths[name] = (m, opt, train_step(m, opt, batch.to(dtype), coeffs))
            return paths

        paths = step_paths(tcfg, xt)
        params = {name: dict(m.named_parameters()) for name, (m, _, _) in paths.items()}
        for k in LOSS_KEYS:
            # Sums over 2*128^2*64 values in another order: rtol 2e-5.
            check_rel(f"train step {k}, kernel vs plain path", paths["kernel"][2][k],
                      paths["plain"][2][k], 2e-5)
        ref = params["float64"]
        gmax = max(float(p.grad.abs().max()) for p in ref.values())
        worst = {"kernel": 0.0, "plain": 0.0, "kernel_vs_plain": 0.0, "formula": 0.0, "adam": 0.0}
        for n, p in params["kernel"].items():
            g64, gp = ref[n].grad, params["plain"][n].grad
            scale = float(g64.abs().max())
            # The floor covers k_linear's bias, whose exact gradient is zero.
            denom = max(scale, 1e-8 * gmax)
            for key, got in (("kernel", p.grad), ("plain", gp)):
                worst[key] = max(worst[key], float((got - g64).abs().max()) / denom)
            worst["kernel_vs_plain"] = max(worst["kernel_vs_plain"],
                                           float((p.grad - gp).abs().max()) / denom)
            # Adam's first step, p0 - lr g / (|g| + eps), on the kernel path's own gradient.
            step = sd[n] - lr * p.grad / (p.grad.abs() + 1e-8)
            worst["formula"] = max(worst["formula"], float((p.detach() - step).abs().max()) / lr)
            # Against the plain path where |g| is far above the gradients'
            # float32 rounding (~3e-3 of the scale) and above 1000 eps: the
            # first step lr g / (|g| + eps) moves there by about
            # lr (eps / |g|) (|dg| / |g|) <= 3e-5 lr, but by up to 2 lr where
            # |g| is near the rounding or near eps.
            strong = (g64.abs() > 0.1 * scale) & (g64.abs() > 1e-5)
            if bool(strong.any()):
                worst["adam"] = max(worst["adam"], float(
                    (p.detach() - params["plain"][n].detach())[strong].abs().max()) / lr)
        log(f"train step gradients, worst max|d| over each gradient's scale: kernel path vs "
            f"float64 {worst['kernel']:.3e}, plain path vs float64 {worst['plain']:.3e}, kernel vs "
            f"plain {worst['kernel_vs_plain']:.3e} (tolerance: kernel vs float64 <= 2e-2)")
        log(f"train step parameters after Adam: {worst['formula']:.3e} lr from the first-step "
            f"formula (tolerance 1e-4 lr), {worst['adam']:.3e} lr from the plain path where "
            f"|g| > 0.1 of the scale and > 1e-5 (tolerance 1e-4 lr)")
        if not (worst["kernel"] <= 2e-2 and worst["formula"] <= 1e-4 and worst["adam"] <= 1e-4):
            raise AssertionError(f"train step over tolerance: {worst}")

        # The same step with matmul_precision tensorfloat32 (the kernels' TF32
        # entries, cuDNN and cuBLAS in TF32) against the float64 step, with the
        # tolerances written before the first chip run (TF32_*_REL).
        # The TF32 plain path (cuDNN's TF32 for the shallow conv too) beside it,
        # to tell TF32's own rounding from the kernels'.
        t32cfg = dataclasses.replace(tcfg, matmul_precision="tensorfloat32")
        t32_err = {}
        set_matmul_precision(t32cfg)
        try:
            for name, c in (("tf32", t32cfg), ("tf32 plain", dataclasses.replace(
                    t32cfg, conv_impl="torch", attention_impl="dense"))):
                m = build_model(c, BANDS, dev, train=True)
                m.load_state_dict(sd)
                opt = make_optimizer(m, lr)
                zero_counts(conv9, attention)
                t32_terms = train_step(m, opt, xt, coeffs)
                torch.cuda.synchronize()
                check_launches(f"{name} train step", read_counts(conv9, attention), "tf32",
                               {"conv9": (3, 3) if name == "tf32" else (0, 0),
                                "conv9_wgrad": (2, 2) if name == "tf32" else (0, 0),
                                "flash_attention": (0, 0)})
                terms_err = {k: abs(float(t32_terms[k]) / float(paths["float64"][2][k]) - 1)
                             for k in LOSS_KEYS}
                t32_err[name] = dict(grad_errors(dict(m.named_parameters()), ref, lr, sd),
                                     terms=max(terms_err.values()), each_term=terms_err)
                if name == "tf32":
                    paths["tf32"] = (m, opt, t32_terms)
                del m, opt
        finally:
            set_matmul_precision(tcfg)
        ke = t32_err["tf32"]
        log(f"TF32 train step (b2 x 128^2 x 64) against float64: kernel path {ke}, plain path "
            f"{t32_err['tf32 plain']} (tolerances: terms {TF32_TERMS_REL:.0e} relative, each "
            f"gradient {TF32_GRAD_REL} of its scale, all gradients {TF32_GRAD_L2:.0e} in L2, "
            f"first-step formula 1e-4 lr; predicted before the first run: each gradient within "
            f"{TF32_GRAD_PREDICTED:.0e}: {'held' if ke['max'] <= TF32_GRAD_PREDICTED else 'failed'})")
        if not (ke["terms"] <= TF32_TERMS_REL and ke["max"] <= TF32_GRAD_REL
                and ke["l2_all"] <= TF32_GRAD_L2 and ke["formula"] <= 1e-4):
            raise AssertionError(f"TF32 train step over tolerance: {ke}")
        paths.pop("float64")

        # One bfloat16 train step at b8 on the fused pipeline's batch, both
        # paths against the float64 step. bfloat16 rounding of the
        # activations moves the terms by up to ~0.12 of their value (the
        # smoothness terms, differences of neighbouring bfloat16 values) and
        # the gradients by ~0.11 in L2 (up to ~0.35 for single weights of
        # the DecompositionNet's first layers), on either path alike
        # (measured on the card, kernel 0.117 / 0.109 / 0.337, plain 0.118 /
        # 0.111 / 0.350), so the 2e-2-of-scale rule widens to: each term
        # within 0.25 of its float64 value, all gradients together within
        # 0.25 of the float64 L2 norm, every gradient of norm above 1e-3 of
        # the largest within 0.8 of its own norm. A wrong kernel pass is off
        # by ~1 on its weights.
        bpaths = step_paths(bt, xt8)
        bparams = {name: dict(m.named_parameters()) for name, (m, _, _) in bpaths.items()}
        bworst = {}
        for name in ("kernel", "plain"):
            terms_err = {k: abs(float(bpaths[name][2][k]) / float(bpaths["float64"][2][k]) - 1)
                         for k in LOSS_KEYS}
            e = grad_errors(bparams[name], bparams["float64"], lr, sd)
            bworst[name] = dict(e, terms=max(terms_err.values()), each_term=terms_err)
        log(f"bf16 train step b8 against float64: kernel path {bworst['kernel']}, plain path "
            f"{bworst['plain']} (tolerances: terms 0.25 relative, L2 of all gradients 0.25, "
            f"worst gradient L2 0.8, first-step formula 1e-4 lr)")
        kb = bworst["kernel"]
        if not (kb["terms"] <= 0.25 and kb["l2_all"] <= 0.25 and kb["l2_worst"] <= 0.8
                and kb["formula"] <= 1e-4):
            raise AssertionError(f"bf16 train step over tolerance: {kb}")
        bpaths.pop("float64")

        def model_pair(c, chunked_cfg):
            models = [build_model(mc, BANDS, dev) for mc in (c, chunked_cfg)]
            for m in models:
                interop.load_checkpoint(checkpoints.latest_path(cfg.test_model_dir), m)
            return models

        kernel_model, plain_model = model_pair(
            cfg, dataclasses.replace(cfg, conv_impl="torch", attention_impl="chunked"))
        with torch.inference_mode():
            got32, want = kernel_model(x), plain_model(x)
        for name, a, b in zip(("R_low", "I_low", "I_delta", "S"), got32, want):
            # Outputs of order 1 after ~20 float32 layers: 1e-4 absolute.
            check_close(f"model 512^2 kernel path vs plain path, {name}", a, b, 1e-4)
        bkernel_model, bplain_model = model_pair(
            bcfg, dataclasses.replace(bcfg, conv_impl="torch", attention_impl="chunked"))
        with torch.inference_mode():
            gotb, wantb = bkernel_model(x), bplain_model(x)
        for name, a, b, a32 in zip(("R_low", "I_low", "I_delta", "S"), gotb, wantb, got32):
            # bfloat16 roundings that fall the other way (sums in another
            # order, p as a hi + lo pair in the flash kernel) carried through ~20
            # bfloat16 layers: a few bfloat16 steps at most, 2e-2 absolute at
            # outputs of order 1, and on average under half of the distance
            # from the float32 model, which a silent float32 run would show.
            err = check_close(f"model 512^2 bf16 kernel path vs plain path, {name}", a, b, 2e-2)
            mean, gap = float((a - b).abs().mean()), float((b - a32).abs().mean())
            log(f"  mean|d| {mean:.3e}, mean|bf16 plain - float32 kernel| {gap:.3e}")
            if not mean <= 0.5 * gap:
                raise AssertionError(f"bf16 model {name}: mean|d| {mean:.3e} vs {gap:.3e} ({err})")
        cpu_model = build_model(cfg, BANDS, torch.device("cpu"))
        interop.load_checkpoint(checkpoints.latest_path(cfg.test_model_dir), cpu_model)
        small = x[:, :64, :64]
        with torch.inference_mode():
            got, want = kernel_model(small), cpu_model(small.cpu())
        for name, a, b in zip(("R_low", "I_low", "I_delta", "S"), got, want):
            check_close(f"model 64^2 card vs CPU, {name}", a.cpu(), b, 1e-4)
        del kernel_model, plain_model, bkernel_model, bplain_model

        # ---- the pipelines on the card, with cuDNN's deterministic algorithms ----
        torch.backends.cudnn.deterministic = True
        bcoeffs = loss_coeffs(bt)
        runs = []
        for chunked in (False, True):
            m = build_model(bt, BANDS, dev, train=True)
            m.load_state_dict(sd)
            opt = make_optimizer(m, lr)
            if chunked:
                terms = multistep_train_step(m, opt, bcubes, bdraws, range(2), bt.batch_size,
                                             bt.patch_size, bcoeffs)
            else:
                t0, t1 = (fused_train_step(m, opt, bcubes, bdraws[i], i * bt.batch_size,
                                           bt.patch_size, bcoeffs) for i in range(2))
                terms = {k: t0[k] + t1[k] for k in LOSS_KEYS}
            runs.append((m.state_dict(), terms))
        same = (all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
                and all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in LOSS_KEYS))
        log(f"bf16 b8: a 2-step multistep chunk equals two single fused steps bit for bit: {same}")
        if not same:
            raise AssertionError("the multistep chunk differs from two single fused steps")

        # One float32 fused step on the card and on the CPU, same draw table,
        # at 64 bands on four 40x40 cubes, b2, 32^2 patches: the batch bit
        # for bit; terms within rtol 1e-4 and gradients within 2e-2 of each
        # scale (float32 sums in another order, as above).
        small_cubes = np.random.default_rng(SEED).random((4, 40, 40, BANDS), dtype=np.float32)
        small_draws = fused_draws(41, 0, 2, 2, (40, 40), 32)
        small_cfg = dataclasses.replace(tcfg, patch_size=32)
        steps = {}
        for d in (dev, torch.device("cpu")):
            m = build_model(small_cfg, BANDS, d, train=True)
            m.load_state_dict(weights.state_dict())
            cubes_d, draws_d = torch.from_numpy(small_cubes).to(d), torch.from_numpy(small_draws).to(d)
            batch = sample_fused_batch(cubes_d, draws_d[1], 2, 32)
            terms = fused_train_step(m, make_optimizer(m, lr), cubes_d, draws_d[1], 2, 32, coeffs)
            steps[d.type] = (batch.cpu(), {k: float(v) for k, v in terms.items()},
                             {n: p.grad.cpu() for n, p in m.named_parameters()})
        if not torch.equal(steps["cuda"][0], steps["cpu"][0]):
            raise AssertionError("the fused batch differs between the card and the CPU")
        term_err = max(abs(steps["cuda"][1][k] / steps["cpu"][1][k] - 1) for k in LOSS_KEYS)
        ggmax = max(float(v.abs().max()) for v in steps["cpu"][2].values())
        grad_err = max(float((steps["cuda"][2][n] - v).abs().max())
                       / max(float(v.abs().max()), 1e-8 * ggmax) for n, v in steps["cpu"][2].items())
        log(f"fused step card vs CPU (4 x 40^2 x 64 cubes, b2, 32^2): batch bit for bit, terms "
            f"rtol {term_err:.3e} (tolerance 1e-4), gradients {grad_err:.3e} of each scale "
            f"(tolerance 2e-2)")
        if not (term_err <= 1e-4 and grad_err <= 2e-2):
            raise AssertionError("the fused step differs between the card and the CPU")

        # remat: one float32 step at the stock shape with and without it.
        remat_runs = {}
        for remat in (False, True):
            m = build_model(dataclasses.replace(tcfg, remat=remat), BANDS, dev, train=True)
            m.load_state_dict(sd)
            opt = make_optimizer(m, lr)
            zero_counts(conv9, attention)
            terms = train_step(m, opt, xt, coeffs)
            torch.cuda.synchronize()
            remat_runs[remat] = (read_counts(conv9, attention), terms,
                                 {n: p.grad for n, p in m.named_parameters()})
        for remat, want_conv9 in ((False, 3), (True, 5)):
            check_launches(f"train step remat={remat}", remat_runs[remat][0], "float32",
                           {"conv9": (want_conv9, want_conv9), "conv9_wgrad": (2, 2)})
        g0 = remat_runs[False][2]
        rgmax = max(float(v.abs().max()) for v in g0.values())
        remat_err = max(float((remat_runs[True][2][n] - v).abs().max())
                        / max(float(v.abs().max()), 1e-8 * rgmax) for n, v in g0.items())
        remat_terms = max(abs(float(remat_runs[True][1][k]) / float(remat_runs[False][1][k]) - 1)
                          for k in LOSS_KEYS)
        log(f"remat step vs plain step (b2 x 128^2, float32): conv9 launches 5 vs 3 (2 recomputed "
            f"forwards), terms rtol {remat_terms:.3e}, gradients {remat_err:.3e} of each scale "
            f"(tolerance 1e-6 and 1e-4: float32 rounding)")
        if not (remat_terms <= 1e-6 and remat_err <= 1e-4):
            raise AssertionError("the remat step differs from the step without it")
        torch.backends.cudnn.deterministic = False

        # ---- times (CUDA events, after warm-up) ----
        def step_times(what, paths, batch, coeffs, mpb, names=("kernel", "plain"),
                       setup=lambda name: None):
            """``setup(name)`` before each of a path's timings (the TF32 switches)."""
            a, b = names
            step_ms = {a: [], b: []}
            for name in (a, b, b, a):      # in turns
                m, opt, _ = paths[name]
                setup(name)
                step_ms[name].append(time_ms(lambda: train_step(m, opt, batch, coeffs), 10, warmup=3))
            for name, times in step_ms.items():
                ms = sum(times) / len(times)
                log(f"train step ({name} path, {what}): {ms:.4f} ms (runs {times}), "
                    f"{mpb / (ms / 1e3):.2f} MPB/s")
            # Device time and host dispatch time of one step, apart: the card
            # is parked on a ~100 ms sleep kernel, so the whole step queues
            # behind it. The host clock then reads the dispatch alone (a hidden
            # sync would show as ~100 ms), and the events read the device's
            # work alone.
            split_ms = {a: [], b: []}
            for name in (a, b, b, a) * 3:
                m, opt, _ = paths[name]
                setup(name)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(200_000_000)
                t0 = time.perf_counter()
                start.record()
                train_step(m, opt, batch, coeffs)
                end.record()
                host_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                split_ms[name].append((start.elapsed_time(end), host_ms))
            for name, pairs in split_ms.items():
                dev_ms = sorted(d for d, _ in pairs)[len(pairs) // 2]
                host_ms = sorted(h for _, h in pairs)[len(pairs) // 2]
                log(f"train step ({name} path, {what}), medians of {len(pairs)}: device "
                    f"{dev_ms:.4f} ms, host dispatch {host_ms:.4f} ms (pairs "
                    f"{[(round(d, 3), round(h, 3)) for d, h in pairs]})")

        mpb = tcfg.batch_size * tcfg.patch_size ** 2 * BANDS / 1e6
        step_times("b2 x 128^2 x 64, float32", paths, xt, coeffs, mpb)
        # The TF32 step against the float32 step, both on the kernel path, in
        # turns, the switches set for each; then both traced, by kernel class.
        step_cfgs = {"tf32": t32cfg, "kernel": tcfg}
        try:
            step_times("b2 x 128^2 x 64, matmul_precision tensorfloat32 vs float32", paths, xt,
                       coeffs, mpb, names=("tf32", "kernel"),
                       setup=lambda name: set_matmul_precision(step_cfgs[name]))
            traced = {}
            for name in ("tf32", "kernel"):
                m, opt, _ = paths[name]
                set_matmul_precision(step_cfgs[name])
                train_step(m, opt, xt, coeffs)
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    for _ in range(2):
                        train_step(m, opt, xt, coeffs)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(f"./step_{name}.json")
                traced[name] = trace_device_ops(f"./step_{name}.json", top=10 ** 6)
        finally:
            set_matmul_precision(tcfg)
        for name, (rows_, classes, total_ms) in traced.items():
            log(f"train step ({'TF32' if name == 'tf32' else 'float32'}, kernel path) traced, 2 "
                f"steps: {total_ms / 2:.4f} ms of kernels a step")
            for cls, ms in sorted(classes.items(), key=lambda r: -r[1]):
                log(f"  class {ms / 2:9.4f} ms a step {100 * ms / total_ms:5.1f}%  {cls}")
        cudnn = {name: sorted({r[0] for r in rows_ if kernel_class(r[0]) == "convolutions (cuDNN)"})
                 for name, (rows_, _, _) in traced.items()}
        cublas = {name: sorted({r[0] for r in rows_ if kernel_class(r[0]) == "matrix products (cuBLAS)"})
                  for name, (rows_, _, _) in traced.items()}
        for name in ("tf32", "kernel"):
            for what, names_ in (("cuDNN", cudnn[name]), ("cuBLAS", cublas[name])):
                log(f"  {what} kernels of the {'TF32' if name == 'tf32' else 'float32'} step: "
                    + "; ".join(n[:110] for n in names_))
        named = {name: [n for n in cudnn[name] if "tf32" in n.lower()] for name in cudnn}
        if named["tf32"]:
            log(f"cuDNN names say TF32: {len(named['tf32'])} of the TF32 step's {len(cudnn['tf32'])} "
                f"cuDNN kernels, {len(named['kernel'])} of the float32 step's {len(cudnn['kernel'])}")
            if named["kernel"]:
                raise AssertionError(f"the float32 step ran TF32 cuDNN kernels: {named['kernel']}")
        else:
            log("cuDNN's kernel names do not say whether they run TF32: not asserted")
        check_switches("after the TF32 step times", False)
        m, opt, _ = paths["kernel"]
        # The real loop (Trainer.fit) on the host pipeline: crop and augment on
        # the host, pin, upload without blocking, enqueue the step; the host
        # clock splits it. PatchSampler's numpy stream (sampler: python) and
        # the native sampler (sampler: auto and native) on the same cubes.
        native_sampler = NativePatchSampler(store, tcfg.batch_size, tcfg.patch_size, seed=SEED)
        for host_sampler in (sampler, native_sampler):
            n_steps = 20
            host = {"crop": 0.0, "pin": 0.0, "enqueue": 0.0}
            torch.cuda.synchronize()
            start = time.perf_counter()
            for i in range(n_steps):
                t0 = time.perf_counter()
                host_batch = host_sampler.sample_batch(i % host_sampler.num_batches)
                t1 = time.perf_counter()
                batch = torch.from_numpy(host_batch).pin_memory()
                t2 = time.perf_counter()
                train_step(m, opt, batch.to(dev, non_blocking=True), coeffs)
                t3 = time.perf_counter()
                host["crop"] += t1 - t0
                host["pin"] += t2 - t1
                host["enqueue"] += t3 - t2
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) / n_steps * 1e3
            split = {k: v / n_steps * 1e3 for k, v in host.items()}
            log(f"train step with the host sampler {type(host_sampler).__name__}: {wall_ms:.4f} ms "
                f"a step on the host clock; host crop+augment {split['crop']:.4f} ms "
                f"({100 * split['crop'] / wall_ms:.1f}%), pin {split['pin']:.4f} ms "
                f"({100 * split['pin'] / wall_ms:.1f}%), upload and step enqueue "
                f"{split['enqueue']:.4f} ms ({100 * split['enqueue'] / wall_ms:.1f}%)")

        def fused_loop_ms(m, opt, cubes, c, coeffs, k_steps, n_steps=20):
            """The real loop (Trainer.fit) on the fused pipeline, host clock a step."""
            draws = torch.from_numpy(fused_draws(SEED, 0, n_steps, c.batch_size,
                                                 tuple(cubes.shape[1:3]), c.patch_size)).to(dev)
            multistep_train_step(m, opt, cubes, draws, range(k_steps), c.batch_size,
                                 c.patch_size, coeffs)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for c0 in range(0, n_steps, k_steps):
                multistep_train_step(m, opt, cubes, draws, range(c0, min(c0 + k_steps, n_steps)),
                                     c.batch_size, c.patch_size, coeffs)
            torch.cuda.synchronize()
            return (time.perf_counter() - start) / n_steps * 1e3

        cubes4 = stack_cubes(store, dev)
        f_ms = fused_loop_ms(m, opt, cubes4, tcfg, coeffs, 1)
        log(f"train step on the fused pipeline (b2 x 128^2 x 64, float32, kernel path): {f_ms:.4f} "
            f"ms a step on the host clock, {mpb / (f_ms / 1e3):.2f} MPB/s")
        del cubes4
        bmpb = bt.batch_size * bt.patch_size ** 2 * BANDS / 1e6
        step_times("b8 x 128^2 x 64, bfloat16", bpaths, xt8, bcoeffs, bmpb)
        bm, bopt, _ = bpaths["kernel"]
        bf_ms = fused_loop_ms(bm, bopt, bcubes, bt, bcoeffs, bt.steps_per_dispatch)
        log(f"train step on the fused pipeline (b8 x 128^2 x 64, bfloat16, kernel path, 2 steps "
            f"a dispatch): {bf_ms:.4f} ms a step on the host clock, "
            f"{bmpb / (bf_ms / 1e3):.2f} MPB/s")

        def conv_bound(xx, out_bytes=None):
            """(operations, bytes, exponentials) of one k9 conv pass over xx."""
            b, h, wd_, c = xx.shape
            e = xx.element_size()
            out = e * xx.numel() if out_bytes is None else out_bytes
            return 2.0 * b * h * wd_ * 81 * c * c, e * (xx.numel() + 81 * c * c) + out, 0.0

        def wgrad_bound(xx):
            """x and dy read once, dW (float32) written once."""
            b, h, wd_, c = xx.shape
            return 2.0 * b * h * wd_ * 81 * c * c, 2.0 * xx.element_size() * xx.numel() + 4 * 81 * c * c, 0.0

        def wide_bound(xx, dw_bytes):
            """A k9 Cin -> 64 pass over xx: x and w (or dy) read once, y (or dW)
            written once; ``dw_bytes``: the weight gradient's, dW in float32."""
            b, h, wd_, c = xx.shape
            e, pixels = xx.element_size(), b * h * wd_
            return (2.0 * pixels * 81 * c * 64,
                    e * pixels * (c + 64) + (4 if dw_bytes else e) * 81 * c * 64, 0.0)

        def flash_bound(q):
            return flash_work(q.shape, q.element_size())

        xc, wc = x.permute(0, 3, 1, 2), w9.permute(3, 2, 0, 1).contiguous()
        x4c, x2c, x1024c = x4.permute(0, 3, 1, 2), x2.permute(0, 3, 1, 2), x1024.permute(0, 3, 1, 2)
        xtc, gtc = xt.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2)
        x1c, g1c = x1.permute(0, 3, 1, 2), g1.permute(0, 3, 1, 2)
        xsc, gsc, x264c = xs.permute(0, 3, 1, 2), gs.permute(0, 3, 1, 2), x264.permute(0, 3, 1, 2)
        wdc = wd.permute(3, 2, 0, 1).contiguous()
        x224c, g224c = x224.permute(0, 3, 1, 2), g224.permute(0, 3, 1, 2)
        w224c = w224.permute(3, 2, 0, 1).contiguous()
        wide_shape = (*x224.shape, 64)
        cl = torch.channels_last
        xcb, xcb1024 = xb.permute(0, 3, 1, 2), xb1024.permute(0, 3, 1, 2)
        wcb = w9b.permute(3, 2, 0, 1).contiguous(memory_format=cl)
        xt8c, gt8c = xt8b.permute(0, 3, 1, 2), gt8b.permute(0, 3, 1, 2)

        q, k, v = qkv
        q2, k2, v2 = qkv_1024
        qb, kbb, vb = qkvb
        qb2, kbb2, vb2 = qkvb_1024
        rows, row_keys, f32_parts = [], [], {}
        conv9_src, conv9_rep = "sshslie_torch/csrc/conv9.cu", "sshslie_tpu/ops/conv_pallas.py:147"
        wgrad_src, wgrad_rep = "sshslie_torch/csrc/conv9_wgrad.cu", "sshslie_tpu/ops/conv_pallas.py:215"
        flash_src, flash_rep = "sshslie_torch/csrc/flash_attn.cu", "sshslie_tpu/ops/attention.py:169"
        # The JAX gate sends a 224-band shallow conv to lax.conv_general_dilated.
        WIDE_REP = "sshslie_tpu/models/layers.py:79"
        for name, src, replaces, key, count, fn, plain, lib, work_, peak in (
                ("conv9 (1,512,512,64) forward", conv9_src, conv9_rep, "conv9_512", ("conv9", "forward", x),
                 lambda: conv9.conv9_fwd(x, w9), lambda: conv9.conv9_plain(x, w9),
                 lambda: F.conv2d(xc, wc, padding=4), conv_bound(x), PEAK_F32_FLOPS),
                ("conv9 (2,128,128,64) forward", conv9_src, conv9_rep, "conv9_128", ("conv9", "forward", xt),
                 lambda: conv9.conv9_fwd(xt, w9), lambda: conv9.conv9_plain(xt, w9),
                 lambda: F.conv2d(xtc, wc, padding=4), conv_bound(xt), PEAK_F32_FLOPS),
                ("conv9 (2,128,128,64) dgrad", conv9_src, conv9_rep, "dgrad_128", ("conv9", "dgrad", gt),
                 lambda: conv9.conv9_fwd(gt, wd), lambda: conv9.conv9_plain(gt, wd),
                 lambda: torch.nn.grad.conv2d_input(xtc.shape, wc, gtc, padding=4), conv_bound(gt),
                 PEAK_F32_FLOPS),
                ("conv9_wgrad (2,128,128,64)", wgrad_src, wgrad_rep, "wgrad_128", ("conv9_wgrad", "wgrad", xt),
                 lambda: conv9.conv9_wgrad(xt, gt, 9), lambda: conv9.conv9_wgrad_plain(xt, gt, 9),
                 lambda: torch.nn.grad.conv2d_weight(xtc, wc.shape, gtc, padding=4), conv_bound(xt),
                 PEAK_F32_FLOPS),
                # b = 1 a rank: data-parallel training over two ranks (path 9 (b)).
                ("conv9 (1,128,128,64) forward, data parallel", conv9_src, conv9_rep, "conv9_128_b1",
                 ("conv9", "forward", x1), lambda: conv9.conv9_fwd(x1, w9),
                 lambda: conv9.conv9_plain(x1, w9), lambda: F.conv2d(x1c, wc, padding=4),
                 conv_bound(x1), PEAK_F32_FLOPS),
                ("conv9 (1,128,128,64) dgrad, data parallel", conv9_src, conv9_rep, "dgrad_128_b1",
                 ("conv9", "dgrad", g1), lambda: conv9.conv9_fwd(g1, wd),
                 lambda: conv9.conv9_plain(g1, wd),
                 lambda: torch.nn.grad.conv2d_input(x1c.shape, wc, g1c, padding=4), conv_bound(g1),
                 PEAK_F32_FLOPS),
                ("conv9_wgrad (1,128,128,64), data parallel", wgrad_src, wgrad_rep, "wgrad_128_b1",
                 ("conv9_wgrad", "wgrad", x1), lambda: conv9.conv9_wgrad(x1, g1, 9),
                 lambda: conv9.conv9_wgrad_plain(x1, g1, 9),
                 lambda: torch.nn.grad.conv2d_weight(x1c, wc.shape, g1c, padding=4),
                 wgrad_bound(x1), PEAK_F32_FLOPS),
                # A rank's rows plus the halo: dp x sp training over two ranks
                # (path 9 (d)) and the height-sharded test phase (path 9 (e)).
                ("conv9 (2,72,128,64) forward, dp x sp", conv9_src, conv9_rep, "conv9_72",
                 ("conv9", "forward", xs), lambda: conv9.conv9_fwd(xs, w9),
                 lambda: conv9.conv9_plain(xs, w9), lambda: F.conv2d(xsc, wc, padding=4),
                 conv_bound(xs), PEAK_F32_FLOPS),
                ("conv9 (2,72,128,64) dgrad, dp x sp", conv9_src, conv9_rep, "dgrad_72",
                 ("conv9", "dgrad", gs), lambda: conv9.conv9_fwd(gs, wd),
                 lambda: conv9.conv9_plain(gs, wd),
                 lambda: torch.nn.grad.conv2d_input(xsc.shape, wc, gsc, padding=4), conv_bound(gs),
                 PEAK_F32_FLOPS),
                ("conv9_wgrad (2,72,128,64), dp x sp", wgrad_src, wgrad_rep, "wgrad_72",
                 ("conv9_wgrad", "wgrad", xs), lambda: conv9.conv9_wgrad(xs, gs, 9),
                 lambda: conv9.conv9_wgrad_plain(xs, gs, 9),
                 lambda: torch.nn.grad.conv2d_weight(xsc, wc.shape, gsc, padding=4),
                 wgrad_bound(xs), PEAK_F32_FLOPS),
                ("conv9 (1,264,512,64) forward, height-sharded test", conv9_src, conv9_rep,
                 "conv9_264", ("conv9", "forward", x264), lambda: conv9.conv9_fwd(x264, w9),
                 lambda: conv9.conv9_plain(x264, w9), lambda: F.conv2d(x264c, wc, padding=4),
                 conv_bound(x264), PEAK_F32_FLOPS),
                # 224-band cubes (path 10): the wide float32 entries, Cin -> 64.
                ("conv9 (8,128,128,224) -> 64 forward, 224 bands", conv9_src, WIDE_REP, "conv9_224",
                 ("conv9", "wide_forward", x224, "float32", wide_shape),
                 lambda: conv9.conv9_fwd(x224, w224), lambda: conv9.conv9_plain(x224, w224),
                 lambda: F.conv2d(x224c, w224c, padding=4), wide_bound(x224, False), PEAK_F32_FLOPS),
                ("conv9_wgrad (8,128,128,224) -> (9,9,224,64), 224 bands", wgrad_src, WIDE_REP,
                 "wgrad_224", ("conv9_wgrad", "wide_wgrad", x224, "float32", wide_shape),
                 lambda: conv9.conv9_wgrad(x224, g224, 9),
                 lambda: conv9.conv9_wgrad_plain(x224, g224, 9),
                 lambda: torch.nn.grad.conv2d_weight(x224c, w224c.shape, g224c, padding=4),
                 wide_bound(x224, True), PEAK_F32_FLOPS),
                ("flash_attention (1,4,4096,16)", flash_src, flash_rep, "flash", ("flash_attention", "forward", q),
                 lambda: attention.flash_attention(q, k, v), lambda: attention.sdpa_chunked(q, k, v),
                 lambda: F.scaled_dot_product_attention(q, k, v), flash_bound(q), PEAK_F32_FLOPS),
                # S = 16384 and batches of 4 come only from serving.
                ("flash_attention (1,4,16384,16), serving at 1024^2", flash_src, flash_rep,
                 "flash_1024", ("flash_attention", "forward", q2),
                 lambda: attention.flash_attention(q2, k2, v2),
                 lambda: attention.sdpa_chunked(q2, k2, v2),
                 lambda: F.scaled_dot_product_attention(q2, k2, v2), flash_bound(q2), PEAK_F32_FLOPS),
                ("conv9 (4,512,512,64) forward, micro-batched serving", conv9_src, conv9_rep,
                 "conv9_b4", ("conv9", "forward", x4), lambda: conv9.conv9_fwd(x4, w9),
                 lambda: conv9.conv9_plain(x4, w9), lambda: F.conv2d(x4c, wc, padding=4),
                 conv_bound(x4), PEAK_F32_FLOPS),
                ("conv9 (1,1024,1024,64) forward, serving at 1024^2", conv9_src, conv9_rep,
                 "conv9_1024", ("conv9", "forward", x1024), lambda: conv9.conv9_fwd(x1024, w9),
                 lambda: conv9.conv9_plain(x1024, w9), lambda: F.conv2d(x1024c, wc, padding=4),
                 conv_bound(x1024), PEAK_F32_FLOPS),
                ("conv9 (2,512,512,64) forward, micro-batched serving", conv9_src, conv9_rep,
                 "conv9_b2", ("conv9", "forward", x2), lambda: conv9.conv9_fwd(x2, w9),
                 lambda: conv9.conv9_plain(x2, w9), lambda: F.conv2d(x2c, wc, padding=4),
                 conv_bound(x2), PEAK_F32_FLOPS),
                ("flash_attention (2,4,4096,16), micro-batched serving", flash_src, flash_rep,
                 "flash_b2", ("flash_attention", "forward", qkv2[0]),
                 lambda: attention.flash_attention(*qkv2), lambda: attention.sdpa_chunked(*qkv2),
                 lambda: F.scaled_dot_product_attention(*qkv2), flash_bound(qkv2[0]),
                 PEAK_F32_FLOPS),
                ("flash_attention (4,4,4096,16), micro-batched serving", flash_src, flash_rep,
                 "flash_b4", ("flash_attention", "forward", qkv4[0]), lambda: attention.flash_attention(*qkv4),
                 lambda: attention.sdpa_chunked(*qkv4),
                 lambda: F.scaled_dot_product_attention(*qkv4), flash_bound(qkv4[0]),
                 PEAK_F32_FLOPS),
                ("conv9 bf16 (1,512,512,64) forward", conv9_src, conv9_rep, "conv9_512_bf16",
                 ("conv9", "forward", xb), lambda: conv9.conv9_fwd(xb, w9b), lambda: conv9.conv9_plain(xb, w9b),
                 lambda: F.conv2d(xcb, wcb, padding=4), conv_bound(xb), PEAK_BF16_FLOPS),
                ("conv9 bf16 (1,1024,1024,64) forward, serving at 1024^2", conv9_src, conv9_rep,
                 "conv9_1024_bf16", ("conv9", "forward", xb1024),
                 lambda: conv9.conv9_fwd(xb1024, w9b), lambda: conv9.conv9_plain(xb1024, w9b),
                 lambda: F.conv2d(xcb1024, wcb, padding=4), conv_bound(xb1024), PEAK_BF16_FLOPS),
                ("conv9 bf16 (8,128,128,64) forward", conv9_src, conv9_rep, "conv9_128_bf16",
                 ("conv9", "forward", xt8b), lambda: conv9.conv9_fwd(xt8b, w9b),
                 lambda: conv9.conv9_plain(xt8b, w9b),
                 lambda: F.conv2d(xt8c, wcb, padding=4), conv_bound(xt8b), PEAK_BF16_FLOPS),
                ("conv9 bf16 (8,128,128,64) dgrad", conv9_src, conv9_rep, "dgrad_128_bf16",
                 ("conv9", "dgrad", gt8b), lambda: conv9.conv9_fwd(gt8b, wdb),
                 lambda: conv9.conv9_plain(gt8b, wdb),
                 lambda: torch.nn.grad.conv2d_input(xt8c.shape, wcb, gt8c, padding=4),
                 conv_bound(gt8b), PEAK_BF16_FLOPS),
                ("conv9_wgrad bf16 (8,128,128,64)", wgrad_src, wgrad_rep, "wgrad_128_bf16",
                 ("conv9_wgrad", "wgrad", xt8b), lambda: conv9.conv9_wgrad(xt8b, gt8b, 9),
                 lambda: conv9.conv9_wgrad_plain(xt8b, gt8b, 9),
                 lambda: torch.nn.grad.conv2d_weight(xt8c, wcb.shape, gt8c, padding=4),
                 wgrad_bound(xt8b), PEAK_BF16_FLOPS),
                ("flash_attention bf16 (1,4,4096,16)", flash_src, flash_rep, "flash_bf16",
                 ("flash_attention", "forward", qb), lambda: attention.flash_attention(qb, kbb, vb),
                 lambda: attention.sdpa_chunked(qb, kbb, vb),
                 lambda: F.scaled_dot_product_attention(qb, kbb, vb), flash_bound(qb),
                 PEAK_BF16_FLOPS),
                ("flash_attention bf16 (1,4,16384,16), serving at 1024^2", flash_src, flash_rep,
                 "flash_1024_bf16", ("flash_attention", "forward", qb2),
                 lambda: attention.flash_attention(qb2, kbb2, vb2),
                 lambda: attention.sdpa_chunked(qb2, kbb2, vb2),
                 lambda: F.scaled_dot_product_attention(qb2, kbb2, vb2), flash_bound(qb2),
                 PEAK_BF16_FLOPS),
                # The TF32 entries; their library calls run with cuDNN's TF32 on.
                ("conv9 tf32 (1,512,512,64) forward", conv9_src, conv9_rep, "conv9_512_tf32",
                 ("conv9", "forward", x, "tf32"), lambda: conv9.conv9_fwd(x, w9, tf32=True),
                 lambda: conv9.conv9_plain(x, w9, tf32=True),
                 lambda: F.conv2d(xc, wc, padding=4), conv_bound(x), PEAK_TF32_FLOPS),
                ("conv9 tf32 (2,128,128,64) forward", conv9_src, conv9_rep, "conv9_128_tf32",
                 ("conv9", "forward", xt, "tf32"), lambda: conv9.conv9_fwd(xt, w9, tf32=True),
                 lambda: conv9.conv9_plain(xt, w9, tf32=True),
                 lambda: F.conv2d(xtc, wc, padding=4), conv_bound(xt), PEAK_TF32_FLOPS),
                ("conv9 tf32 (2,128,128,64) dgrad", conv9_src, conv9_rep, "dgrad_128_tf32",
                 ("conv9", "dgrad", gt, "tf32"), lambda: conv9.conv9_fwd(gt, wd, tf32=True),
                 lambda: conv9.conv9_plain(gt, wd, tf32=True),
                 lambda: torch.nn.grad.conv2d_input(xtc.shape, wc, gtc, padding=4), conv_bound(gt),
                 PEAK_TF32_FLOPS),
                ("conv9_wgrad tf32 (2,128,128,64)", wgrad_src, wgrad_rep, "wgrad_128_tf32",
                 ("conv9_wgrad", "wgrad", xt, "tf32"), lambda: conv9.conv9_wgrad(xt, gt, 9, tf32=True),
                 lambda: conv9.conv9_wgrad_plain(xt, gt, 9, tf32=True),
                 lambda: torch.nn.grad.conv2d_weight(xtc, wc.shape, gtc, padding=4),
                 wgrad_bound(xt), PEAK_TF32_FLOPS)):
            ms = time_ms(fn, 20)
            plain_ms = time_ms(plain, 5)
            if peak == PEAK_TF32_FLOPS:
                set_matmul_precision(t32cfg)
            try:
                library_ms = time_ms(lib, 20)
            finally:
                set_matmul_precision(tcfg)
            flops, nbytes, exps = work_
            bound, bound_by = bound_ms(work_, peak)
            # (kernel, pass, operand[, label[, shape as counted]])
            kernel_name, role, t_, *rest = count
            label = rest[0] if rest else str(t_.dtype).replace("torch.", "")
            if kernel_name == "conv9" and label == "float32":
                f32_parts[name] = conv9.conv9_f32_parts(
                    *t_.shape[:3], 9, conv9.f32_resident(t_.device, 9, wide=role.startswith("wide")))
            row_key = (kernel_name, role, label, rest[1] if len(rest) > 1 else tuple(t_.shape))
            row_keys.append(row_key)
            launches = MAIN_SHAPES.get(row_key, 0)
            rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "launches": launches,
                         "max_abs_err": errs[key], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": library_ms})
            log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
                f"bound {bound:.4f} ms ({flops:.3e} FLOP, {nbytes:.3e} B, "
                f"{exps:.3e} exp)")
        # Under matmul_precision below float32 the flash kernel runs its
        # float32 entry (the row above); its yardstick there is SDPA with the
        # TF32 switches on, on the same inputs.
        set_matmul_precision(t32cfg)
        try:
            sdpa_tf32_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
        finally:
            set_matmul_precision(tcfg)
        check_switches("after the TF32 SDPA timing", False)
        log(f"flash_attention (1,4,4096,16) float32 under TF32: library SDPA with the TF32 "
            f"switches on {sdpa_tf32_ms:.4f} ms ({card})")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    log(f"launches on the main paths: float32 test {test_counts}, float32 train_and_test "
        f"{train_counts}, float32 engine run {engine_counts}, bfloat16 test {btest_counts}, "
        f"bfloat16 train_and_test {btrain_counts}, serving {served['counts']}, TF32 "
        f"{tf32_counts}, disk-backed data {disk_counts}, path 9 (every rank) {multi_counts}; by "
        f"(kernel, pass, dtype, shape) "
        f"{MAIN_SHAPES}")
    # Each row's launches are those the wrappers counted at its shape on the
    # main paths: every row's shape is one the main paths ran, and every shape
    # the main paths ran has its row (held against the plain version above).
    unlaunched = [r["name"] for r in rows if r["launches"] == 0]
    unheld = sorted(set(MAIN_SHAPES) - set(row_keys))
    if unlaunched or unheld:
        raise AssertionError(f"kernel rows with no main-path launch at their shape: {unlaunched}; "
                             f"main-path shapes without a row: {unheld}")
    log(f"float32 conv9 splits chosen (output-channel parts of a 4 x 32 tile; {card}, (SMs, blocks "
        f"an SM) {conv9.f32_resident(torch.device('cuda'), 9)}): "
        + ", ".join(f"{r['name']} {f32_parts[r['name']]}" for r in rows if r["name"] in f32_parts))
    log(f"chip_smoke total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-worker"]:
        sys.exit(cli_worker(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
