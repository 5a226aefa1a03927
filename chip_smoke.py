#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``sshslie_torch`` (and nothing of the JAX package) through both of its
main paths at the stock configuration's full width: 64 bands, channel 64, the
TransformerBlock, random weights from a seed, float32 with TF32 off.

1. Card: prints the card's name and power limit, sets both TF32 switches off.
2. Kernels: builds every ``sshslie_torch/csrc/*.cu`` with nvcc (in parallel).
3. Inputs: a synthetic dataset in a temporary directory (raw values
   238..4095, numpy seed): four 512x512x64 training cubes, two 512x512x64
   test cubes with their ground truth (also the eval set), and a
   ``model_epoch_latest.pth`` of seeded weights for the test phase.
4. Main path, test phase: ``runner.main`` with ``phase: test``. The launch
   counts are set to 0 just before and read just after; conv9 and flash must
   have launched. The saved S cubes must be finite and of the right shape,
   PSNR, SSIM and SAM finite.
5. Main path, training: ``runner.main`` with ``phase: train_and_test`` and the
   stock ``config/config.yml`` values (batch 2, 128^2 patches, start_lr 1e-3,
   the six loss weights and both alphas), ``epoch: 2`` and
   ``eval_every_epoch: 1``: 4 steps, 2 evals, then the test phase from the
   checkpoint the run wrote. Counts set to 0 before and read after: conv9 at
   least 3 a step (2 forwards, 1 input gradient) plus one a cube evaluated or
   tested, conv9_wgrad exactly 2 a step, flash at least once. Every epoch's
   7 average terms finite; model_epoch_1/2/latest.pth with a non-empty
   optimizer state; the test phase's S cubes and scores finite.
6. Kernels against their plain versions on the card, each with its stated
   tolerance; ShallowConv's and FlashAttention's gradients against autograd
   through the plain versions; one whole train step on the kernel path
   against the plain path (``conv_impl: torch``, ``attention_impl: dense``);
   the whole model at 512^2 on the kernel path against the plain path, and
   on the card against the CPU on a small cube.
7. Times by CUDA events after warm-up: the warm train step on both paths,
   its megapixel*bands/s and the share of a step the host spends sampling;
   each kernel at the main path's shapes (flash attention also at
   (1, 4, 16384, 16), the S of a 1024^2 cube), its plain version and one library
   call (cuDNN ``F.conv2d``, ``conv2d_input``, ``conv2d_weight``,
   ``F.scaled_dot_product_attention``) as a yardstick only; the port never
   calls those.

Prints one JSON line of kernels, then the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
the last line. Needs one CUDA card, nvcc and the repository's files.
"""

from __future__ import annotations

import dataclasses
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
GLOBAL_MIN, GLOBAL_MAX = 238.0, 4095.0   # config/config.yml
PEAK_F32_FLOPS = 67e12                   # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12                     # H100 SXM HBM3
# The training values of config/config.yml.
STOCK_TRAIN = dict(
    seed_value=41, batch_size=2, patch_size=128, start_lr=1e-3, lr_update_factor=0.1,
    lr_update_period=250, c_loss_reconstruction=10.0, c_loss_r_fidelity=1.0,
    c_loss_i_smooth_low=1.0, c_loss_i_smooth_delta=2000.0, c_loss_fourier=20.0,
    c_loss_spectral_cons=1.0, alpha_i_smooth_low=1.0, alpha_i_smooth_delta=10.0,
    save_reflectance=True, save_illumination=True, precision="float32")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    for sub in ("low/train", "low/test", "high/test"):
        os.makedirs(os.path.join(root, "data", sub), exist_ok=True)
    for i in range(2 + N_TRAIN):
        # A smooth spectral scene under a darkening illumination, plus noise.
        coarse = rng.random((SIZE // 32, SIZE // 32, BANDS), dtype=np.float32)
        scene = np.kron(coarse, np.ones((32, 32, 1), np.float32))
        illum = np.linspace(0.15, 0.4, SIZE, dtype=np.float32)[:, None, None]
        noise = rng.random((SIZE, SIZE, BANDS), dtype=np.float32)
        high = GLOBAL_MIN + (GLOBAL_MAX - GLOBAL_MIN) * (0.8 * scene + 0.2 * noise)
        low = GLOBAL_MIN + (high - GLOBAL_MIN) * illum
        if i < 2:
            sio.savemat(os.path.join(root, "data/low/test", f"cube{i}.mat"), {"data": low})
            sio.savemat(os.path.join(root, "data/high/test", f"cube{i}.mat"), {"data": high})
        else:
            sio.savemat(os.path.join(root, "data/low/train", f"train{i - 2}.mat"), {"data": low})


def read_counts(conv9, attention) -> dict:
    return {"conv9": conv9.conv9_fwd.launches, "conv9_wgrad": conv9.conv9_wgrad.launches,
            "flash_attention": attention.flash_attention.launches}


def zero_counts(conv9, attention) -> None:
    conv9.conv9_fwd.launches = conv9.conv9_wgrad.launches = attention.flash_attention.launches = 0


def check_saved_s(cfg, load_hsi, np) -> None:
    for i in range(2):
        out = load_hsi(os.path.join(cfg.test_result_dir, f"cube{i}.mat"), mat_key=cfg.mat_key_prediction)
        if out.shape != (SIZE, SIZE, BANDS) or not np.isfinite(out).all():
            raise AssertionError(f"saved S of cube{i}: shape {out.shape}, finite {np.isfinite(out).all()}")
    log(f"saved S cubes under {cfg.test_result_dir}: shape (512, 512, 64), finite")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from sshslie_torch import checkpoints, interop, runner
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore, PatchSampler
    from sshslie_torch.models.enhance import LowLightEnhanceNet, build_model
    from sshslie_torch.ops import _build, attention, conv9
    from sshslie_torch.train import LOSS_KEYS, loss_coeffs, make_optimizer, train_step
    from sshslie_torch.utils.io_hsi import load_hsi

    t_all = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

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
        cfg = load_config(None, dict(common, phase="test", test_timestamp="smoke",
                                     model_name="chip_smoke", save_reflectance=True,
                                     save_illumination=True, precision="float32", seed_value=41))
        weights = LowLightEnhanceNet(BANDS, generator=torch.Generator().manual_seed(SEED))
        os.makedirs(cfg.test_model_dir)
        interop.save_checkpoint(checkpoints.latest_path(cfg.test_model_dir), weights.state_dict(),
                                epoch=0)
        log(f"inputs written in {time.perf_counter() - t:.1f} s under {work}")

        # ---- main path 1: the port's test phase, launch counts read around it ----
        zero_counts(conv9, attention)
        t = time.perf_counter()
        result = runner.main(cfg)
        torch.cuda.synchronize()
        test_counts = read_counts(conv9, attention)
        log(f"main path (test): {time.perf_counter() - t:.2f} s; launches {test_counts}; "
            f"per-cube seconds {result['seconds']}")
        scores = result["scores"]
        log(f"PSNR {scores[0]!r}  SSIM {scores[1]!r}  SAM {scores[2]!r}")
        if not all(math.isfinite(s) for s in scores):
            raise AssertionError(f"non-finite scores {scores}")
        for name in ("conv9", "flash_attention"):
            if test_counts[name] <= 0:
                raise AssertionError(f"{name} kernel was not launched on the test phase")
        check_saved_s(cfg, load_hsi, np)

        # ---- main path 2: training, then the test phase from its checkpoint ----
        tcfg = load_config(None, dict(common, **STOCK_TRAIN, phase="train_and_test",
                                      train_data="./data/low/train", eval_data="./data/low/test",
                                      model_name="chip_smoke_train", epoch=2, eval_every_epoch=1))
        steps = tcfg.epoch * (N_TRAIN // tcfg.batch_size)
        cubes_run = 2 * tcfg.epoch + 2          # eval cubes at each epoch, then the test cubes
        zero_counts(conv9, attention)
        t = time.perf_counter()
        tresult = runner.main(tcfg)
        torch.cuda.synchronize()
        train_counts = read_counts(conv9, attention)
        trainer = tresult["trainer"]
        log(f"main path (train_and_test): {time.perf_counter() - t:.2f} s; {steps} steps; "
            f"launches {train_counts}; epoch (host s, wall s) {trainer.epoch_seconds}")
        if train_counts["conv9"] < 3 * steps + cubes_run:
            raise AssertionError(f"conv9 launched {train_counts['conv9']} times, expected at least "
                                 f"{3 * steps + cubes_run}")
        if train_counts["conv9_wgrad"] != 2 * steps:
            raise AssertionError(f"conv9_wgrad launched {train_counts['conv9_wgrad']} times, "
                                 f"expected {2 * steps}")
        if train_counts["flash_attention"] <= 0:
            raise AssertionError("flash attention was not launched in eval/test")
        for k in LOSS_KEYS:
            vals = trainer.all_epoch_losses[k]
            log(f"  {k}: {vals}")
            if len(vals) != tcfg.epoch or not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"epoch averages of {k}: {vals}")
        log(f"eval metrics {trainer.eval_metrics}")
        if sorted(trainer.eval_metrics) != [1, 2] or not all(
                math.isfinite(v) for m in trainer.eval_metrics.values() for v in m.values()):
            raise AssertionError(f"eval metrics {trainer.eval_metrics}")
        for name in ("model_epoch_1.pth", "model_epoch_2.pth", "model_epoch_latest.pth"):
            ck = torch.load(os.path.join(tcfg.test_model_dir, name), map_location="cpu",
                            weights_only=True)
            if not ck["optimizer_state_dict"]["state"]:
                raise AssertionError(f"{name}: empty optimizer state")
        log("checkpoints model_epoch_1/2/latest.pth hold the optimizer state")
        tscores = tresult["scores"]
        log(f"train_and_test: PSNR {tscores[0]!r}  SSIM {tscores[1]!r}  SAM {tscores[2]!r}")
        if not all(math.isfinite(s) for s in tscores):
            raise AssertionError(f"non-finite scores {tscores}")
        check_saved_s(tcfg, load_hsi, np)
        launches = {k: test_counts[k] + train_counts[k] for k in test_counts}

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
        # Sums over up to 262,144 pixels, in slices, in another order: 5e-5 of the scale.
        for key, what, xx, dy in (
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

        # One whole train step: the kernel path against the plain path, and
        # both against the plain path in float64. Float32 gradients of this
        # loss (L1 terms, c_loss_i_smooth_delta 2000) carry rounding of up to
        # ~7e-3 of their scale on any float32 path, and where that worst case
        # falls changes from run to run (cuDNN's backward is not
        # deterministic), so the kernel path is held to the float64 step at
        # 2e-2 of each gradient's scale, with the plain path's error beside
        # it; a wrong kernel pass would be off by ~1e-1 to 1 of the scale.
        coeffs = loss_coeffs(tcfg)
        lr = tcfg.start_lr
        sd = {k: v.to(dev) for k, v in weights.state_dict().items()}
        plain_cfg = dataclasses.replace(tcfg, conv_impl="torch", attention_impl="dense")
        paths = {}
        for name, c, dtype in (("kernel", tcfg, torch.float32), ("plain", plain_cfg, torch.float32),
                               ("float64", plain_cfg, torch.float64)):
            m = build_model(c, BANDS, dev, train=True).to(dtype)
            m.load_state_dict(sd)
            opt = make_optimizer(m, lr)
            paths[name] = (m, opt, train_step(m, opt, xt.to(dtype), coeffs))
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
        paths.pop("float64")

        plain_model = build_model(dataclasses.replace(cfg, conv_impl="torch", attention_impl="chunked"),
                                  BANDS, dev)
        kernel_model = build_model(cfg, BANDS, dev)
        for m in (plain_model, kernel_model):
            interop.load_checkpoint(checkpoints.latest_path(cfg.test_model_dir), m)
        with torch.inference_mode():
            got, want = kernel_model(x), plain_model(x)
        for name, a, b in zip(("R_low", "I_low", "I_delta", "S"), got, want):
            # Outputs of order 1 after ~20 float32 layers: 1e-4 absolute.
            check_close(f"model 512^2 kernel path vs plain path, {name}", a, b, 1e-4)
        cpu_model = build_model(cfg, BANDS, torch.device("cpu"))
        interop.load_checkpoint(checkpoints.latest_path(cfg.test_model_dir), cpu_model)
        small = x[:, :64, :64]
        with torch.inference_mode():
            got, want = kernel_model(small), cpu_model(small.cpu())
        for name, a, b in zip(("R_low", "I_low", "I_delta", "S"), got, want):
            check_close(f"model 64^2 card vs CPU, {name}", a.cpu(), b, 1e-4)

        # ---- times (CUDA events, after warm-up) ----
        mpb = tcfg.batch_size * tcfg.patch_size ** 2 * BANDS / 1e6
        step_ms = {"kernel": [], "plain": []}
        for name in ("kernel", "plain", "plain", "kernel"):      # in turns
            m, opt, _ = paths[name]
            step_ms[name].append(time_ms(lambda: train_step(m, opt, xt, coeffs), 10, warmup=3))
        for name, times in step_ms.items():
            ms = sum(times) / len(times)
            log(f"train step ({name} path, b2 x 128^2 x 64): {ms:.4f} ms (runs {times}), "
                f"{mpb / (ms / 1e3):.2f} MPB/s")
        # Device time and host dispatch time of one step, apart: the card is
        # parked on a ~100 ms sleep kernel, so the whole step queues behind it.
        # The host clock then reads the dispatch alone (a hidden sync would
        # show as ~100 ms), and the events read the device's work alone.
        split_ms = {"kernel": [], "plain": []}
        for name in ("kernel", "plain", "plain", "kernel") * 3:
            m, opt, _ = paths[name]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)
            t0 = time.perf_counter()
            start.record()
            train_step(m, opt, xt, coeffs)
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            split_ms[name].append((start.elapsed_time(end), host_ms))
        for name, pairs in split_ms.items():
            dev_ms = sorted(d for d, _ in pairs)[len(pairs) // 2]
            host_ms = sorted(h for _, h in pairs)[len(pairs) // 2]
            log(f"train step ({name} path), medians of {len(pairs)}: device {dev_ms:.4f} ms, "
                f"host dispatch {host_ms:.4f} ms (pairs {[(round(d, 3), round(h, 3)) for d, h in pairs]})")
        m, opt, _ = paths["kernel"]
        # The real loop (Trainer.fit): crop and augment on the host, pin,
        # upload without blocking, enqueue the step; the host clock splits it.
        n_steps = 20
        host = {"crop": 0.0, "pin": 0.0, "enqueue": 0.0}
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i in range(n_steps):
            t0 = time.perf_counter()
            host_batch = sampler.sample_batch(i % sampler.num_batches)
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
        log(f"train step with the host sampler: {wall_ms:.4f} ms a step on the host clock; host "
            f"crop+augment {split['crop']:.4f} ms ({100 * split['crop'] / wall_ms:.1f}%), pin "
            f"{split['pin']:.4f} ms ({100 * split['pin'] / wall_ms:.1f}%), upload and step "
            f"enqueue {split['enqueue']:.4f} ms ({100 * split['enqueue'] / wall_ms:.1f}%)")

        def conv_bound(xx):
            b, h, wd_, c = xx.shape
            return 2.0 * b * h * wd_ * 81 * c * c, 4.0 * (2 * xx.numel() + 81 * c * c)

        xc, wc = x.permute(0, 3, 1, 2), w9.permute(3, 2, 0, 1).contiguous()
        xtc, gtc = xt.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2)
        wdc = wd.permute(3, 2, 0, 1).contiguous()

        def flash_bound(q):
            bq, hq, s, d = q.shape
            return 4.0 * bq * hq * s * s * d, 4.0 * 4 * q.numel()

        q, k, v = qkv
        q2, k2, v2 = qkv_1024
        rows = []
        conv9_src, conv9_rep = "sshslie_torch/csrc/conv9.cu", "sshslie_tpu/ops/conv_pallas.py:147"
        for name, src, replaces, key, count, fn, plain, lib, (flops, nbytes) in (
                ("conv9 (1,512,512,64) forward", conv9_src, conv9_rep, "conv9_512", "conv9",
                 lambda: conv9.conv9_fwd(x, w9), lambda: conv9.conv9_plain(x, w9),
                 lambda: F.conv2d(xc, wc, padding=4), conv_bound(x)),
                ("conv9 (2,128,128,64) forward", conv9_src, conv9_rep, "conv9_128", "conv9",
                 lambda: conv9.conv9_fwd(xt, w9), lambda: conv9.conv9_plain(xt, w9),
                 lambda: F.conv2d(xtc, wc, padding=4), conv_bound(xt)),
                ("conv9 (2,128,128,64) dgrad", conv9_src, conv9_rep, "dgrad_128", "conv9",
                 lambda: conv9.conv9_fwd(gt, wd), lambda: conv9.conv9_plain(gt, wd),
                 lambda: torch.nn.grad.conv2d_input(xtc.shape, wc, gtc, padding=4), conv_bound(gt)),
                ("conv9_wgrad (2,128,128,64)", "sshslie_torch/csrc/conv9_wgrad.cu",
                 "sshslie_tpu/ops/conv_pallas.py:215", "wgrad_128", "conv9_wgrad",
                 lambda: conv9.conv9_wgrad(xt, gt, 9), lambda: conv9.conv9_wgrad_plain(xt, gt, 9),
                 lambda: torch.nn.grad.conv2d_weight(xtc, wc.shape, gtc, padding=4), conv_bound(xt)),
                ("flash_attention (1,4,4096,16)", "sshslie_torch/csrc/flash_attn.cu",
                 "sshslie_tpu/ops/attention.py:169", "flash", "flash_attention",
                 lambda: attention.flash_attention(q, k, v), lambda: attention.sdpa_chunked(q, k, v),
                 lambda: F.scaled_dot_product_attention(q, k, v), flash_bound(q)),
                # A standalone timing: the main path never gives the kernel S = 16384,
                # so this row counts no main-path launches.
                ("flash_attention (1,4,16384,16) standalone", "sshslie_torch/csrc/flash_attn.cu",
                 "sshslie_tpu/ops/attention.py:169", "flash_1024", None,
                 lambda: attention.flash_attention(q2, k2, v2),
                 lambda: attention.sdpa_chunked(q2, k2, v2),
                 lambda: F.scaled_dot_product_attention(q2, k2, v2), flash_bound(q2))):
            ms = time_ms(fn, 20)
            plain_ms = time_ms(plain, 5)
            library_ms = time_ms(lib, 20)
            t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "launches": launches[count] if count else 0, "max_abs_err": errs[key], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "library_ms": library_ms})
            log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
                f"bound {max(t_ops, t_bytes):.4f} ms ({flops:.3e} FLOP, {nbytes:.3e} B)")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    log(f"launches on the main path: test phase {test_counts}, train_and_test {train_counts}")
    log(f"chip_smoke total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
