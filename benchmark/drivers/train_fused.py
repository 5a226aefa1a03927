"""Traffic of kind "train_fused": the fused on-device pipeline as
``Trainer._train_epoch`` runs it, through the port's public entries.

Set-up makes the weights and the cube stack from the seed, builds the model
and Adam once, and drives them through the first three steps of epoch 0,
each one call of ``multistep_train_step`` (the window's own entry) on its
own crops: these are the steps the check compares, and they warm every
shape. The window then runs whole epochs from epoch 1 on the same objects:
StepLR's rate set, the epoch's draws uploaded once, ``multistep_train_step``
over chunks of ``steps_per_dispatch`` steps, and the epoch's terms fetched
in one sync. No eval, no checkpoint.

The traffic file gives ``batch_size``, ``patch_size``, ``steps_per_dispatch``,
``cubes`` and ``cube_hw``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List

import torch

from benchmark.harness import compare, inputs, program, yardstick
from benchmark.harness.trace import note, profiled, span
from benchmark.harness.window import Window
from benchmark.reference import train as ref_train

WORK = "train"
CHECKED_STEPS = 3
TRACE_SECONDS = 4.0
COEFF_KEYS = ("c_loss_reconstruction", "c_loss_r_fidelity", "c_loss_i_smooth_low",
              "c_loss_i_smooth_delta", "c_loss_fourier", "c_loss_spectral_cons",
              "alpha_i_smooth_low", "alpha_i_smooth_delta")


@dataclass
class TrainSetup:
    cfg: object
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    cubes: torch.Tensor
    params0: Dict[str, torch.Tensor]
    terms: List[Dict[str, float]]    # each checked step's seven terms
    grad1: Dict[str, torch.Tensor]
    params3: Dict[str, torch.Tensor]
    num_batches: int
    coeffs: Dict[str, float]
    cell_config: dict
    epoch: int = 1                # the next epoch the window runs


def setup(cell, seed: int, device: torch.device) -> TrainSetup:
    from sshslie_torch.device import set_matmul_precision
    from sshslie_torch.models.enhance import build_model
    from sshslie_torch.train import (fused_draws, loss_coeffs, make_optimizer,
                                     multistep_train_step, set_lr)
    from sshslie_torch.utils.schedule import step_lr

    t = cell.traffic
    cfg = program.config(cell.config, device=str(device), seed_value=seed,
                         batch_size=t["batch_size"], patch_size=t["patch_size"],
                         steps_per_dispatch=t["steps_per_dispatch"])
    set_matmul_precision(cfg)
    bands = cfg.channels
    h, w = t["cube_hw"]
    started = time.perf_counter()
    params0 = inputs.weights(seed, bands, device)
    cubes = inputs.normalise(inputs.counts(seed, 2, t["cubes"], h, w, bands, device))
    note("inputs", started)
    model = build_model(cfg, bands, device, train=True)
    model.load_state_dict(params0, strict=True)
    optimizer = make_optimizer(model, cfg.start_lr)
    coeffs = loss_coeffs(cfg)
    num_batches = t["cubes"] // cfg.batch_size
    if num_batches < CHECKED_STEPS:
        raise ValueError(f"{cell.name}: {num_batches} steps an epoch; the check takes the "
                         f"first {CHECKED_STEPS} of epoch 0")
    draws = torch.from_numpy(fused_draws(seed, 0, num_batches, cfg.batch_size, (h, w),
                                         cfg.patch_size)).to(device)
    set_lr(optimizer, step_lr(0, cfg.start_lr, cfg.lr_update_factor, cfg.lr_update_period))
    step_terms, grad1 = [], None
    named = list(model.named_parameters())
    for b in range(CHECKED_STEPS):
        terms = multistep_train_step(model, optimizer, cubes, draws, [b], cfg.batch_size,
                                     cfg.patch_size, coeffs)
        step_terms.append({k: float(v) for k, v in terms.items()})
        if grad1 is None:
            beta1 = optimizer.param_groups[0]["betas"][0]
            grad1 = {n: optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                     / (1.0 - beta1) for n, p in named}
    params3 = {n: p.detach().clone() for n, p in named}
    note(f"model and {CHECKED_STEPS} checked steps", started)
    return TrainSetup(cfg, model, optimizer, cubes, params0, step_terms, grad1, params3,
                      num_batches,
                      coeffs, cell.config)


def _epochs(s: TrainSetup, seconds: float):
    """Whole epochs, from the next one, until ``seconds`` have passed ->
    (steps, steps failed, seconds)."""
    from sshslie_torch.train import LOSS_KEYS, fused_draws, multistep_train_step, set_lr
    from sshslie_torch.utils.schedule import step_lr

    cfg, dev = s.cfg, s.cubes.device
    hw = tuple(s.cubes.shape[1:3])
    k = max(int(cfg.steps_per_dispatch), 1)
    steps = failed = 0
    start = time.perf_counter()
    while True:
        with span("lr set"):
            set_lr(s.optimizer, step_lr(s.epoch, cfg.start_lr, cfg.lr_update_factor,
                                        cfg.lr_update_period))
        with span("draw upload"):
            draws = torch.from_numpy(fused_draws(cfg.seed_value, s.epoch, s.num_batches,
                                                 cfg.batch_size, hw, cfg.patch_size)).to(dev)
        sums = None
        for first in range(0, s.num_batches, k):
            ids = range(first, min(first + k, s.num_batches))
            with span("step enqueue"):
                terms = multistep_train_step(s.model, s.optimizer, s.cubes, draws, ids,
                                             cfg.batch_size, cfg.patch_size, s.coeffs)
            sums = terms if sums is None else {n: sums[n] + terms[n] for n in LOSS_KEYS}
        with span("epoch sync"):
            host = torch.stack([sums[n] for n in LOSS_KEYS]).cpu().tolist()
        steps += s.num_batches
        if not all(math.isfinite(v) for v in host):
            failed += s.num_batches
        s.epoch += 1
        if time.perf_counter() - start >= seconds:
            return steps, failed, time.perf_counter() - start


def window(s: TrainSetup, seconds: float, trace: bool):
    """Whole epochs from epoch 1 for ``seconds``, then with ``trace`` a traced
    stretch of TRACE_SECONDS -> (Window, steps attempted, steps failed)."""
    cfg = s.cfg
    steps, failed, elapsed = _epochs(s, seconds)
    win = Window(WORK, cfg.precision, elapsed, steps,
                 yardstick.train_step_flops(cfg.channels, cfg.batch_size, cfg.patch_size))
    if trace:
        program.reset_launches()
        with profiled(True) as traced:
            win.traced_items, more_failed, _ = _epochs(s, TRACE_SECONDS)
        failed += more_failed
        steps += win.traced_items
        win.trace, win.launches = traced[0], program.launches()
    return win, steps, failed


def end_to_end(s: TrainSetup, win: Window) -> dict:
    """train_mpbs: megapixel-bands a second over the untraced window."""
    cfg = s.cfg
    return {"train_mpbs": win.items * cfg.batch_size * cfg.patch_size ** 2 * cfg.channels
            / 1e6 / win.seconds}


def check(s: TrainSetup, numbers_of=None, detail: bool = False) -> Dict[str, float]:
    """The reference's first three steps from the same weights and crops ->
    the numbers (``compare.train_numbers``); ``numbers_of(coeffs, lr)`` ->
    (each step's terms, first gradients, weights after) stands in for the
    program's readings (the controls and faults of ``calibrate.py``)."""
    cc, cfg = s.cell_config, s.cfg
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    coeffs = {k: float(cc[k]) for k in COEFF_KEYS}
    lr = ref_train.step_lr(0, cc["start_lr"], cc["lr_update_factor"], cc["lr_update_period"])
    ref_terms, ref_g1, ref_p3 = ref_train.train(s.params0, s.cubes, cc["channels"],
                                                cfg.seed_value, cfg.batch_size, cfg.patch_size,
                                                coeffs, lr, CHECKED_STEPS)
    prog = (s.terms, s.grad1, s.params3) if numbers_of is None else numbers_of(coeffs, lr)
    return compare.train_numbers(prog[0], prog[1], s.params0, prog[2], ref_terms, ref_g1, ref_p3,
                                 detail)


def release(s: TrainSetup) -> None:
    """Drop the program's state, so the reference runs on a freed card."""
    s.model = s.optimizer = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
