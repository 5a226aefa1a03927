"""The six-term self-supervised loss over NHWC tensors, as
``sshslie_tpu/ops/losses.py`` (reference model.py:445-575):

  * L_reconstruction  — mean |R·I − input|
  * L_I_smooth_low,
    L_R_fidelity      — structure-aware loss (β 0.5 as ``total_loss`` calls it)
  * L_I_smooth_delta  — edge-weighted smoothness, (B,H,W,1) × (B,H,W,C) broadcast
  * L_fourier         — masked FFT-magnitude L1
  * L_spectral_cons   — band-to-band L1

The Fourier mask is the reference's radial mask applied to the *unshifted*
spectrum (PARITY #11), folded into weights over the rfft2 half plane so the
half spectrum gives the full-grid sum; the weights are a numpy constant,
cached per (h, w, cutoff), built exactly as the JAX package builds them.
``torch.fft.rfft2`` is cuFFT on the card, as the JAX package leaves its FFT
to ``jnp.fft``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from sshslie_torch.ops import at_least_float32


def _dx(x: torch.Tensor) -> torch.Tensor:
    """Forward difference along width (NHWC axis 2)."""
    return x[:, :, 1:, :] - x[:, :, :-1, :]


def _dy(x: torch.Tensor) -> torch.Tensor:
    """Forward difference along height (NHWC axis 1)."""
    return x[:, 1:, :, :] - x[:, :-1, :, :]


def reconstruction_loss(R: torch.Tensor, I: torch.Tensor, input_low: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(R * I - input_low))


def structure_aware_loss(R: torch.Tensor, I: torch.Tensor, R_enh: torch.Tensor,
                         alpha: float = 1.0, beta: float = 1.0,
                         lambda_I: float = 1.0, lambda_R: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-aware illumination smoothness and reflectance fidelity → (i_loss, r_loss)."""
    grad_R_x, grad_R_y = _dx(R), _dy(R)
    weight_x = torch.exp(-alpha * torch.mean(torch.abs(grad_R_x), dim=-1, keepdim=True))
    weight_y = torch.exp(-alpha * torch.mean(torch.abs(grad_R_y), dim=-1, keepdim=True))
    loss_I = torch.mean(weight_x * torch.abs(_dx(I))) + torch.mean(weight_y * torch.abs(_dy(I)))
    loss_R1 = torch.mean(torch.abs(R - R_enh))
    loss_R2 = (torch.mean(torch.abs(grad_R_x - _dx(R_enh)))
               + torch.mean(torch.abs(grad_R_y - _dy(R_enh))))
    return lambda_I * loss_I, lambda_R * (loss_R1 + beta * loss_R2)


def smooth_loss(I: torch.Tensor, R: torch.Tensor, alpha: float = 10.0) -> torch.Tensor:
    """mean(|∇I|·exp(−α|∇R|)) in x and y; I (B,H,W,1) broadcasts against R (B,H,W,C)."""
    return (torch.mean(torch.abs(_dx(I)) * torch.exp(-alpha * torch.abs(_dx(R))))
            + torch.mean(torch.abs(_dy(I)) * torch.exp(-alpha * torch.abs(_dy(R)))))


@functools.lru_cache(maxsize=32)
def _mask_np(h: int, w: int, cutoff: float) -> np.ndarray:
    """The reference's radial mask (model.py:460-464), float32 like torch.linspace."""
    y = np.linspace(-1.0, 1.0, h, dtype=np.float32)
    x = np.linspace(-1.0, 1.0, w, dtype=np.float32)
    Y, X = np.meshgrid(y, x, indexing="ij")
    radius = np.sqrt(X * X + Y * Y).astype(np.float32)
    mask = (radius >= np.float32(cutoff)).astype(np.float32)
    mask.setflags(write=False)
    return mask


@functools.lru_cache(maxsize=32)
def _halfplane_weights_np(h: int, w: int, cutoff: float) -> np.ndarray:
    """The mask folded into weights over the rfft2 half spectrum.

    |F[i, j]| = |F[-i % h, -j % w]| for a real signal, so a full-grid masked
    sum equals a half-grid sum where each kept bin also carries its partner's
    mask value when the partner column (w - j) is not kept. Columns 0 and
    (even w) w/2 are their own partners. The mask is not conjugate-symmetric
    (PARITY #11), hence the folding.
    """
    mask = _mask_np(h, w, cutoff)
    wh = w // 2 + 1
    weights = mask[:, :wh].copy()
    conj_rows = (h - np.arange(h)) % h
    for j in range(1, wh):
        pj = w - j
        if pj == j or pj >= w:
            continue
        weights[:, j] += mask[conj_rows, pj]
    weights.setflags(write=False)
    return weights


@functools.lru_cache(maxsize=32)
def _halfplane_weights(h: int, w: int, cutoff: float, device: torch.device) -> torch.Tensor:
    """:func:`_halfplane_weights_np` as a (1, h, w//2+1, 1) tensor on ``device``,
    uploaded once rather than on every step."""
    return torch.from_numpy(np.array(_halfplane_weights_np(h, w, cutoff))).to(device)[None, :, :, None]


def fourier_spectrum_loss(input_hsi: torch.Tensor, target_hsi: torch.Tensor,
                          cutoff: float = 0.1, loss_type: str = "l1") -> torch.Tensor:
    """L1 (or L2) between masked FFT magnitudes over the spatial axes (1, 2)."""
    b, h, w, c = input_hsi.shape
    weights = _halfplane_weights(h, w, float(cutoff), input_hsi.device)
    diff = (torch.abs(torch.fft.rfft2(input_hsi, dim=(1, 2)))
            - torch.abs(torch.fft.rfft2(target_hsi, dim=(1, 2))))
    denom = b * h * w * c
    if loss_type == "l1":
        return torch.sum(weights * torch.abs(diff)) / denom
    return torch.sum(weights * diff * diff) / denom


def spectral_smoothness_loss(hsi: torch.Tensor, loss_type: str = "l1") -> torch.Tensor:
    """Band-to-band difference penalty over the channel axis."""
    spectral_diff = hsi[..., 1:] - hsi[..., :-1]
    if loss_type == "l1":
        return torch.mean(torch.abs(spectral_diff))
    return torch.mean(spectral_diff ** 2)


def total_loss(input_low: torch.Tensor, R_low: torch.Tensor, I_low: torch.Tensor,
               I_delta: torch.Tensor, S: torch.Tensor, R_enh: torch.Tensor,
               coeffs: Dict[str, float]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted six-term loss → (total, {LOSS_KEYS name: term}), each term cast
    to float32 at least, as the JAX package casts it (a no-op for float32)."""
    f32 = at_least_float32
    L_reconstruction = f32(reconstruction_loss(R_low, I_low, input_low))
    L_I_smooth_low, L_R_fidelity = structure_aware_loss(
        R_low, I_low, R_enh, alpha=coeffs["alpha_i_smooth_low"], beta=0.5,
        lambda_I=1.0, lambda_R=1.0)
    L_I_smooth_low, L_R_fidelity = f32(L_I_smooth_low), f32(L_R_fidelity)
    L_I_smooth_delta = f32(smooth_loss(I_delta, R_low, alpha=coeffs["alpha_i_smooth_delta"]))
    L_fourier = f32(fourier_spectrum_loss(input_low, S, cutoff=0.1, loss_type="l1"))
    L_spectral_cons = f32(spectral_smoothness_loss(S, loss_type="l1"))
    total = (coeffs["c_loss_reconstruction"] * L_reconstruction
             + coeffs["c_loss_r_fidelity"] * L_R_fidelity
             + coeffs["c_loss_i_smooth_low"] * L_I_smooth_low
             + coeffs["c_loss_i_smooth_delta"] * L_I_smooth_delta
             + coeffs["c_loss_fourier"] * L_fourier
             + coeffs["c_loss_spectral_cons"] * L_spectral_cons)
    terms = {
        "total_loss": total,
        "L_reconstruction": L_reconstruction,
        "L_R_fidelity": L_R_fidelity,
        "L_I_smooth_low": L_I_smooth_low,
        "L_I_smooth_delta": L_I_smooth_delta,
        "L_fourier": L_fourier,
        "L_spectral_cons": L_spectral_cons,
    }
    return total, terms
