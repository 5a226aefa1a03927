"""The plain reference of the six-term self-supervised loss (reference
model.py:445-575), over NHWC float32 tensors.

The Fourier term is the reference's: full ``fft2`` over the spatial axes,
the radial mask radius >= cutoff on the unshifted spectrum, L1 of the
magnitudes' difference, a mean over every element.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

TERMS = ("total_loss", "L_reconstruction", "L_R_fidelity", "L_I_smooth_low",
         "L_I_smooth_delta", "L_fourier", "L_spectral_cons")


def _dx(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, 1:, :] - x[:, :, :-1, :]


def _dy(x: torch.Tensor) -> torch.Tensor:
    return x[:, 1:, :, :] - x[:, :-1, :, :]


def structure_aware(R, I, R_enh, alpha: float, beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    gx, gy = _dx(R), _dy(R)
    wx = torch.exp(-alpha * torch.mean(torch.abs(gx), dim=-1, keepdim=True))
    wy = torch.exp(-alpha * torch.mean(torch.abs(gy), dim=-1, keepdim=True))
    loss_i = torch.mean(wx * torch.abs(_dx(I))) + torch.mean(wy * torch.abs(_dy(I)))
    loss_r = (torch.mean(torch.abs(R - R_enh))
              + beta * (torch.mean(torch.abs(gx - _dx(R_enh)))
                        + torch.mean(torch.abs(gy - _dy(R_enh)))))
    return loss_i, loss_r


def smooth(I, R, alpha: float) -> torch.Tensor:
    return (torch.mean(torch.abs(_dx(I)) * torch.exp(-alpha * torch.abs(_dx(R))))
            + torch.mean(torch.abs(_dy(I)) * torch.exp(-alpha * torch.abs(_dy(R)))))


def fourier(x, y, cutoff: float = 0.1) -> torch.Tensor:
    h, w = x.shape[1], x.shape[2]
    yy = torch.linspace(-1.0, 1.0, h, device=x.device)
    xx = torch.linspace(-1.0, 1.0, w, device=x.device)
    Y, X = torch.meshgrid(yy, xx, indexing="ij")
    mask = (torch.sqrt(X * X + Y * Y) >= cutoff).to(x.dtype)[None, :, :, None]
    diff = torch.abs(torch.fft.fft2(x, dim=(1, 2))) - torch.abs(torch.fft.fft2(y, dim=(1, 2)))
    return torch.mean(mask * torch.abs(diff))


def spectral(S) -> torch.Tensor:
    return torch.mean(torch.abs(S[..., 1:] - S[..., :-1]))


def total(x, R, I, I_delta, S, R_enh, c: Dict[str, float]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {term: value}) with the configuration's weights ``c``."""
    rec = torch.mean(torch.abs(R * I - x))
    i_low, r_fid = structure_aware(R, I, R_enh, c["alpha_i_smooth_low"], 0.5)
    i_delta = smooth(I_delta, R, c["alpha_i_smooth_delta"])
    four = fourier(x, S)
    spec = spectral(S)
    tot = (c["c_loss_reconstruction"] * rec + c["c_loss_r_fidelity"] * r_fid
           + c["c_loss_i_smooth_low"] * i_low + c["c_loss_i_smooth_delta"] * i_delta
           + c["c_loss_fourier"] * four + c["c_loss_spectral_cons"] * spec)
    return tot, dict(zip(TERMS, (tot, rec, r_fid, i_low, i_delta, four, spec)))
