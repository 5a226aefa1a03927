"""PSNR / SSIM / SAM with torchmetrics semantics, as ``sshslie_tpu/metrics.py``.

* :func:`ssim` keeps the reference's orientation (PARITY #12): the (H, W, C)
  cube is unsqueezed to (1, H, W, C) and read as NCHW, so H is the channel
  axis and the 11×11 Gaussian window (σ = 1.5) slides over the (W, C) plane.
  The window shrinks to the largest odd size that fits small cubes.
* ``data_range`` follows torchmetrics: None infers it (PSNR from the target,
  SSIM from the larger of the two ranges), a (min, max) pair clamps both
  tensors, a scalar is used as it is.
* :func:`ssim_spatial` is the conventional orientation: bands as channels,
  the window over (H, W).
* :func:`psnr_bandwise` and :func:`ssim_bandwise` are the per-band (C,)
  vectors of the reference's bandwise loop (reference metrics.py:26-29,
  53-54), each band inferring its own range when ``data_range`` is None.
* :func:`calc_metrics` averages over ``.mat`` pairs matched by basename,
  :func:`multi_img_bandwise_metrics` the per-band vectors; ``python -m
  sshslie_torch.metrics <pred_glob> <label_dir>`` prints the averages
  (:func:`_main`, on the card unless ``--device cpu``).

All arithmetic is float32 on the tensors' device.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from sshslie_torch.utils.io_hsi import load_hsi

DataRange = Union[None, float, Tuple[float, float]]


def _apply_range(pred: torch.Tensor, target: torch.Tensor, data_range: DataRange,
                 kind: str, per_band: bool = False):
    """torchmetrics ``data_range`` rules → (pred, target, range). ``per_band``
    infers a (C,) range over (H, W) of an (H, W, C) cube, one a band."""
    if data_range is None:
        def span(t):
            if per_band:
                return t.amax(dim=(0, 1)) - t.amin(dim=(0, 1))
            return t.max() - t.min()

        rng = span(target)
        if kind == "ssim":
            rng = torch.maximum(rng, span(pred))
        return pred, target, rng
    if isinstance(data_range, (tuple, list)):
        lo, hi = torch.tensor([float(v) for v in data_range], dtype=torch.float32,
                              device=pred.device)
        return pred.clamp(lo, hi), target.clamp(lo, hi), hi - lo
    return pred, target, torch.as_tensor(data_range, dtype=torch.float32, device=pred.device)


def _as_f32(t, device=None) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def psnr(pred, target, data_range: DataRange = None) -> torch.Tensor:
    """10·log10(range²/mse) over the whole tensor."""
    pred = _as_f32(pred)
    target = _as_f32(target, pred.device)
    pred, target, rng = _apply_range(pred, target, data_range, "psnr")
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(rng ** 2 / mse)


def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _ssim_map(x: torch.Tensor, y: torch.Tensor, data_range: torch.Tensor,
              kernel_size: int = 11, sigma: float = 1.5,
              k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Local SSIM of (N, H, W) planes by separable valid Gaussian convolution."""
    g = _gaussian_kernel1d(kernel_size, sigma, x.device)
    kh = g.reshape(1, 1, kernel_size, 1)
    kw = g.reshape(1, 1, 1, kernel_size)

    def blur(t):
        return F.conv2d(F.conv2d(t[:, None], kh), kw)[:, 0]

    mu_x, mu_y = blur(x), blur(y)
    sigma_x = blur(x * x) - mu_x ** 2
    sigma_y = blur(y * y) - mu_y ** 2
    sigma_xy = blur(x * y) - mu_x * mu_y
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    upper = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    lower = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return upper / lower


def _ssim_nchw(pred: torch.Tensor, target: torch.Tensor, data_range: DataRange) -> torch.Tensor:
    """SSIM of (N, C, H, W) tensors, mean over everything (torchmetrics)."""
    pred, target, rng = _apply_range(pred, target, data_range, "ssim")
    n, c, h, w = pred.shape
    k = min(11, h, w)
    if k % 2 == 0:
        k -= 1
    return _ssim_map(pred.reshape(n * c, h, w), target.reshape(n * c, h, w), rng,
                     kernel_size=k).mean()


def ssim(pred, target, data_range: DataRange = None) -> torch.Tensor:
    """Reference-orientation SSIM of (H, W, C) cubes (reference metrics.py:16-19)."""
    pred = _as_f32(pred)
    target = _as_f32(target, pred.device)
    return _ssim_nchw(pred[None], target[None], data_range)


def ssim_spatial(pred, target, data_range: DataRange = None) -> torch.Tensor:
    """Conventional SSIM of (H, W, C) cubes: bands as channels, window over (H, W)."""
    pred = _as_f32(pred)
    target = _as_f32(target, pred.device)
    return _ssim_nchw(pred.permute(2, 0, 1)[None], target.permute(2, 0, 1)[None], data_range)


def sam(pred, target) -> torch.Tensor:
    """Mean spectral angle of (H, W, C) cubes, in radians."""
    pred = _as_f32(pred)
    target = _as_f32(target, pred.device)
    dot = (pred * target).sum(dim=-1)
    denom = torch.linalg.vector_norm(pred, dim=-1) * torch.linalg.vector_norm(target, dim=-1)
    return torch.arccos(torch.clamp(dot / denom, -1.0, 1.0)).mean()


def psnr_bandwise(pred, target, data_range: DataRange = None) -> torch.Tensor:
    """Per-band PSNR (C,) of (H, W, C) cubes (reference metrics.py:53-54)."""
    pred = _as_f32(pred)
    target = _as_f32(target, pred.device)
    pred, target, rng = _apply_range(pred, target, data_range, "psnr", per_band=True)
    mse = torch.mean((pred - target) ** 2, dim=(0, 1))
    return 10.0 * torch.log10(rng ** 2 / mse)


def ssim_bandwise(pred, target, data_range: DataRange = None) -> torch.Tensor:
    """Per-band SSIM (C,) over each band's (H, W) plane (reference
    metrics.py:26-29: each band is (1, 1, H, W) to torchmetrics)."""
    pred = _as_f32(pred)
    target = _as_f32(target, pred.device)
    pred, target, rng = _apply_range(pred, target, data_range, "ssim", per_band=True)
    if rng.ndim == 1:
        rng = rng[:, None, None]
    p, t = pred.permute(2, 0, 1), target.permute(2, 0, 1)
    k = min(11, p.shape[1], p.shape[2])
    if k % 2 == 0:
        k -= 1
    return _ssim_map(p, t, rng, kernel_size=k).mean(dim=(1, 2))


def _data_range(data_min: Optional[float], data_max: Optional[float]) -> DataRange:
    if data_min is not None and data_max is not None:
        return (data_min, data_max)
    if data_max is not None:
        return data_max
    if data_min is not None:
        raise ValueError("data_min without data_max is ambiguous (torchmetrics clamp "
                         "semantics need the pair); pass both or neither")
    return None


def calc_metrics(
    im_dir: str,
    label_dir: str,
    data_min: Optional[float] = None,
    data_max: Optional[float] = None,
    mat_key_prediction: str = "data",
    mat_key_gt: str = "data",
    device: Union[str, torch.device] = "cpu",
):
    """Average PSNR/SSIM/SAM over every ``.mat`` pair (reference metrics.py:101-141).

    ``im_dir`` is a glob; predictions pair with ground truth by basename in
    ``label_dir``. Pairs without ground truth are skipped; none at all raises.
    """
    data_range = _data_range(data_min, data_max)
    total = np.zeros(3, dtype=np.float64)
    n = 0
    for item in sorted(_glob.glob(im_dir)):
        if not item.endswith(".mat"):
            continue
        name = os.path.basename(item)
        label_path = os.path.join(label_dir, name)
        if not os.path.exists(label_path):
            print(f"===> {name} | no ground truth in {label_dir}, skipping")
            continue
        im1 = _as_f32(load_hsi(item, mat_key=mat_key_prediction), device)
        im2 = _as_f32(load_hsi(label_path, mat_key=mat_key_gt), device)
        scores = (float(psnr(im1, im2, data_range)), float(ssim(im1, im2, data_range)),
                  float(sam(im1, im2)))
        print(f"\n===> {name} | PSNR : {scores[0]:.4f}")
        print(f"===> {name} | SSIM : {scores[1]:.4f}")
        print(f"===> {name} | SAM  : {scores[2]:.4f}")
        total += scores
        n += 1
    if n <= 0:
        raise ValueError("Number of files must be greater than 0")
    avg = total / n
    return float(avg[0]), float(avg[1]), float(avg[2])


def multi_img_bandwise_metrics(
    preds_path: str,
    labels_path: str,
    data_min: Optional[float] = None,
    data_max: Optional[float] = None,
    mat_key_prediction: str = "data",
    mat_key_gt: str = "data",
    device: Union[None, str, torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dataset-average per-band PSNR and SSIM vectors over the ``.mat`` files
    of ``preds_path`` paired by basename in ``labels_path`` (reference
    metrics.py:62-99), on ``device`` (the card by default)."""
    from sshslie_torch.device import resolve_device

    device = resolve_device(device)
    data_range = _data_range(data_min, data_max)
    psnr_sum = ssim_sum = None
    count = 0
    for pred_img in sorted(_glob.glob(os.path.join(preds_path, "*.mat"))):
        name = os.path.basename(pred_img)
        label_path = os.path.join(labels_path, name)
        if not os.path.exists(label_path):
            print(f"===> {name} | no ground truth in {labels_path}, skipping")
            continue
        im1 = _as_f32(load_hsi(pred_img, mat_key=mat_key_prediction), device)
        im2 = _as_f32(load_hsi(label_path, mat_key=mat_key_gt), device)
        p = psnr_bandwise(im1, im2, data_range).cpu().numpy()
        s = ssim_bandwise(im1, im2, data_range).cpu().numpy()
        psnr_sum = p if psnr_sum is None else psnr_sum + p
        ssim_sum = s if ssim_sum is None else ssim_sum + s
        count += 1
    if psnr_sum is None:
        raise ValueError("Number of files must be greater than 0")
    return psnr_sum / count, ssim_sum / count


def _main(argv=None):
    """Metric CLI (the reference's hardcoded __main__, metrics.py:143-162):
    ``python -m sshslie_torch.metrics <pred_glob> <label_dir> [--data_min N]
    [--data_max N] [--key_pred data] [--key_gt data] [--device cpu]``."""
    import argparse

    from sshslie_torch.device import resolve_device

    ap = argparse.ArgumentParser(description="Average PSNR/SSIM/SAM over .mat pairs")
    ap.add_argument("im_dir", help="prediction glob, e.g. results/test/*.mat")
    ap.add_argument("label_dir", help="ground-truth directory")
    ap.add_argument("--data_min", type=float, default=None)
    ap.add_argument("--data_max", type=float, default=None)
    ap.add_argument("--key_pred", default="data")
    ap.add_argument("--key_gt", default="data")
    ap.add_argument("--device", default="", help="'' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    avg_psnr, avg_ssim, avg_sam = calc_metrics(
        im_dir=os.path.normpath(args.im_dir),
        label_dir=os.path.normpath(args.label_dir),
        data_min=args.data_min,
        data_max=args.data_max,
        mat_key_prediction=args.key_pred,
        mat_key_gt=args.key_gt,
        device=resolve_device(args.device),
    )
    print(f"\n===> Avg.PSNR : {avg_psnr:.4f}")
    print(f"===> Avg.SSIM : {avg_ssim:.4f}")
    print(f"===> Avg.SAM  : {avg_sam:.4f}")


if __name__ == "__main__":
    _main()
