"""Patch augmentation: the 8 flip/rotation modes of reference utils.py:7-34,
as ``sshslie_tpu/utils/augment.py``:

* :func:`data_augmentation`: one (H, W, C) numpy patch on the host
  (``data_augmentation``);
* :func:`augment_batch`: a (B, P, P, C) tensor on its device, one mode a
  sample (``augment_batch_jax``): each mode is a permutation of the P*P
  pixels, so the batch is one gather through a (8, P*P) table of source
  pixels, built once per (P, device) by :func:`data_augmentation` itself on
  a grid of pixel indices. Bit for bit the host modes.

  0 identity, 1 flipud, 2 rot90, 3 rot90 + flipud, 4 rot180,
  5 rot180 + flipud, 6 rot270, 7 rot270 + flipud
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NUM_MODES = 8


def data_augmentation(image: np.ndarray, mode: int) -> np.ndarray:
    """Apply one of the 8 flip/rotation modes to an (H, W, C) patch."""
    if mode == 0:
        return image
    if mode == 1:
        return np.flipud(image)
    if mode == 2:
        return np.rot90(image)
    if mode == 3:
        return np.flipud(np.rot90(image))
    if mode == 4:
        return np.rot90(image, k=2)
    if mode == 5:
        return np.flipud(np.rot90(image, k=2))
    if mode == 6:
        return np.rot90(image, k=3)
    if mode == 7:
        return np.flipud(np.rot90(image, k=3))
    raise ValueError(f"augmentation mode must be in [0, 8), got {mode}")


@functools.lru_cache(maxsize=8)
def _source_pixels(p: int, device: torch.device) -> torch.Tensor:
    """(8, p*p) int64: the source pixel of each output pixel, per mode."""
    grid = np.arange(p * p).reshape(p, p, 1)
    table = np.stack([data_augmentation(grid, m).reshape(-1) for m in range(NUM_MODES)])
    return torch.from_numpy(table).to(device)


def augment_batch(patches: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """(B, P, P, C) patches, mode ``modes[i]`` on sample i -> a new (B, P, P, C)
    tensor on the same device, without a host sync.

    Square patches only, as ``augment_batch_jax``. A mode outside [0, 8)
    raises on the CPU and is an indexing fault on the card (the JAX version
    clamps); both pipelines draw modes from [0, 8).
    """
    b, p, p2, c = patches.shape
    if p != p2:
        raise ValueError(f"augment_batch needs square patches, got {p}x{p2}")
    src = _source_pixels(p, patches.device)[modes]                     # (B, P*P)
    flat = patches.reshape(b, p * p, c)
    rows = torch.arange(b, device=patches.device)[:, None]
    return flat[rows, src].reshape(b, p, p, c)
