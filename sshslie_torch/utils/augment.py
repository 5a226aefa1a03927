"""Patch augmentation: the 8 flip/rotation modes of reference utils.py:7-34,
as ``sshslie_tpu/utils/augment.py::data_augmentation`` (host-side numpy).

  0 identity, 1 flipud, 2 rot90, 3 rot90 + flipud, 4 rot180,
  5 rot180 + flipud, 6 rot270, 7 rot270 + flipud
"""

from __future__ import annotations

import numpy as np


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
