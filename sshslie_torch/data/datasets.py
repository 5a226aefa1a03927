"""In-RAM cube store and the host patch sampler, as
``sshslie_tpu/data/datasets.py`` (``CubeStore``, ``PatchSampler``,
``store_from_config``).

The JAX ``Prefetcher`` (a thread that stages batches ahead of the step) is
not ported: the port samples synchronously, one host batch and one upload a
step, which changes the speed and not the batches. The disk-backed store is
not ported either."""

from __future__ import annotations

import os
from glob import glob
from typing import Iterator, List, Optional

import numpy as np

from sshslie_torch.utils.augment import data_augmentation
from sshslie_torch.utils.io_hsi import load_hsi


class CubeStore:
    """All cubes of a directory loaded to RAM as float32 (H, W, C) arrays."""

    def __init__(
        self,
        data_path: str,
        mat_key: str = "data",
        normalization: Optional[str] = "global_normalization",
        global_min: Optional[float] = None,
        global_max: Optional[float] = None,
        pattern: str = "*.mat",
    ):
        self.files: List[str] = sorted(glob(os.path.join(data_path, pattern)))

        def _load(f: str) -> np.ndarray:
            return load_hsi(f, mat_key=mat_key, normalization=normalization,
                            max_val=global_max, min_val=global_min)

        # scipy's .mat read releases the GIL, so threads load cubes in parallel;
        # map keeps the file order.
        workers = min(8, len(self.files), os.cpu_count() or 1)
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as pool:
                self.cubes: List[np.ndarray] = list(pool.map(_load, self.files))
        else:
            self.cubes = [_load(f) for f in self.files]
        self.shapes: List[tuple] = [c.shape for c in self.cubes]

    def __len__(self) -> int:
        return len(self.cubes)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.cubes[idx]

    @property
    def channels(self) -> int:
        if not self.cubes:
            raise ValueError("empty cube store")
        return self.cubes[0].shape[-1]


class PatchSampler:
    """Random crop + 8-mode augmentation batches from a CubeStore.

    Yields (B, patch, patch, C) float32 batches. The stream is the JAX
    ``PatchSampler``'s, draw for draw: an owned ``np.random.default_rng(seed)``
    (PCG64), per sample the crop row x, the crop column y and the mode, in
    that order, from ``integers`` with the same bounds; the cube of sample i
    of batch n is ``(n*B + i) % N``; an epoch drops the remainder batch
    (reference model.py:253, PARITY #7).
    """

    def __init__(self, store: CubeStore, batch_size: int, patch_size: int, seed: int = 41):
        if len(store) == 0:
            raise ValueError("PatchSampler needs a non-empty CubeStore")
        self.store = store
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.rng = np.random.default_rng(seed)
        for i, (h, w, *_rest) in enumerate(store.shapes):
            if h < patch_size or w < patch_size:
                raise ValueError(f"cube {store.files[i]} ({h}×{w}) is smaller than "
                                 f"patch_size={patch_size}")

    @property
    def num_batches(self) -> int:
        """Batches per epoch; the remainder is dropped."""
        return len(self.store) // self.batch_size

    def sample_batch(self, batch_id: int = 0) -> np.ndarray:
        b, p = self.batch_size, self.patch_size
        out = np.empty((b, p, p, self.store.channels), dtype=np.float32)
        n = len(self.store)
        for i in range(b):
            cube = self.store[(batch_id * b + i) % n]
            h, w, _ = cube.shape
            # Exclusive high, as the reference's np.random.randint(0, h - p).
            x = int(self.rng.integers(0, max(h - p, 1)))
            y = int(self.rng.integers(0, max(w - p, 1)))
            mode = int(self.rng.integers(0, 8))
            out[i] = data_augmentation(cube[x:x + p, y:y + p, :], mode)
        return out

    def epoch(self) -> Iterator[np.ndarray]:
        for batch_id in range(self.num_batches):
            yield self.sample_batch(batch_id)

    def skip_epochs(self, n: int) -> None:
        """Advance the RNG past ``n`` epochs without cropping, for resume.

        ``Generator.integers`` consumes a bound-dependent amount of state, so
        the skip replays the exact calls of :meth:`sample_batch`.
        """
        b, p = self.batch_size, self.patch_size
        shapes = self.store.shapes
        n_cubes = len(self.store)
        for _ in range(max(int(n), 0)):
            for batch_id in range(self.num_batches):
                for i in range(b):
                    h, w, *_rest = shapes[(batch_id * b + i) % n_cubes]
                    self.rng.integers(0, max(h - p, 1))
                    self.rng.integers(0, max(w - p, 1))
                    self.rng.integers(0, 8)


def store_from_config(cfg, data_path: str, pattern: Optional[str] = None) -> CubeStore:
    """The configured store; ``pattern`` None means the ``data_pattern`` key."""
    if cfg.lazy_loading:
        raise NotImplementedError(
            "lazy_loading: the disk-backed store is not ported yet (ROADMAP.md queue 1, item 9)")
    if pattern is None:
        pattern = cfg.data_pattern or "*.mat"
    return CubeStore(data_path, mat_key=cfg.mat_key, normalization=cfg.normalization,
                     global_min=cfg.global_min, global_max=cfg.global_max, pattern=pattern)
