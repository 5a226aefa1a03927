"""The native (C++) patch sampler through ctypes, as
``sshslie_tpu/data/native_sampler.py`` (``native_available``,
``NativePatchSampler``, ``make_sampler``).

The library is the repo's committed ``native/libpatch_sampler.so`` (source
``native/patch_sampler.cpp``, built by ``native/build.sh``): one call fills a
whole (B, P, P, C) float32 batch from the in-RAM cubes, its crops and modes
drawn from xoshiro256** in the (x, y, mode) order of the Python sampler and
the copies spread over a thread pool. The draws are made before the threads
start, so the batch does not depend on the thread count. The port wraps the
same library with the same seed mixing, so for the same cubes, seed, epoch
and batch id its batches are the JAX package's byte for byte.

``make_sampler`` resolves the ``sampler`` key as JAX does: ``native``
requires the library and an in-RAM store, ``auto`` takes it when it loads
and the store is in RAM, ``python`` (and ``auto`` on a disk-backed store)
takes :class:`~sshslie_torch.data.datasets.PatchSampler` (the numpy PCG64
stream).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional

import numpy as np

from sshslie_torch.data.datasets import CubeStore, LazyCubeStore, PatchSampler

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libpatch_sampler.so",
)

_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.sample_batch.restype = ctypes.c_int
    lib.sample_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),                  # cubes
        ctypes.POINTER(ctypes.c_int64),                   # heights
        ctypes.POINTER(ctypes.c_int64),                   # widths
        ctypes.c_int64,                                   # num_cubes
        ctypes.c_int64,                                   # channels
        ctypes.c_int64,                                   # batch
        ctypes.c_int64,                                   # patch
        ctypes.c_int64,                                   # batch_start
        ctypes.c_uint64,                                  # seed
        ctypes.c_void_p,                                  # out
        ctypes.c_int,                                     # num_threads
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    """Does ``native/libpatch_sampler.so`` exist and load?"""
    return _load_lib() is not None


class NativePatchSampler:
    """The PatchSampler interface on the C++ library.

    The stream differs from PatchSampler's (xoshiro256** against PCG64) and
    is keyed on (seed, epoch, batch id), so a run is reproducible and a
    resumed one replays the uninterrupted one.
    """

    def __init__(self, store: CubeStore, batch_size: int, patch_size: int,
                 seed: int = 41, num_threads: Optional[int] = None):
        if num_threads is None:
            # One worker a core, at most 8 and at most one a sample.
            num_threads = max(1, min(os.cpu_count() or 1, 8, batch_size))
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native sampler library not built: {_LIB_PATH} "
                               "(run native/build.sh)")
        if len(store) == 0:
            raise ValueError("NativePatchSampler needs a non-empty CubeStore")
        self._lib = lib
        self.store = store
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.seed = seed
        self.num_threads = num_threads
        self._epoch_counter = 0

        # C-contiguous float32 cubes, kept alive here, and the pointer tables.
        self._cubes = [np.ascontiguousarray(c, dtype=np.float32) for c in store.cubes]
        n = len(self._cubes)
        self._ptrs = (ctypes.c_void_p * n)(
            *[c.ctypes.data_as(ctypes.c_void_p).value for c in self._cubes])
        self._heights = (ctypes.c_int64 * n)(*[c.shape[0] for c in self._cubes])
        self._widths = (ctypes.c_int64 * n)(*[c.shape[1] for c in self._cubes])
        self._channels = self._cubes[0].shape[2]
        for i, c in enumerate(self._cubes):
            if c.shape[0] < patch_size or c.shape[1] < patch_size:
                raise ValueError(f"cube {store.files[i]} smaller than patch_size={patch_size}")
            if c.shape[2] != self._channels:
                # The library indexes every cube with one channel count: a
                # mismatched cube would be read out of bounds.
                raise ValueError(
                    f"cube {store.files[i]} has {c.shape[2]} channels but "
                    f"{store.files[0]} has {self._channels}; the native "
                    "sampler needs a uniform channel count")

    @property
    def num_batches(self) -> int:
        """Batches per epoch; the remainder is dropped."""
        return len(self.store) // self.batch_size

    def sample_batch(self, batch_id: int = 0, epoch: Optional[int] = None) -> np.ndarray:
        if epoch is None:
            epoch = self._epoch_counter
        out = np.empty((self.batch_size, self.patch_size, self.patch_size, self._channels),
                       dtype=np.float32)
        # (seed, epoch, batch_id) mixed into one 64-bit stream id.
        mask = (1 << 64) - 1
        seed = ((self.seed * 0x9E3779B97F4A7C15) & mask
                ^ (epoch * 0xBF58476D1CE4E5B9) & mask
                ^ batch_id) & mask
        rc = self._lib.sample_batch(
            self._ptrs, self._heights, self._widths,
            ctypes.c_int64(len(self._cubes)), ctypes.c_int64(self._channels),
            ctypes.c_int64(self.batch_size), ctypes.c_int64(self.patch_size),
            ctypes.c_int64(batch_id * self.batch_size), ctypes.c_uint64(int(seed)),
            out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(self.num_threads),
        )
        if rc != 0:
            raise RuntimeError(f"native sample_batch failed with code {rc}")
        return out

    def epoch(self) -> Iterator[np.ndarray]:
        e = self._epoch_counter
        self._epoch_counter += 1
        for batch_id in range(self.num_batches):
            yield self.sample_batch(batch_id, epoch=e)

    def skip_epochs(self, n: int) -> None:
        """Resume: the stream is keyed on the epoch, so skipping advances the
        epoch counter and draws nothing."""
        self._epoch_counter += max(int(n), 0)


def make_sampler(store: CubeStore, batch_size: int, patch_size: int,
                 seed: int = 41, mode: str = "auto"):
    """The host patch sampler for the ``sampler`` key.

    * ``auto``: NativePatchSampler if the library loads and the store is in
      RAM, else PatchSampler. The two draw from other streams, so the caller
      logs the choice.
    * ``native``: NativePatchSampler; raises if the library is missing or
      the store is disk-backed (the library holds every cube in RAM, which
      a ``LazyCubeStore`` exists to avoid).
    * ``python``: PatchSampler (the numpy PCG64 stream).

    JAX's legacy ``prefer_native`` alias of ``mode='python'`` has no
    counterpart: no caller uses it.
    """
    if mode not in ("auto", "native", "python"):
        raise ValueError(f"sampler mode must be auto|native|python, got {mode!r}")
    lazy = isinstance(store, LazyCubeStore)
    if mode == "native":
        if lazy:
            raise ValueError("sampler='native' is incompatible with lazy_loading: the "
                             "native sampler pins every cube in RAM")
        return NativePatchSampler(store, batch_size, patch_size, seed)
    if mode == "auto" and native_available() and not lazy:
        return NativePatchSampler(store, batch_size, patch_size, seed)
    return PatchSampler(store, batch_size, patch_size, seed)
