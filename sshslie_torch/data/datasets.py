"""Cube stores, the host patch sampler and the batch prefetcher, as
``sshslie_tpu/data/datasets.py``.

* :class:`CubeStore` loads every cube of a directory to RAM;
  :class:`LazyCubeStore` (``lazy_loading: true``) reads shapes from the
  files' headers and loads cubes on first access into an LRU cache of
  ``cube_cache_size`` cubes; :func:`store_from_config` picks one.
* :class:`PatchSampler` draws the JAX package's PCG64 stream of crops.
* :class:`Prefetcher` stages the host pipeline's batches onto the device on a
  worker thread, ``prefetch_batches`` ahead of the step; it changes the
  speed and not the batches.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import OrderedDict
from glob import glob
from typing import Iterator, List, Optional

import numpy as np
import torch

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

    def basenames(self) -> List[str]:
        return [os.path.basename(f) for f in self.files]


class LazyCubeStore(CubeStore):
    """Disk-backed cube store with an LRU cache, for datasets larger than
    host RAM (JAX ``LazyCubeStore``).

    Shapes come from the files' headers without reading pixels:
    ``scipy.io.whosmat`` for a v5 ``.mat``, h5py for v7.3 (axes reversed),
    the text header for ENVI ``.hdr``. A cube is loaded on first access and
    the least recently used one is evicted past ``cache_size``. ``cubes``
    yields each cube through the cache as it is reached, so nothing loads
    the whole dataset by accident; ``train.stack_cubes`` returns None for
    this store and the fused pipeline takes a ``fused_window`` instead.
    """

    def __init__(
        self,
        data_path: str,
        mat_key: str = "data",
        normalization: Optional[str] = "global_normalization",
        global_min: Optional[float] = None,
        global_max: Optional[float] = None,
        pattern: str = "*.mat",
        cache_size: int = 8,
    ):
        import scipy.io as sio

        self.files = sorted(glob(os.path.join(data_path, pattern)))
        self._load_kwargs = dict(mat_key=mat_key, normalization=normalization,
                                 max_val=global_max, min_val=global_min)
        self.cache_size = max(int(cache_size), 1)
        # The OrderedDict is the LRU order: move_to_end on a hit, popitem of
        # the oldest to evict. The lock makes the store safe to share between
        # threads (the Prefetcher's worker, the window feeder, the main thread).
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self.load_count = 0  # disk loads, re-loads included
        self.shapes: List[tuple] = []
        for f in self.files:
            if f.lower().endswith(".hdr"):
                from sshslie_torch.utils.io_envi import read_envi_header

                h = read_envi_header(f)
                self.shapes.append((int(str(h["lines"])), int(str(h["samples"])),
                                    int(str(h["bands"]))))
                continue
            try:
                entries = {n: sh for n, sh, _ in sio.whosmat(f)}
                if mat_key not in entries:
                    raise KeyError(f"{f}: variable {mat_key!r} not found; available: "
                                   f"{sorted(entries)}")
                self.shapes.append(tuple(entries[mat_key]))
            except (NotImplementedError, ValueError):
                # v7.3 (HDF5): the dataset's shape without its pixels, axes reversed.
                import h5py

                if not h5py.is_hdf5(f):
                    raise
                with h5py.File(f, "r") as fh:
                    self.shapes.append(tuple(reversed(fh[mat_key].shape)))

    def _load(self, idx: int) -> np.ndarray:
        return load_hsi(self.files[idx], **self._load_kwargs)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        if idx < 0:
            idx += len(self)
        with self._cache_lock:
            if idx in self._cache:
                self._cache.move_to_end(idx)
                return self._cache[idx]
            self.load_count += 1
        # The disk read runs outside the lock: two concurrent misses may load
        # a cube twice (the last one stays), but no reader waits on another's I/O.
        cube = self._load(idx)
        with self._cache_lock:
            self._cache[idx] = cube
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return cube

    @property
    def cubes(self):  # type: ignore[override]
        """Each cube loaded through the cache as it is reached."""
        return _LazyCubesView(self)

    @cubes.setter
    def cubes(self, _value):
        raise AttributeError("LazyCubeStore.cubes is derived from disk")

    @property
    def channels(self) -> int:
        if not self.files:
            raise ValueError("empty cube store")
        return self.shapes[0][-1]


class _LazyCubesView:
    def __init__(self, store: LazyCubeStore):
        self._store = store

    def __len__(self) -> int:
        return len(self._store)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self._store[idx]

    def __iter__(self):
        for i in range(len(self._store)):
            yield self._store[i]


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


class Prefetcher:
    """A worker thread that stages host batches onto ``device``, up to
    ``depth`` ahead of the consumer (JAX ``Prefetcher``).

    On a CUDA device the worker pins each batch and copies it on a side
    stream, then records an event. ``__next__`` makes the consumer's current
    stream wait on that event and hands the tensor to it with
    ``record_stream``, so the caching allocator does not reuse its memory
    before the consumer's work on it is done. On the CPU a batch becomes a
    tensor over the same numpy buffer.

    ``put`` waits in bounded steps, so :meth:`close` releases a worker that
    an abandoned consumer left blocked on a full queue; the worker ends with
    one ``_DONE`` sentinel, after which ``__next__`` raises the worker's
    error, if any, and StopIteration ever after.

    Data parallel: ``process_slice`` (this rank's sample range,
    ``parallel.distributed.process_batch_slice``) keeps only those samples
    of each batch. Every rank draws the same stream of global batches, so
    the ranks' slices together are the one-process batch.
    """

    _DONE = object()

    def __init__(self, iterator, device=None, depth: int = 2,
                 process_slice: Optional[slice] = None):
        self._queue: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._device = torch.device("cpu") if device is None else torch.device(device)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._exhausted = False
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stage(batch):
            if process_slice is not None:
                batch = batch[process_slice]
            host = torch.from_numpy(np.ascontiguousarray(batch))
            if not cuda:
                return host, None
            with torch.cuda.stream(stream):
                dev = host.pin_memory().to(self._device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
            return dev, ready

        def worker():
            try:
                for batch in iterator:
                    if self._stop.is_set():
                        return
                    if not put(stage(batch)):
                        return
            except BaseException as e:  # raised in the consumer's thread
                self._err = e
            finally:
                put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True, name="prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        if self._exhausted:
            # The one _DONE was consumed: another get() would wait forever.
            raise StopIteration
        item = self._queue.get()
        if item is self._DONE:
            self._exhausted = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(ready)
            batch.record_stream(current)
        return batch

    def close(self) -> None:
        """Release the worker and drop the staged batches; idempotent."""
        self._stop.set()
        while True:  # drain, so that a worker blocked in put() sees _stop
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        self._exhausted = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def store_from_config(cfg, data_path: str, pattern: Optional[str] = None) -> CubeStore:
    """The configured store: in RAM, or disk-backed with an LRU cache for
    ``lazy_loading: true``. ``pattern`` None means the ``data_pattern`` key
    ("*.hdr" reads ENVI pairs)."""
    if pattern is None:
        pattern = cfg.data_pattern or "*.mat"
    kwargs = dict(mat_key=cfg.mat_key, normalization=cfg.normalization,
                  global_min=cfg.global_min, global_max=cfg.global_max, pattern=pattern)
    if cfg.lazy_loading:
        return LazyCubeStore(data_path, cache_size=cfg.cube_cache_size, **kwargs)
    return CubeStore(data_path, **kwargs)


def load_cubes(data_path: str, mat_key: str = "data",
               normalization: Optional[str] = "global_normalization",
               global_min: Optional[float] = None,
               global_max: Optional[float] = None) -> CubeStore:
    """An in-RAM store of ``data_path``'s ``.mat`` cubes."""
    return CubeStore(data_path, mat_key=mat_key, normalization=normalization,
                     global_min=global_min, global_max=global_max)
