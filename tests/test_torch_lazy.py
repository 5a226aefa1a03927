"""The port's disk-backed store and prefetcher against the JAX package's on
the CPU.

* ``LazyCubeStore``: shapes from v5 ``.mat`` (``whosmat``), v7.3 (h5py, axes
  reversed) and ENVI ``.hdr`` headers equal to JAX's, without a load; the
  cubes equal; one access sequence gives JAX's ``load_count`` and LRU order;
  the missing-key message; concurrent readers; ``store_from_config``;
  ``make_sampler`` on a lazy store (``native`` raises JAX's message, ``auto``
  takes PatchSampler).
* ``Prefetcher``: JAX's four behaviours (tests/test_data.py: delivers every
  batch, ``close`` releases a blocked worker, StopIteration after
  exhaustion, a worker's error raised in the consumer), its batches equal
  the sampler's, and a host-pipeline run with ``prefetch_batches: 3`` equals
  ``train_step`` on the unprefetched batches bit for bit; the host pipeline
  on a lazy store equals the in-RAM store with ``sampler: python``.
"""

import threading

import numpy as np
import pytest
import scipy.io as sio
import torch

from sshslie_tpu.data.datasets import LazyCubeStore as JaxLazy
from sshslie_torch.config import load_config
from sshslie_torch.data.datasets import (CubeStore, LazyCubeStore, PatchSampler, Prefetcher,
                                         store_from_config)
from sshslie_torch.data.native_sampler import make_sampler
from sshslie_torch.train import LOSS_KEYS, Trainer, train_step
from sshslie_torch.utils.io_envi import save_envi
from sshslie_torch.utils.io_hsi import save_hsi

KW = dict(channels=6, patch_size=16, batch_size=2, epoch=2, eval_every_epoch=100,
          plot_every_epoch=100, attention_impl="dense", seed_value=41, device="cpu",
          fused_pipeline="off", normalization="self")


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    """Five cubes: v5 .mat, v7.3 .mat and ENVI pairs, two shapes."""
    d = tmp_path_factory.mktemp("lazy")
    rng = np.random.default_rng(21)
    cubes = [(rng.random(shape) * 100).astype(np.float32)
             for shape in ((24, 20, 6), (20, 24, 6), (24, 24, 6), (24, 20, 6), (22, 24, 6))]
    sio.savemat(str(d / "a0.mat"), {"data": cubes[0]})
    save_hsi(str(d / "a1.mat"), cubes[1], fmt="v7.3")
    save_envi(str(d / "a2"), cubes[2], interleave="bil")
    sio.savemat(str(d / "a3.mat"), {"data": cubes[3]})
    save_hsi(str(d / "a4.mat"), cubes[4], fmt="v7.3")
    return str(d)


@pytest.fixture(scope="module")
def cube_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("four")
    rng = np.random.RandomState(20260816)
    for i in range(4):
        sio.savemat(str(d / f"c{i}.mat"), {"data": (rng.rand(24, 24, 6) * 100).astype(np.float32)})
    return str(d)


@pytest.mark.parametrize("pattern", ["*.mat", "*.hdr"])
def test_shapes_and_cubes_equal_jax(mixed_dir, pattern):
    ours = LazyCubeStore(mixed_dir, pattern=pattern, normalization="self", cache_size=2)
    theirs = JaxLazy(mixed_dir, pattern=pattern, normalization="self", cache_size=2)
    assert ours.files == theirs.files and len(ours) == len(theirs) > 0
    assert ours.shapes == theirs.shapes
    assert ours.load_count == 0 and ours.channels == theirs.channels == 6
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i], theirs[i])
        assert ours[i].shape == ours.shapes[i]
    for a, b in zip(ours.cubes, theirs.cubes):
        np.testing.assert_array_equal(a, b)


def test_load_count_and_lru_order_equal_jax(mixed_dir):
    ours = LazyCubeStore(mixed_dir, normalization="self", cache_size=2)
    theirs = JaxLazy(mixed_dir, normalization="self", cache_size=2)
    for i in (0, 1, 0, 2, 1, 3, 3, -1, 0, 2, 2, 1):
        ours[i], theirs[i]
        assert ours.load_count == theirs.load_count
        assert list(ours._cache) == list(theirs._cache)
    assert ours.load_count == 8
    with pytest.raises(AttributeError, match="derived from disk"):
        ours.cubes = []


def test_missing_key_message_equals_jax(mixed_dir):
    for cls in (LazyCubeStore, JaxLazy):
        with pytest.raises(KeyError, match=r"a0.mat: variable 'cube' not found; available: \['data'\]"):
            cls(mixed_dir, mat_key="cube", pattern="a0.mat")


class _CountingStore(LazyCubeStore):
    """Counts the disk loads apart, under its own lock."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.loads, self._loads_lock = 0, threading.Lock()

    def _load(self, idx):
        with self._loads_lock:
            self.loads += 1
        return super()._load(idx)


def test_concurrent_readers(mixed_dir):
    """More reader threads than cores, a short switch interval: every read
    is right, the cache stays bounded, and no miss is lost from load_count."""
    import os
    import sys

    store = _CountingStore(mixed_dir, normalization="self", cache_size=2)
    ram = CubeStore(mixed_dir, normalization="self")
    want = dict(zip(ram.files, ram.cubes))
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in rng.integers(0, len(store), 40):
                np.testing.assert_array_equal(store[int(i)], want[store.files[int(i)]])
        except BaseException as e:  # noqa: BLE001 — raised below, on the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(store._cache) <= 2 and store.load_count == store.loads >= len(store)


def test_store_from_config_and_make_sampler(cube_dir):
    lazy_cfg = load_config(None, dict(KW, lazy_loading=True, cube_cache_size=3), finalize=False)
    store = store_from_config(lazy_cfg, cube_dir)
    assert type(store) is LazyCubeStore and store.cache_size == 3 and len(store) == 4
    assert type(store_from_config(load_config(None, KW, finalize=False), cube_dir)) is CubeStore
    assert type(make_sampler(store, 2, 16, mode="auto")) is PatchSampler
    assert type(make_sampler(store, 2, 16, mode="python")) is PatchSampler
    with pytest.raises(ValueError, match="sampler='native' is incompatible with lazy_loading"):
        make_sampler(store, 2, 16, mode="native")
    assert store.load_count == 0


def _stream(n=100):
    for _ in range(n):
        yield np.zeros((1, 4, 4, 2), np.float32)


def test_prefetcher_delivers_every_batch_as_the_sampler(cube_dir):
    store = CubeStore(cube_dir, normalization="self")
    got = list(Prefetcher(PatchSampler(store, 2, 16, seed=0).epoch(), depth=2))
    want = list(PatchSampler(store, 2, 16, seed=0).epoch())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)


def test_prefetcher_close_releases_blocked_worker():
    pf = Prefetcher(_stream(), depth=1)
    assert next(pf).shape == (1, 4, 4, 2)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_next_after_exhaustion_raises():
    pf = Prefetcher(_stream(1), depth=1)
    assert len(list(pf)) == 1
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_propagates_errors():
    def bad():
        yield np.zeros((1, 4, 4, 2), np.float32)
        raise RuntimeError("boom")

    with Prefetcher(bad(), depth=1) as it:
        next(it)
        with pytest.raises(RuntimeError, match="boom"):
            next(it)


def test_prefetched_host_run_equals_unprefetched_steps(cube_dir, tmp_path):
    cfg = load_config(None, dict(KW, sampler="python", prefetch_batches=3))
    trainer = Trainer(cfg, 6)
    trainer.fit(CubeStore(cube_dir, normalization="self"), ckpt_dir=str(tmp_path / "p"))
    assert trainer.pipeline == "host"
    ref = Trainer(cfg, 6)
    sampler = PatchSampler(CubeStore(cube_dir, normalization="self"), 2, 16, seed=41)
    for epoch in range(2):
        terms = [train_step(ref.model, ref.optimizer, torch.from_numpy(b), ref.coeffs)
                 for b in sampler.epoch()]
        for k in LOSS_KEYS:
            assert trainer.all_epoch_losses[k][epoch] == float(terms[0][k] + terms[1][k]) / 2, k
    sd, want = trainer.model.state_dict(), ref.model.state_dict()
    for name in want:
        assert torch.equal(sd[name], want[name]), name


def test_host_pipeline_on_a_lazy_store_equals_in_ram_python(cube_dir, tmp_path, capsys):
    lazy = Trainer(load_config(None, dict(KW, lazy_loading=True, cube_cache_size=2)), 6)
    store = LazyCubeStore(cube_dir, normalization="self", cache_size=2)
    lazy.fit(store, ckpt_dir=str(tmp_path / "l"))
    assert "Patch sampler: PatchSampler (sampler='auto'" in capsys.readouterr().out
    ram = Trainer(load_config(None, dict(KW, sampler="python")), 6)
    ram.fit(CubeStore(cube_dir, normalization="self"), ckpt_dir=str(tmp_path / "r"))
    for k in LOSS_KEYS:
        assert lazy.all_epoch_losses[k] == ram.all_epoch_losses[k], k
