"""The port's host data path against the JAX package's on the CPU: the
PatchSampler stream (bit for bit, also after ``skip_epochs``), the native
sampler's batches (byte for byte, also after ``skip_epochs``), ``make_sampler``'s
resolution of the ``sampler`` key and its errors, a ``sampler: auto`` host
run's losses, the 8 augmentation modes (exact) and StepLR (exact)."""

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax

from sshslie_tpu.config import Config as JaxConfig
from sshslie_tpu.data import native_sampler as jax_native
from sshslie_tpu.data.datasets import CubeStore as JaxCubeStore
from sshslie_tpu.data.datasets import PatchSampler as JaxPatchSampler
from sshslie_tpu.train import Trainer as JaxTrainer
from sshslie_tpu.utils.augment import data_augmentation as jax_augment
from sshslie_tpu.utils.schedule import step_lr as jax_step_lr
from sshslie_torch.config import load_config
from sshslie_torch.data import native_sampler
from sshslie_torch.data.datasets import CubeStore, PatchSampler
from sshslie_torch.interop import jax_params_to_state_dict
from sshslie_torch.train import LOSS_KEYS, Trainer
from sshslie_torch.utils.augment import data_augmentation
from sshslie_torch.utils.schedule import step_lr


@pytest.fixture
def cube_dir(tmp_path):
    """Five cubes of mixed sizes, so crop bounds differ from cube to cube."""
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(24, 24), (30, 21), (24, 40), (19, 33), (26, 26)]):
        sio.savemat(str(tmp_path / f"c{i}.mat"),
                    {"data": (rng.random((h, w, 6)) * 100).astype(np.float32)})
    return str(tmp_path)


@pytest.mark.parametrize("batch_size,patch_size,seed", [(2, 16, 41), (3, 8, 7), (1, 19, 0)])
def test_patch_sampler_stream_equals_jax(cube_dir, batch_size, patch_size, seed):
    ours = PatchSampler(CubeStore(cube_dir, normalization="self"), batch_size, patch_size, seed)
    theirs = JaxPatchSampler(JaxCubeStore(cube_dir, normalization="self"), batch_size,
                             patch_size, seed)
    assert ours.num_batches == theirs.num_batches == 5 // batch_size
    for _ in range(3):
        for a, b in zip(ours.epoch(), theirs.epoch(), strict=True):
            assert a.dtype == np.float32 and a.shape == (batch_size, patch_size, patch_size, 6)
            np.testing.assert_array_equal(a, b)


def test_patch_sampler_skip_epochs_equals_jax(cube_dir):
    ours = PatchSampler(CubeStore(cube_dir, normalization="self"), 2, 16, 41)
    theirs = JaxPatchSampler(JaxCubeStore(cube_dir, normalization="self"), 2, 16, 41)
    ours.skip_epochs(3)
    theirs.skip_epochs(3)
    for a, b in zip(ours.epoch(), theirs.epoch(), strict=True):
        np.testing.assert_array_equal(a, b)
    # Skipping equals drawing: after 3 drawn epochs a sampler yields what a skipped one does.
    drawn = PatchSampler(CubeStore(cube_dir, normalization="self"), 2, 16, 41)
    for _ in range(3):
        list(drawn.epoch())
    skipped = PatchSampler(CubeStore(cube_dir, normalization="self"), 2, 16, 41)
    skipped.skip_epochs(3)
    for a, b in zip(drawn.epoch(), skipped.epoch(), strict=True):
        np.testing.assert_array_equal(a, b)


def test_patch_sampler_rejects_small_cubes(cube_dir):
    with pytest.raises(ValueError, match="smaller than patch_size"):
        PatchSampler(CubeStore(cube_dir, normalization="self"), 2, 20, 41)


def test_native_library_loads_in_both_packages():
    assert native_sampler.native_available() and jax_native.native_available()


@pytest.mark.parametrize("batch_size,patch_size,seed", [(2, 16, 41), (3, 8, 7), (1, 19, 0)])
def test_native_sampler_batches_equal_jax(cube_dir, batch_size, patch_size, seed):
    ours = native_sampler.NativePatchSampler(CubeStore(cube_dir, normalization="self"),
                                             batch_size, patch_size, seed)
    theirs = jax_native.NativePatchSampler(JaxCubeStore(cube_dir, normalization="self"),
                                           batch_size, patch_size, seed)
    assert ours.num_batches == theirs.num_batches == 5 // batch_size
    ours.skip_epochs(2)
    theirs.skip_epochs(2)
    for _ in range(2):
        for a, b in zip(ours.epoch(), theirs.epoch(), strict=True):
            assert a.dtype == np.float32 and a.shape == (batch_size, patch_size, patch_size, 6)
            assert a.tobytes() == b.tobytes()
    # Keyed on (seed, epoch, batch id): an explicit epoch and batch id draw the same.
    np.testing.assert_array_equal(ours.sample_batch(1 % ours.num_batches, epoch=3),
                                  theirs.sample_batch(1 % theirs.num_batches, epoch=3))
    # Skipping equals drawing; another epoch draws another batch.
    drawn = native_sampler.NativePatchSampler(CubeStore(cube_dir, normalization="self"),
                                              batch_size, patch_size, seed)
    first = next(drawn.epoch())
    list(drawn.epoch())
    skipped = native_sampler.NativePatchSampler(CubeStore(cube_dir, normalization="self"),
                                                batch_size, patch_size, seed)
    skipped.skip_epochs(2)
    np.testing.assert_array_equal(next(drawn.epoch()), next(skipped.epoch()))
    assert not np.array_equal(first, next(drawn.epoch()))


@pytest.mark.parametrize("mode", ["auto", "native", "python"])
def test_make_sampler_resolves_as_jax(cube_dir, mode):
    ours = native_sampler.make_sampler(CubeStore(cube_dir, normalization="self"), 2, 16, 5,
                                       mode=mode)
    theirs = jax_native.make_sampler(JaxCubeStore(cube_dir, normalization="self"), 2, 16, 5,
                                     mode=mode)
    assert type(ours).__name__ == type(theirs).__name__
    assert type(ours).__name__ == ("PatchSampler" if mode == "python" else "NativePatchSampler")
    np.testing.assert_array_equal(next(ours.epoch()), next(theirs.epoch()))


def test_make_sampler_errors_as_jax(cube_dir, tmp_path, monkeypatch):
    store = CubeStore(cube_dir, normalization="self")
    with pytest.raises(ValueError, match="auto\\|native\\|python"):
        native_sampler.make_sampler(store, 2, 16, mode="cuda")
    with pytest.raises(ValueError, match="smaller than patch_size"):
        native_sampler.make_sampler(store, 2, 20, mode="native")
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    for i, c in enumerate((6, 4)):
        sio.savemat(str(mixed / f"m{i}.mat"), {"data": np.ones((20, 20, c), np.float32)})
    with pytest.raises(ValueError, match="uniform channel count"):
        native_sampler.NativePatchSampler(CubeStore(str(mixed), normalization="self"), 2, 16)
    with pytest.raises(ValueError, match="uniform channel count"):
        jax_native.NativePatchSampler(JaxCubeStore(str(mixed), normalization="self"), 2, 16)
    # Without the library: auto falls back to PatchSampler, native raises.
    monkeypatch.setattr(native_sampler, "_lib", None)
    monkeypatch.setattr(native_sampler, "_LIB_PATH", str(tmp_path / "missing.so"))
    assert not native_sampler.native_available()
    assert isinstance(native_sampler.make_sampler(store, 2, 16), PatchSampler)
    with pytest.raises(RuntimeError, match="not built"):
        native_sampler.make_sampler(store, 2, 16, mode="native")


def test_sampler_auto_host_run_matches_jax(cube_dir, tmp_path):
    """fused_pipeline off and sampler auto: both trainers draw from the native
    sampler, so two epochs of one step each give JAX's losses."""
    kw = dict(channels=6, patch_size=16, batch_size=4, epoch=2, eval_every_epoch=100,
              plot_every_epoch=100, attention_impl="xla", fused_pipeline="off",
              sampler="auto", seed_value=41)
    jcfg = JaxConfig(**kw)
    jcfg.finalize()
    jtrainer = JaxTrainer(jcfg, channels=6)
    sd = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    jtrainer.fit(JaxCubeStore(cube_dir, normalization="self"), ckpt_dir=str(tmp_path / "jax"))
    trainer = Trainer(load_config(None, dict(kw, device="cpu")), 6, state_dict=sd)
    trainer.fit(CubeStore(cube_dir, normalization="self"), ckpt_dir=str(tmp_path / "port"))
    jax_losses = jtrainer.all_epoch_losses
    scale = 2e-5 * np.asarray(jax_losses["total_loss"])
    for k in LOSS_KEYS:
        assert len(trainer.all_epoch_losses[k]) == 2
        np.testing.assert_array_less(
            np.abs(np.subtract(trainer.all_epoch_losses[k], jax_losses[k])), scale, err_msg=k)


@pytest.mark.parametrize("mode", range(8))
def test_augment_modes_equal_jax(mode):
    patch = np.random.default_rng(mode).random((5, 5, 3)).astype(np.float32)
    got = data_augmentation(patch, mode)
    np.testing.assert_array_equal(got, jax_augment(patch, mode))
    assert got.shape == patch.shape


def test_augment_rejects_bad_mode():
    with pytest.raises(ValueError):
        data_augmentation(np.zeros((2, 2, 1)), 8)


@pytest.mark.parametrize("gamma,period,unfreeze", [(1.0, 3, 0), (0.1, 3, 0), (0.5, 2, 0),
                                                   (0.1, 3, 4), (0.5, 4, 5)])
def test_step_lr_equals_jax(gamma, period, unfreeze):
    for epoch in range(12):
        assert step_lr(epoch, 1e-3, gamma, period, unfreeze) == \
            jax_step_lr(epoch, 1e-3, gamma, period, unfreeze)
