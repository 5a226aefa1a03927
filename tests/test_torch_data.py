"""The port's host data path against the JAX package's on the CPU: the
PatchSampler stream (bit for bit, also after ``skip_epochs``), the 8
augmentation modes (exact) and StepLR (exact)."""

import numpy as np
import pytest
import scipy.io as sio

from sshslie_tpu.data.datasets import CubeStore as JaxCubeStore
from sshslie_tpu.data.datasets import PatchSampler as JaxPatchSampler
from sshslie_tpu.utils.augment import data_augmentation as jax_augment
from sshslie_tpu.utils.schedule import step_lr as jax_step_lr
from sshslie_torch.data.datasets import CubeStore, PatchSampler
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
