"""The port's on-device pipelines and accumulating step on the CPU.

* ``augment_batch`` against JAX ``augment_batch_jax``, bit for bit, for each
  of the 8 modes and for a batch of mixed modes.
* The fused crop (``sample_fused_batch``) against ``jax.lax.dynamic_slice``
  plus ``augment_batch_jax`` on the same draws, bit for bit; the draw table
  (``fused_draws``): offsets in [0, dim - P), modes in [0, 8), a function of
  (seed, epoch) alone.
* ``stack_cubes``: the (N, H, W, C) stack for one shape, None for mixed.
* The accumulating step (K = 2, float32) against JAX
  ``make_accum_train_step``: the terms within rtol 1e-5 (float32 sums in
  another order; measured <= 6.9e-7), the parameters after Adam within
  1e-4 * lr of JAX's where |g| > 1e-5, far above the gradients' rounding, and
  of the first-step formula on the port's own gradients everywhere (as in
  tests/test_torch_train.py); and a Trainer run with K = 2 against K = 1 on
  the same host batches: epoch losses within rtol 1e-4.
* Multistep: K = 2 with a remainder chunk (3 steps an epoch) against single
  fused steps, bit for bit on the CPU (the same steps in the same order),
  at the step and at the Trainer.
* Resume of the fused pipeline: 3 epochs straight against 2 + 1 resumed,
  bit for bit (the draws are a function of the epoch).
* A 5-epoch golden trajectory of the fused pipeline (6 bands, four 24x24
  cubes, batch 2, patch 16, seed 41, the port's own initial weights),
  pinned at rtol 2e-4, the host golden test's own tolerance (PyTorch's CPU
  kernels may sum in another order on another CPU).
* Pipeline selection: 'auto' takes the fused pipeline on one shape and the
  host sampler on mixed shapes; 'on' raises on mixed shapes.
* ``fused_window``: ``WindowedCubeFeeder.indices`` and ``auto_fused_window``
  (in-RAM and lazy stores, mixed shapes, n <= k_min, no memory stats, and
  the same fake budgets fed to both) equal JAX's. The windowed trajectory is
  held to the port's own fused steps, bit for bit on the CPU: a windowed run
  equals fused steps on each epoch's window stack, its resume equals the
  uninterrupted run, its multistep equals single steps, and ``fused_window
  >= N`` on a lazy store equals the resident run. (The JAX and port fused
  streams differ by design, numpy SeedSequence against threefry.)
"""

import dataclasses
import os

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
from sshslie_tpu.train import TrainState, _make_loss_fn, init_params, make_accum_train_step
from sshslie_tpu.train import make_optimizer as jax_make_optimizer
from sshslie_tpu.utils.augment import augment_batch_jax
from sshslie_torch.config import load_config
from sshslie_torch.data.datasets import CubeStore, LazyCubeStore
from sshslie_torch.interop import jax_params_to_state_dict
from sshslie_torch.models.enhance import LowLightEnhanceNet
from sshslie_torch.train import (LOSS_KEYS, Trainer, WindowedCubeFeeder, accum_train_step,
                                 auto_fused_window, fused_draws,
                                 fused_train_step, make_optimizer, multistep_train_step,
                                 sample_fused_batch, stack_cubes)
from sshslie_torch.utils.augment import augment_batch

COEFFS = {
    "c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
    "c_loss_i_smooth_delta": 2000.0, "c_loss_fourier": 20.0, "c_loss_spectral_cons": 1.0,
    "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0,
}
LR = 1e-3
KW = dict(channels=6, patch_size=16, batch_size=2, epoch=5, eval_every_epoch=100,
          plot_every_epoch=100, attention_impl="dense", seed_value=41, device="cpu")
# Per-epoch total loss of the fused pipeline on the dataset of ``cube_dir``.
GOLDEN_FUSED_TOTAL = [4.2412614822387695, 4.058304786682129, 3.618837356567383,
                      3.6057353019714355, 3.5650768280029297]


def _cubes_dir(root, shapes):
    rng = np.random.RandomState(20260816)
    os.makedirs(root, exist_ok=True)
    for i, shape in enumerate(shapes):
        sio.savemat(os.path.join(root, f"c{i}.mat"), {"data": (rng.rand(*shape) * 100).astype(np.float32)})
    return root


@pytest.fixture(scope="module")
def cube_dir(tmp_path_factory):
    return _cubes_dir(str(tmp_path_factory.mktemp("fused")), [(24, 24, 6)] * 4)


@pytest.fixture(scope="module")
def six_cubes(tmp_path_factory):
    """Six cubes: 3 steps an epoch at batch 2, a remainder chunk at K = 2."""
    return _cubes_dir(str(tmp_path_factory.mktemp("six")), [(20, 22, 6)] * 6)


def _store(d):
    return CubeStore(d, normalization="self")


@pytest.mark.parametrize("mode", range(8))
def test_augment_batch_matches_jax_per_mode(mode):
    x = np.random.default_rng(mode).random((3, 7, 7, 5), dtype=np.float32)
    modes = np.full(3, mode)
    want = np.asarray(augment_batch_jax(jnp.asarray(x), jnp.asarray(modes)))
    got = augment_batch(torch.from_numpy(x), torch.from_numpy(modes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_augment_batch_mixed_modes_and_range():
    x = np.random.default_rng(9).random((16, 6, 6, 3), dtype=np.float32)
    modes = np.random.default_rng(10).integers(0, 8, 16)
    want = np.asarray(augment_batch_jax(jnp.asarray(x), jnp.asarray(modes)))
    np.testing.assert_array_equal(augment_batch(torch.from_numpy(x), torch.from_numpy(modes)).numpy(), want)
    with pytest.raises(IndexError):
        augment_batch(torch.from_numpy(x), torch.full((16,), 8))


def test_fused_crop_matches_dynamic_slice():
    cubes = np.random.default_rng(1).random((3, 21, 26, 4), dtype=np.float32)
    p, b = 8, 5
    draws = fused_draws(7, 2, 1, b, (21, 26), p)[0]
    batch_start = 4
    idx = (batch_start + np.arange(b)) % 3
    patches = jnp.stack([jax.lax.dynamic_slice(jnp.asarray(cubes), (int(i), int(x), int(y), 0),
                                               (1, p, p, 4))[0]
                         for i, (x, y, _) in zip(idx, draws)])
    want = np.asarray(augment_batch_jax(patches, jnp.asarray(draws[:, 2])))
    got = sample_fused_batch(torch.from_numpy(cubes), torch.from_numpy(draws), batch_start, p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_draws_ranges_and_stream():
    table = fused_draws(41, 3, 50, 4, (30, 40), 16)
    assert table.shape == (50, 4, 3) and table.dtype == np.int64
    assert table[..., 0].min() >= 0 and table[..., 0].max() < 30 - 16
    assert table[..., 1].min() >= 0 and table[..., 1].max() < 40 - 16
    assert set(np.unique(table[..., 2])) == set(range(8))
    np.testing.assert_array_equal(table, fused_draws(41, 3, 50, 4, (30, 40), 16))
    assert not np.array_equal(table, fused_draws(41, 4, 50, 4, (30, 40), 16))
    assert not np.array_equal(table, fused_draws(42, 3, 50, 4, (30, 40), 16))


def test_stack_cubes(cube_dir, tmp_path):
    stack = stack_cubes(_store(cube_dir), "cpu")
    assert stack.shape == (4, 24, 24, 6) and stack.dtype == torch.float32
    np.testing.assert_array_equal(stack[2].numpy(), _store(cube_dir)[2])
    mixed = _cubes_dir(str(tmp_path / "m"), [(24, 24, 6), (20, 24, 6)])
    assert stack_cubes(_store(mixed), "cpu") is None


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_accum_step_matches_jax():
    jm = JaxNet(input_channels=6)
    params = init_params(jm, 3, 16)
    batch = np.random.default_rng(4).random((4, 16, 16, 6), dtype=np.float32) * 0.4 + 0.05
    _, jgrads = jax.value_and_grad(_make_loss_fn(jm, COEFFS), has_aux=True)(
        params, jnp.asarray(batch))
    host = _np_tree(params)
    sd = jax_params_to_state_dict(host)
    tx = jax_make_optimizer()
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, host), opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    new_state, jterms = make_accum_train_step(jm, tx, COEFFS, 2)(state, jnp.asarray(batch),
                                                                 jnp.float32(LR))
    after = jax_params_to_state_dict(_np_tree(new_state.params))
    strong_g = jax_params_to_state_dict(_np_tree(jgrads))
    model = LowLightEnhanceNet(6)
    model.load_state_dict(sd, strict=True)
    model.train()
    terms = accum_train_step(model, make_optimizer(model, LR), torch.from_numpy(batch), COEFFS, 2)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), rtol=1e-5, err_msg=k)
    for name, p in model.named_parameters():
        g, got = p.grad.numpy(), p.detach().numpy()
        np.testing.assert_allclose(got, sd[name].numpy() - LR * g / (np.abs(g) + 1e-8),
                                   atol=1e-4 * LR, rtol=0, err_msg=name)
        strong = np.abs(strong_g[name].numpy()) > 1e-5
        np.testing.assert_allclose(got[strong], after[name].numpy()[strong], atol=1e-4 * LR,
                                   rtol=0, err_msg=name)


def test_accum_trainer_matches_full_batch(cube_dir, tmp_path):
    losses = {}
    for accum in (1, 2):
        cfg = load_config(None, dict(KW, epoch=2, batch_size=4, fused_pipeline="off",
                                     grad_accum_steps=accum))
        trainer = Trainer(cfg, 6)
        trainer.fit(_store(cube_dir), ckpt_dir=str(tmp_path / f"a{accum}"))
        losses[accum] = trainer.all_epoch_losses
    for k in LOSS_KEYS:
        np.testing.assert_allclose(losses[2][k], losses[1][k], rtol=1e-4, err_msg=k)


def _fresh(cfg):
    return Trainer(cfg, 6)


def test_multistep_equals_single_fused_steps(six_cubes):
    cubes = stack_cubes(_store(six_cubes), "cpu")
    draws = torch.from_numpy(fused_draws(41, 0, 3, 2, (20, 22), 16))
    cfg = load_config(None, KW)
    runs = []
    for chunks in ([[0], [1], [2]], [[0, 1], [2]]):
        trainer = _fresh(cfg)
        sums = []
        for ids in chunks:
            if len(ids) == 1:
                sums.append(fused_train_step(trainer.model, trainer.optimizer, cubes, draws[ids[0]],
                                             ids[0] * 2, 16, COEFFS))
            else:
                sums.append(multistep_train_step(trainer.model, trainer.optimizer, cubes, draws,
                                                 ids, 2, 16, COEFFS))
        runs.append((trainer.model.state_dict(), sums))
    (sd1, single), (sd2, multi) = runs
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
    for k in LOSS_KEYS:
        assert torch.equal(single[0][k] + single[1][k], multi[0][k]), k
        assert torch.equal(single[2][k], multi[1][k]), k


def test_trainer_steps_per_dispatch_with_remainder(six_cubes, tmp_path, capsys):
    results = {}
    for k_steps in (1, 2):
        cfg = load_config(None, dict(KW, epoch=2, steps_per_dispatch=k_steps))
        trainer = _fresh(cfg)
        trainer.fit(_store(six_cubes), ckpt_dir=str(tmp_path / f"k{k_steps}"))
        results[k_steps] = trainer
    assert "Patch sampler: fused on-device pipeline" in capsys.readouterr().out
    sd1, sd2 = (results[k].model.state_dict() for k in (1, 2))
    for name in sd1:
        assert torch.equal(sd1[name], sd2[name]), name
    for k in LOSS_KEYS:
        np.testing.assert_allclose(results[2].all_epoch_losses[k], results[1].all_epoch_losses[k],
                                   rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def fused_run(cube_dir, tmp_path_factory):
    """The fused pipeline's 5-epoch run from the port's own initial weights."""
    cfg = load_config(None, dict(KW, fused_pipeline="on"))
    trainer = _fresh(cfg)
    trainer.fit(_store(cube_dir), ckpt_dir=str(tmp_path_factory.mktemp("golden_ck")))
    return cfg, trainer


def test_fused_golden_trajectory(fused_run):
    _, trainer = fused_run
    losses = trainer.all_epoch_losses
    assert all(len(v) == 5 and np.isfinite(v).all() for v in losses.values())
    np.testing.assert_allclose(losses["total_loss"], GOLDEN_FUSED_TOTAL, rtol=2e-4)


def test_fused_resume_replays_the_uninterrupted_run(fused_run, cube_dir, tmp_path):
    cfg, _ = fused_run
    cfg = dataclasses.replace(cfg, epoch=3)
    straight = _fresh(cfg)
    straight.fit(_store(cube_dir), ckpt_dir=str(tmp_path / "straight"))
    ckpt_dir = str(tmp_path / "resumed")
    first = _fresh(dataclasses.replace(cfg, epoch=2))
    first.fit(_store(cube_dir), ckpt_dir=ckpt_dir)
    resumed = _fresh(dataclasses.replace(cfg, resume=True))
    resumed.fit(_store(cube_dir), ckpt_dir=ckpt_dir)
    for k in LOSS_KEYS:
        assert first.all_epoch_losses[k] + resumed.all_epoch_losses[k] == straight.all_epoch_losses[k]
    sd, want = resumed.model.state_dict(), straight.model.state_dict()
    for name in want:
        assert torch.equal(sd[name], want[name]), name


def test_pipeline_selection(cube_dir, tmp_path, capsys):
    mixed = _cubes_dir(str(tmp_path / "mixed"), [(24, 24, 6), (20, 24, 6)])
    trainer = _fresh(load_config(None, dict(KW, epoch=1)))
    trainer.fit(_store(mixed), ckpt_dir=str(tmp_path / "ck"))
    # Mixed shapes take the host pipeline, whose sampler: auto resolves as
    # JAX's make_sampler does: the native sampler when its library loads.
    assert trainer.pipeline == "host"
    assert ("Patch sampler: NativePatchSampler (sampler='auto', fused_pipeline='auto' -> host "
            "pipeline") in capsys.readouterr().out
    with pytest.raises(ValueError, match="share one shape"):
        _fresh(load_config(None, dict(KW, epoch=1, fused_pipeline="on"))).fit(
            _store(mixed), ckpt_dir=str(tmp_path / "ck2"))


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,k", [(4, 2), (4, 3), (5, 2), (7, 3), (6, 6), (9, 4)])
def test_window_indices_equal_jax(n, k):
    from sshslie_tpu.train import WindowedCubeFeeder as JaxFeeder

    ours, theirs = WindowedCubeFeeder(_Sized(n), k, "cpu"), JaxFeeder(_Sized(n), k, lambda a: a)
    try:
        assert ours.k == theirs.k
        for e in range(11):
            assert ours.indices(e) == theirs.indices(e), e
    finally:
        ours.close()
        theirs.close()


class _FakeJaxDevice:
    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


MB = 24 * 24 * 6 * 4  # one float32 24x24x6 cube


@pytest.mark.parametrize("lazy,mixed,n,batch,stats,want", [
    (False, False, 4, 2, None, 0),                                        # no stats: resident
    (True, False, 4, 2, None, 3),                                         # no stats, lazy: 2*B
    (True, False, 4, 1, None, 2),
    (False, True, 4, 2, {"bytes_limit": 10 * MB, "bytes_in_use": 0}, -1),  # mixed shapes
    (True, False, 2, 2, None, -1),                                        # lazy n <= k_min
    (False, False, 4, 2, {"bytes_limit": 8 * MB, "bytes_in_use": 0}, 0),   # the stack fits
    (True, False, 4, 2, {"bytes_limit": 8 * MB, "bytes_in_use": 0}, 2),    # lazy: windows anyway
    (False, False, 8, 2, {"bytes_limit": 14 * MB, "bytes_in_use": 2 * MB}, 3),  # a window of 3
    (False, False, 4, 2, {"bytes_limit": 9 * MB, "bytes_in_use": 2 * MB}, -1),  # none fits
    (True, False, 6, 2, {"bytes_limit": 100 * MB, "bytes_in_use": 0}, 5),  # capped at N - 1
], ids=["resident", "lazy-2B", "lazy-B1", "mixed", "lazy-small", "fits", "lazy-fits",
        "window", "no-window", "cap"])
def test_auto_fused_window_equals_jax(tmp_path, lazy, mixed, n, batch, stats, want):
    from sshslie_tpu.data.datasets import CubeStore as JaxStore, LazyCubeStore as JaxLazy
    from sshslie_tpu.train import auto_fused_window as jax_auto

    shapes = [(24, 24, 6)] * n if not mixed else [(24, 24, 6), (20, 24, 6)] * (n // 2)
    d = _cubes_dir(str(tmp_path / "c"), shapes)
    ours = (LazyCubeStore if lazy else CubeStore)(d, normalization="self")
    theirs = (JaxLazy if lazy else JaxStore)(d, normalization="self")
    got = auto_fused_window(ours, batch, torch.device("cpu"), memory_stats=lambda dev: stats)
    assert got == jax_auto(theirs, batch, device=_FakeJaxDevice(stats)) == want
    # The CPU has no memory stats: the same as the no-stats case.
    if stats is None:
        assert auto_fused_window(ours, batch, torch.device("cpu")) == got


def _window_cfg(**kw):
    return load_config(None, {**KW, "epoch": 2, "fused_pipeline": "on", **kw})


def test_windowed_run_equals_fused_steps_on_each_window(cube_dir, tmp_path, capsys):
    """Lazy store, window 2 of 4: epoch e trains on cubes {2e, 2e+1} with
    the resident pipeline's draw table, cube index mod 2."""
    cfg = _window_cfg(fused_window=2)
    store = LazyCubeStore(cube_dir, normalization="self", cache_size=2)
    trainer = _fresh(cfg)
    trainer.fit(store, ckpt_dir=str(tmp_path / "w"))
    out = capsys.readouterr().out
    assert "Patch sampler: fused on-device pipeline, windowed (window=2/4 cubes" in out
    assert trainer.pipeline == "fused"
    assert store.load_count == 4  # each cube read once: {0, 1}, then {2, 3}

    ref = _fresh(cfg)
    stack = stack_cubes(_store(cube_dir), "cpu")
    want = {k: [] for k in LOSS_KEYS}
    for epoch, window in enumerate(([0, 1], [2, 3])):
        for group in ref.optimizer.param_groups:
            group["lr"] = ref._lr_for_epoch(epoch)
        draws = torch.from_numpy(fused_draws(41, epoch, 2, 2, (24, 24), 16))
        terms = [fused_train_step(ref.model, ref.optimizer, stack[window], draws[b], b * 2, 16,
                                  ref.coeffs) for b in range(2)]
        for k in LOSS_KEYS:
            want[k].append(float(terms[0][k] + terms[1][k]) / 2)
    for k in LOSS_KEYS:
        assert trainer.all_epoch_losses[k] == want[k], k
    sd, ref_sd = trainer.model.state_dict(), ref.model.state_dict()
    for name in ref_sd:
        assert torch.equal(sd[name], ref_sd[name]), name


def test_windowed_resume_and_multistep(cube_dir, tmp_path):
    """Window 3 of 4 (the windows wrap): 2 epochs then 1 resumed equal 3
    straight epochs, and 2 steps a dispatch equal 1, bit for bit."""
    cfg = _window_cfg(fused_window=3, epoch=3)
    straight = _fresh(cfg)
    straight.fit(_store(cube_dir), ckpt_dir=str(tmp_path / "straight"))
    ckpt_dir = str(tmp_path / "resumed")
    first = _fresh(dataclasses.replace(cfg, epoch=2))
    first.fit(_store(cube_dir), ckpt_dir=ckpt_dir)
    resumed = _fresh(dataclasses.replace(cfg, resume=True))
    resumed.fit(_store(cube_dir), ckpt_dir=ckpt_dir)
    multi = _fresh(dataclasses.replace(cfg, steps_per_dispatch=2))
    multi.fit(_store(cube_dir), ckpt_dir=str(tmp_path / "multi"))
    for k in LOSS_KEYS:
        assert first.all_epoch_losses[k] + resumed.all_epoch_losses[k] == straight.all_epoch_losses[k]
        np.testing.assert_allclose(multi.all_epoch_losses[k], straight.all_epoch_losses[k],
                                   rtol=1e-6, err_msg=k)
    want = straight.model.state_dict()
    for other in (resumed, multi):
        sd = other.model.state_dict()
        for name in want:
            assert torch.equal(sd[name], want[name]), name


def test_window_covering_a_lazy_store_equals_the_resident_run(cube_dir, tmp_path, capsys):
    resident = _fresh(_window_cfg())
    resident.fit(_store(cube_dir), ckpt_dir=str(tmp_path / "r"))
    lazy = _fresh(_window_cfg(fused_window=4))
    lazy.fit(LazyCubeStore(cube_dir, normalization="self"), ckpt_dir=str(tmp_path / "l"))
    assert "windowed" not in capsys.readouterr().out
    for k in LOSS_KEYS:
        assert lazy.all_epoch_losses[k] == resident.all_epoch_losses[k], k
    # On a lazy store the resident stack is never built: fused_pipeline='on'
    # without a window raises JAX's message.
    with pytest.raises(ValueError, match="or fused_window for lazy stores"):
        _fresh(_window_cfg()).fit(LazyCubeStore(cube_dir, normalization="self"),
                                  ckpt_dir=str(tmp_path / "x"))
