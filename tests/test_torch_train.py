"""The port's training path against the JAX package's on the CPU.

* One step at 64 bands (batch 2, 16x16 patches, the shallow conv through the
  ShallowConv Function on its plain passes): the 7 terms, every parameter's
  gradient and the parameters after Adam, against JAX ``make_train_step``
  from the same params and batch; and a frozen step, which leaves the
  DecompositionNet's weights exactly as they were.
* The whole ``Trainer.fit`` trajectory of tests/test_golden_trajectory.py's
  host-pipeline config (6 bands, patch 16, batch 2, four 24x24 cubes, 5
  epochs, ``fused_pipeline: off``, ``sampler: python``, seed 41) from the JAX
  Trainer's initial params: per epoch and per term against the JAX Trainer
  run here, and the total against ``GOLDEN_HOST_TOTAL``.
* Resume: 2 epochs, then 3 more resumed from the final-tail checkpoint,
  equal 5 uninterrupted epochs.
* ``runner.main`` with ``train_and_test`` on the CPU, and the config values
  the port cannot honour, which raise.
* The spans of two fused steps under the profiler: each ``train.step`` with
  its sample, forward, loss, backward and Adam children under its id; the
  terms and the weights after the steps bit for bit those of the same steps
  with no profiler.

Tolerances, stated relative to each quantity's scale:
* terms of one step: rtol 1e-5 (float32 sums over 2*16*16*64 values in
  another order; measured <= 1.8e-6);
* gradients: 1e-4 of each gradient's largest magnitude (the backward of ~40
  float32 layers, with c_loss_i_smooth_delta 2000; measured <= 2.7e-5, on
  the attention's q_linear, whose gradients are ~1e-5 against a largest
  gradient of 44), with a floor of 1e-10 of the largest gradient for
  k_linear's bias, whose exact gradient is zero (measured 5.6e-10 absolute);
* parameters after one Adam step: 1e-4 * lr absolute, against the first-step
  formula p - lr * g / (|g| + eps) on the port's own gradients (measured
  7.5e-6 * lr), and against JAX where |g| > 1000 * eps (measured
  1.5e-5 * lr). Below that the step is made of rounding: 0.65 * lr apart at
  worst on the shallow conv's weights;
* the 5-epoch trajectory: every term within 2e-5 of that epoch's total loss
  of the JAX Trainer (10 Adam steps; measured <= 4.2e-6 of the total; the
  smallest terms, ~1/300 of the total, drift to 6.4e-5 of their own value),
  and the total within rtol 2e-4 of GOLDEN_HOST_TOTAL, the golden test's own
  tolerance (measured 4.3e-6);
* resume: rtol 1e-6 (the same arithmetic on the same CPU; measured 0).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.config import Config as JaxConfig
from sshslie_tpu.data.datasets import CubeStore as JaxCubeStore
from sshslie_tpu.interop import load_torch_checkpoint
from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
from sshslie_tpu.train import (LOSS_KEYS as JAX_LOSS_KEYS, TrainState, Trainer as JaxTrainer,
                               _make_loss_fn, init_params, make_optimizer as jax_make_optimizer,
                               make_train_step)
from sshslie_torch import checkpoints, runner
from sshslie_torch.config import load_config
from sshslie_torch.data.datasets import CubeStore
from sshslie_torch.interop import jax_params_to_state_dict
from sshslie_torch.models.enhance import LowLightEnhanceNet
from sshslie_torch.observability import TRACER
from sshslie_torch.train import (LOSS_KEYS, Trainer, fused_draws, make_optimizer,
                                 multistep_train_step, train_step)
from test_golden_trajectory import GOLDEN_HOST_TOTAL

COEFFS = {
    "c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
    "c_loss_i_smooth_delta": 2000.0, "c_loss_fourier": 20.0, "c_loss_spectral_cons": 1.0,
    "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0,
}
LR = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_one_step():
    """JAX: params, batch, loss terms, grads, params after a step and after a
    frozen step, at 64 bands."""
    jm = JaxNet(input_channels=64)
    params = init_params(jm, 3, 16)
    rng = np.random.default_rng(4)
    batch = (rng.random((2, 16, 16, 64), dtype=np.float32) * 0.4 + 0.05)
    (_, terms), grads = jax.jit(jax.value_and_grad(_make_loss_fn(jm, COEFFS), has_aux=True))(
        params, jnp.asarray(batch))
    host_params = _np_tree(params)
    tx = jax_make_optimizer()
    after = {}
    for freeze in (False, True):
        state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, host_params),
                           opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        new_state, _ = make_train_step(jm, tx, COEFFS, freeze_decom=freeze)(
            state, jnp.asarray(batch), jnp.float32(LR))
        after[freeze] = jax_params_to_state_dict(_np_tree(new_state.params))
    return dict(sd=jax_params_to_state_dict(host_params), batch=batch,
                terms={k: float(v) for k, v in terms.items()},
                grads=jax_params_to_state_dict(_np_tree(grads)), after=after)


@pytest.fixture(scope="module")
def one_step():
    return _jax_one_step()


def _port_model(sd):
    model = LowLightEnhanceNet(64, conv_impl="kernel")   # the shallow conv through ShallowConv
    model.load_state_dict(sd, strict=True)
    return model.train()


def _assert_adam_step_matches(model, one_step, freeze):
    """Parameters after one step against JAX's, where the JAX gradient is
    above 1000 * eps: below that, Adam's first step lr * g / (|g| + eps) is
    made of the gradients' rounding. Everywhere, the port's step is that
    formula on its own gradients."""
    for name, p in model.named_parameters():
        p0, g = one_step["sd"][name].numpy(), p.grad.numpy()
        got = p.detach().numpy()
        np.testing.assert_allclose(got, p0 - LR * g / (np.abs(g) + 1e-8), atol=1e-4 * LR, rtol=0,
                                   err_msg=f"{name}: Adam on the port's gradient")
        strong = np.abs(one_step["grads"][name].numpy()) > 1e-5
        if freeze and name.startswith("decomposition_net."):
            continue
        np.testing.assert_allclose(got[strong], one_step["after"][freeze][name].numpy()[strong],
                                   atol=1e-4 * LR, rtol=0, err_msg=f"{name}: against JAX")


def test_one_step_at_64_bands_matches_jax(one_step):
    model = _port_model(one_step["sd"])
    opt = make_optimizer(model, LR)
    terms = train_step(model, opt, torch.from_numpy(one_step["batch"]), COEFFS)
    assert tuple(terms) == LOSS_KEYS == JAX_LOSS_KEYS
    for k in LOSS_KEYS:
        assert terms[k].requires_grad is False
        np.testing.assert_allclose(float(terms[k]), one_step["terms"][k], rtol=1e-5, err_msg=k)
    named = dict(model.named_parameters())
    assert set(named) == set(one_step["grads"])
    # k_linear's bias has a zero gradient in exact arithmetic (softmax ignores
    # a shift common to all keys): its floor is 1e-10 of the largest gradient.
    floor = 1e-10 * max(float(np.abs(g.numpy()).max()) for g in one_step["grads"].values())
    for name, p in named.items():
        want = one_step["grads"][name].numpy()
        atol = max(1e-4 * float(np.abs(want).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=atol, rtol=0, err_msg=name)
    _assert_adam_step_matches(model, one_step, freeze=False)


def test_frozen_step_keeps_the_decomposition_net(one_step):
    model = _port_model(one_step["sd"])
    train_step(model, make_optimizer(model, LR), torch.from_numpy(one_step["batch"]), COEFFS,
               freeze_decom=True)
    for name, p in model.named_parameters():
        if name.startswith("decomposition_net."):
            np.testing.assert_array_equal(p.detach().numpy(), one_step["sd"][name].numpy())
            np.testing.assert_array_equal(one_step["after"][True][name].numpy(),
                                          one_step["sd"][name].numpy())
            assert not torch.count_nonzero(p.grad)
    _assert_adam_step_matches(model, one_step, freeze=True)


GOLDEN_KW = dict(channels=6, patch_size=16, batch_size=2, epoch=5, eval_every_epoch=100,
                 plot_every_epoch=100, attention_impl="xla", fused_pipeline="off",
                 sampler="python", seed_value=41)


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    import scipy.io as sio

    d = tmp_path_factory.mktemp("golden")
    rng = np.random.RandomState(20260816)
    for i in range(4):
        sio.savemat(str(d / f"c{i}.mat"), {"data": (rng.rand(24, 24, 6) * 100).astype(np.float32)})
    return str(d)


@pytest.fixture(scope="module")
def trajectories(golden_dir, tmp_path_factory):
    """The JAX Trainer's and the port's 5-epoch runs from the same params."""
    jcfg = JaxConfig(**GOLDEN_KW)
    jcfg.finalize()
    jtrainer = JaxTrainer(jcfg, channels=6)
    sd = jax_params_to_state_dict(_np_tree(jtrainer.state.params))
    jtrainer.fit(JaxCubeStore(golden_dir, normalization="self"),
                 ckpt_dir=str(tmp_path_factory.mktemp("jax_ck")))
    cfg = load_config(None, dict(GOLDEN_KW, device="cpu"))
    trainer = Trainer(cfg, 6, state_dict=sd)
    trainer.fit(CubeStore(golden_dir, normalization="self"),
                ckpt_dir=str(tmp_path_factory.mktemp("port_ck")))
    return jtrainer.all_epoch_losses, trainer.all_epoch_losses, sd, cfg


def test_trajectory_matches_jax_trainer_and_golden(trajectories):
    jax_losses, losses, _, _ = trajectories
    scale = 2e-5 * np.asarray(jax_losses["total_loss"])
    for k in LOSS_KEYS:
        assert len(losses[k]) == 5
        np.testing.assert_array_less(np.abs(np.subtract(losses[k], jax_losses[k])), scale, err_msg=k)
    np.testing.assert_allclose(losses["total_loss"], GOLDEN_HOST_TOTAL, rtol=2e-4)


def test_resume_replays_the_uninterrupted_run(trajectories, golden_dir, tmp_path):
    _, losses, sd, cfg = trajectories
    ckpt_dir = str(tmp_path / "ck")
    first = Trainer(dataclasses.replace(cfg, epoch=2), 6, state_dict=sd)
    first.fit(CubeStore(golden_dir, normalization="self"), ckpt_dir=ckpt_dir)
    # Only the final-tail checkpoint (2 % 100 != 0), with the real optimizer state.
    assert sorted(os.listdir(ckpt_dir)) == ["model_epoch_2.pth", "model_epoch_latest.pth"]
    ck = torch.load(checkpoints.latest_path(ckpt_dir), weights_only=True)
    assert ck["epoch"] == 2 and len(ck["optimizer_state_dict"]["state"]) == len(sd)
    resumed = Trainer(dataclasses.replace(cfg, resume=True), 6, state_dict=sd)
    resumed.fit(CubeStore(golden_dir, normalization="self"), ckpt_dir=ckpt_dir)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(first.all_epoch_losses[k] + resumed.all_epoch_losses[k],
                                   losses[k], rtol=1e-6, err_msg=k)


def test_runner_train_and_test_on_cpu(tmp_path, monkeypatch, rng):
    from conftest import make_synthetic_dataset

    monkeypatch.chdir(tmp_path)
    make_synthetic_dataset(str(tmp_path), rng, n_train=4, h=32, w=40, c=12)
    cfg = load_config(None, dict(
        channels=12, global_min=200.0, global_max=3800.0, batch_size=2, patch_size=16, epoch=3,
        eval_every_epoch=2, phase="train_and_test", train_data="./data/low/train",
        eval_data="./data/low/test", test_data="./data/low/test", label_dir="./data/high/test",
        model_name="run", device="cpu", checkpoint_keep=1))
    result = runner.main(cfg)
    trainer = result["trainer"]
    assert all(len(v) == 3 and np.isfinite(v).all() for v in trainer.all_epoch_losses.values())
    assert set(trainer.eval_metrics) == {2}
    assert all(np.isfinite(v) for v in trainer.eval_metrics[2].values())
    assert os.path.exists(os.path.join(cfg.eval_result_dir, "epoch_2", "t0.mat"))
    # Epoch 2 on the eval cadence, epoch 3 as the final tail; checkpoint_keep 1 pruned epoch 2.
    # The run's model summary lies beside them, as in the JAX package.
    assert sorted(os.listdir(cfg.test_model_dir)) == ["model_epoch_3.pth", "model_epoch_latest.pth",
                                                      "model_summary.txt"]
    assert np.isfinite(result["scores"]).all()
    assert os.path.exists(os.path.join(cfg.test_result_dir, "t0.mat"))
    params, epoch = load_torch_checkpoint(checkpoints.latest_path(cfg.test_model_dir))
    assert epoch == 3
    got = jax_params_to_state_dict(_np_tree(params))
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())


@pytest.mark.parametrize("key,value", [("mesh_shape", "2x2"), ("space_axis", "space")])
def test_values_the_port_cannot_honour_raise(golden_dir, tmp_path, monkeypatch, key, value):
    """The space axis's values, which raised until the space axis was
    ported, run. A 2-D mesh asks for its D·S processes (one process is a 1x1
    mesh, whose height split of one runs no collective and trains as no mesh
    does, within float32 rounding: its convs see the zero rows as a halo);
    ``space_axis`` without a mesh is ignored, as in JAX."""
    from sshslie_torch.parallel.mesh import make_mesh

    monkeypatch.chdir(tmp_path)
    cfg = load_config(None, {"phase": "train", "device": "cpu", "channels": 6, key: value})
    mesh, kw = None, {key: value}
    if key == "mesh_shape":
        with pytest.raises(ValueError, match=r"mesh shape \(2, 2\) needs 4 devices, have 1"):
            runner.main(cfg)
        mesh, kw = make_mesh("1x1"), {"mesh_shape": "1x1", "space_axis": "space"}
    store = CubeStore(golden_dir, normalization="self")
    runs = []
    for m, extra in ((mesh, kw), (None, {})):
        trainer = Trainer(load_config(None, dict(GOLDEN_KW, device="cpu", epoch=1, **extra)), 6,
                          mesh=m)
        trainer.fit(store, ckpt_dir=str(tmp_path / f"run{len(runs)}"))
        runs.append(trainer.all_epoch_losses)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(runs[0][k], runs[1][k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("key,value,pipeline,line", [
    ("fused_window", 2, "fused", "fused on-device pipeline, windowed (window=2/4"),
    ("fused_window", "auto", "fused", "fused_window=auto: full training stack fits resident"),
    ("lazy_loading", True, "host", "Patch sampler: PatchSampler (sampler='auto'"),
    ("fused_window", 3, "fused", "fused on-device pipeline, windowed (window=3/4"),
])
def test_disk_and_window_values_build_and_train(golden_dir, tmp_path, capsys, key, value,
                                                pipeline, line):
    """The values that raised until the disk-backed data path was ported
    build a Trainer and train a step on the CPU (batch 4 of 4 cubes: one
    step an epoch; a lazy store without a window takes the host sampler)."""
    from sshslie_torch.data.datasets import store_from_config

    cfg = load_config(None, dict(GOLDEN_KW, device="cpu", batch_size=4, epoch=1, sampler="auto",
                                 fused_pipeline="auto", normalization="self", **{key: value}))
    trainer = Trainer(cfg, 6)
    trainer.fit(store_from_config(cfg, golden_dir), ckpt_dir=str(tmp_path))
    assert line in capsys.readouterr().out
    assert trainer.pipeline == pipeline
    assert all(len(v) == 1 and np.isfinite(v).all() for v in trainer.all_epoch_losses.values())


@pytest.mark.parametrize("key,value", [
    ("fused_pipeline", "on"), ("grad_accum_steps", 2), ("steps_per_dispatch", 2),
    ("remat", True), ("precision", "bfloat16"), ("matmul_precision", "tensorfloat32"),
    ("matmul_precision", "bfloat16"),
])
def test_pipeline_precision_and_remat_values_build_a_trainer(key, value):
    """The on-device pipelines, accumulation, remat, bfloat16 and matmuls below
    full float32 (TF32 on the card) no longer raise."""
    cfg = load_config(None, {"phase": "train", "device": "cpu", "channels": 6, key: value})
    trainer = Trainer(cfg, 6)
    assert getattr(trainer.cfg, key) == value
    assert trainer.model.remat == cfg.remat


def test_fused_window_is_ignored_where_jax_ignores_it():
    """JAX acts on fused_window only on the fused pipeline: with the host
    pipeline asked for, or with accumulation, it builds."""
    for extra in ({"fused_pipeline": "off"}, {"grad_accum_steps": 2}):
        Trainer(load_config(None, {"device": "cpu", "channels": 6, "fused_window": 2, **extra}), 6)


def test_fused_pipeline_on_with_accumulation_raises(golden_dir, tmp_path):
    """As JAX: accumulation needs the host pipeline, so 'on' with K > 1 is a ValueError."""
    cfg = load_config(None, dict(GOLDEN_KW, device="cpu", fused_pipeline="on", grad_accum_steps=2))
    with pytest.raises(ValueError, match="requires the host pipeline"):
        Trainer(cfg, 6).fit(CubeStore(golden_dir, normalization="self"), ckpt_dir=str(tmp_path))


def test_fused_steps_record_their_spans_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    cubes = torch.rand(3, 20, 22, 6, generator=torch.Generator().manual_seed(3))
    draws = torch.from_numpy(fused_draws(41, 0, 2, 2, (20, 22), 16))
    sd = LowLightEnhanceNet(6, attention_impl="dense",
                            generator=torch.Generator().manual_seed(41)).state_dict()

    def run():
        model = LowLightEnhanceNet(6, attention_impl="dense")
        model.load_state_dict(sd)
        opt = make_optimizer(model.train(), LR)
        terms = multistep_train_step(model, opt, cubes, draws, [0, 1], 2, 16, COEFFS)
        return terms, model.state_dict()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # tiny steps, not the pool's contention with other workers
    try:
        plain_terms, plain_sd = run()
        TRACER.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            terms, after = run()
    finally:
        torch.set_num_threads(threads)
    spans, summary = TRACER.spans(), TRACER.summary()
    TRACER.reset()
    for k in LOSS_KEYS:
        assert torch.equal(terms[k], plain_terms[k]), k
    for k in plain_sd:
        assert torch.equal(after[k], plain_sd[k]), k
    steps = [r for r in spans if r.name == "train.step"]
    assert len(steps) == 2 and all(r.parent is None for r in steps)
    for step in steps:
        children = [r.name for r in spans if r.parent == step.id]
        assert sorted(children) == ["train.adam", "train.adam", "train.backward",
                                    "train.forward", "train.loss", "train.sample"]
        assert all(r.root == step.id for r in spans
                   if step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns)
    assert summary["train.step"]["count"] == 2 and summary["train.adam"]["count"] == 4
