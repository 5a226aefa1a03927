"""Data parallelism and band-sharded inference of the port on a two-rank gloo
group, against the JAX package's 2-device data mesh on the CPU.

One group of two processes (this file run as a script: it imports only
``sshslie_torch``) runs every case once and writes one ``.npz`` a rank; a
``torchrun`` launch of ``python -m sshslie_torch`` runs beside it. Each test
compares one case with the JAX package in the pytest process, where jax is
imported inside the test functions. Sizes: 4 bands, 16x16 patches, a global
batch of 4 (2 a rank), 24x24 training cubes, a 32x32 test cube.

* The dp step, the accumulating step (K = 2), the frozen step, the remat
  step and a fused step (the port's own draws, the global batch cropped on
  one process for JAX) against JAX ``make_train_step`` /
  ``make_accum_train_step`` on ``make_mesh("2")`` from the same weights and
  global batch: the terms within rtol 1e-5 (float32 means over ranks against
  one mean; measured <= 7e-7), the weights after Adam within JAX's own
  1-device-vs-mesh margin (rtol 1e-4, atol 2e-5) where the rank's reduced
  gradient is above 1000 * eps (below, Adam's first step is made of
  rounding), and everywhere the first-step formula on the port's own
  gradients (1e-4 * lr); the frozen step leaves the DecompositionNet as it
  was; the two ranks' terms and weights are equal bit for bit.
* The Prefetcher's ``process_slice``: the ranks' slices concatenated are the
  global batches bit for bit.
* ``Trainer.fit`` on the host pipeline, 2 epochs: the ranks' epoch losses
  equal each other exactly and a one-process run of the same global batches
  within rtol 1e-5; resumed to epoch 3 on two ranks and, from the same
  2-rank epoch-2 checkpoint, on one process: epoch 3 within rtol 1e-5, the
  weights within rtol 1e-4, atol 2e-5; a SIGTERM on rank 1 stops both
  ranks after the same epoch.
* ``BandShardedInferencer``: R, I_delta and S within 1e-5 of their span of
  the one-device forward and of JAX's ``BandShardedInferencer`` (float32
  partial sums in another order); uneven channels raise; ``evaluate_model``
  with ``eval_sharded`` and ``eval_shard_mode: band`` writes on rank 0 only,
  what the one-device eval writes (JAX's test's tolerance).
* ``parse_mesh_shape``, ``make_mesh``'s and ``shard_batch_size``'s errors as
  JAX's, a 2-D mesh's size and coordinates, ``initialize_distributed``'s rules.
* ``torchrun --nproc_per_node 2 -m sshslie_torch --mesh_shape 2 --device cpu``
  ``train_and_test`` with the band-sharded test phase.
"""

import dataclasses
import os
import shutil
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS, PATCH, BATCH, LR = 4, 16, 4, 1e-3
COEFFS = {
    "c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
    "c_loss_i_smooth_delta": 2000.0, "c_loss_fourier": 20.0, "c_loss_spectral_cons": 1.0,
    "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0,
}
FIT = dict(channels=CHANNELS, patch_size=PATCH, batch_size=BATCH, epoch=2, eval_every_epoch=2,
           plot_every_epoch=100, fused_pipeline="off", sampler="python", attention_impl="dense",
           seed_value=41, device="cpu", checkpoint_async=False)
STEP_CASES = ("step", "accum", "freeze", "remat", "fused")
GROUP_TIMEOUT = 240


# ---- the worker: one rank of the group (run as a script; no JAX) ----

def _worker(rank: int, port: int, out: str) -> None:
    sys.path.insert(0, ROOT)
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore, Prefetcher
    from sshslie_torch.evaluate import BandShardedInferencer, _make_inferencer, evaluate_model
    from sshslie_torch.models.enhance import LowLightEnhanceNet
    from sshslie_torch.parallel import distributed
    from sshslie_torch.parallel.mesh import make_mesh
    from sshslie_torch.train import (LOSS_KEYS, Trainer, accum_train_step, fused_train_step,
                                     make_optimizer, train_step)

    torch.set_num_threads(2)
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    sd = torch.load(os.path.join(out, "sd.pt"), weights_only=True)
    distributed.initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                                       world_size=2, rank=rank)
    mesh = make_mesh("2")
    res = {"rank": np.array(mesh.rank)}
    try:
        make_mesh("4")
    except ValueError as e:
        res["mesh_error"] = np.array(str(e))
    rows = distributed.process_batch_slice(BATCH)
    batch = torch.from_numpy(inputs["batch"])

    def model_of(**kw):
        m = LowLightEnhanceNet(CHANNELS, attention_impl="dense", **kw)
        m.load_state_dict(sd)
        return m.train()

    for case in STEP_CASES:
        model = model_of(remat=case == "remat")
        opt = make_optimizer(model, LR)
        if case == "accum":
            terms = accum_train_step(model, opt, batch[rows], COEFFS, 2, mesh=mesh)
        elif case == "fused":
            terms = fused_train_step(model, opt, torch.from_numpy(inputs["cubes"]),
                                     torch.from_numpy(inputs["draws"]), 0, PATCH, COEFFS,
                                     mesh=mesh)
        else:
            terms = train_step(model, opt, batch[rows], COEFFS, freeze_decom=case == "freeze",
                               mesh=mesh)
        res[f"{case}/terms"] = np.array([float(terms[k]) for k in LOSS_KEYS])
        for n, p in model.named_parameters():
            res[f"{case}/p/{n}"] = p.detach().numpy().copy()
            res[f"{case}/g/{n}"] = p.grad.numpy().copy()

    batches = [inputs["batch"] * (i + 1) for i in range(3)]
    with Prefetcher(iter(batches), process_slice=rows) as staged:
        res["prefetch"] = np.stack([b.numpy() for b in staged])

    store = CubeStore(os.path.join(out, "train"), normalization="self")

    def fit(ckpt, **kw):
        cfg = load_config(None, {**FIT, "mesh_shape": "2", **kw})
        trainer = Trainer(cfg, CHANNELS, state_dict=sd, mesh=mesh)
        trainer.fit(store, ckpt_dir=os.path.join(out, ckpt))
        return trainer

    trainer = fit("fit")
    res["fit/losses"] = np.array([trainer.all_epoch_losses[k] for k in LOSS_KEYS])
    trainer = fit("fit", epoch=3, resume=True)
    res["resume/losses"] = np.array([trainer.all_epoch_losses[k] for k in LOSS_KEYS])
    for n, p in trainer.model.named_parameters():
        res[f"resume/p/{n}"] = p.detach().numpy().copy()

    # SIGTERM on rank 1 after its first epoch: both ranks stop after it.
    cfg = load_config(None, {**FIT, "mesh_shape": "2", "epoch": 3})
    trainer = Trainer(cfg, CHANNELS, state_dict=sd, mesh=mesh)
    train_epoch = trainer._train_epoch

    def signalled_epoch(*args):
        out_ = train_epoch(*args)
        if rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out_

    trainer._train_epoch = signalled_epoch
    trainer.fit(store, ckpt_dir=os.path.join(out, "stop"))
    res["stop/epochs"] = np.array(len(trainer.all_epoch_losses["total_loss"]))

    model = model_of().eval()
    R, I, Id, S = BandShardedInferencer(model, mesh)(None, inputs["cube"])
    for name, t in (("R", R), ("I", I), ("Id", Id), ("S", S)):
        res[f"band/{name}"] = t.numpy()

    band_cfg = load_config(None, {**FIT, "mesh_shape": "2", "eval_sharded": True,
                                  "eval_shard_mode": "band", "global_min": 0.0,
                                  "global_max": 4095.0})
    band = Trainer(band_cfg, CHANNELS, state_dict=sd, mesh=mesh)
    res["eval/kinds"] = np.array([
        type(_make_inferencer(band.model, band_cfg, mesh)).__name__,
        type(_make_inferencer(band.model, dataclasses.replace(band_cfg, eval_sharded=False),
                              mesh)).__name__])
    scores = evaluate_model(band, CubeStore(os.path.join(out, "eval"), normalization="self"),
                            os.path.join(out, "eval_out"), 1, None)
    res["eval/none"] = np.array(scores is None)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    distributed.leave()


# ---- the pytest side ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_cubes(d, n, shape, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        sio.savemat(os.path.join(d, f"c{i}.mat"),
                    {"data": (rng.rand(*shape) * 3000 + 200).astype(np.float32)})


def _jax_params():
    import jax

    from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
    from sshslie_tpu.train import init_params

    return jax.tree_util.tree_map(np.asarray, init_params(JaxNet(input_channels=CHANNELS), 3,
                                                          PATCH))


class _Group:
    """The launched group and torchrun run; their results once they end."""

    def __init__(self, out, procs, cli):
        self.out, self.procs, self.cli = out, procs, cli
        self._ranks = None

    def ranks(self):
        if self._ranks is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0])
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._ranks = [dict(np.load(os.path.join(self.out, f"rank{r}.npz"))) for r in range(2)]
        return self._ranks

    def cli_result(self):
        try:
            log = self.cli.communicate(timeout=GROUP_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            self.cli.kill()
            log = self.cli.communicate()[0]
        return self.cli.returncode, log


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Inputs written, the two-rank group and the torchrun run started."""
    from sshslie_torch.interop import jax_params_to_state_dict
    from sshslie_torch.train import fused_draws

    out = str(tmp_path_factory.mktemp("group"))
    try:
        ports = (_free_port(), _free_port())
    except OSError as e:  # pragma: no cover - a sandbox without sockets
        pytest.skip(f"cannot allocate a local port: {e}")
    params = _jax_params()
    torch.save(jax_params_to_state_dict(params), os.path.join(out, "sd.pt"))
    rng = np.random.default_rng(7)
    cubes = rng.random((4, 24, 24, CHANNELS), dtype=np.float32) * 0.5 + 0.05
    np.savez(os.path.join(out, "inputs.npz"),
             batch=rng.random((BATCH, PATCH, PATCH, CHANNELS), dtype=np.float32) * 0.4 + 0.05,
             cubes=cubes, draws=fused_draws(5, 0, 1, BATCH, (24, 24), PATCH)[0],
             cube=rng.random((32, 32, CHANNELS), dtype=np.float32) * 0.5 + 0.05)
    _write_cubes(os.path.join(out, "train"), 8, (24, 24, CHANNELS), 11)
    _write_cubes(os.path.join(out, "eval"), 1, (32, 32, CHANNELS), 12)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(ports[0]),
                               out], cwd=out, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    cli_dir = os.path.join(out, "cli")
    for sub in ("train", "test", "label"):
        _write_cubes(os.path.join(cli_dir, sub), 2, (24, 24, CHANNELS), 13)
    argv = ["--config", "", "--device", "cpu", "--mesh_shape", "2", "--phase", "train_and_test",
            "--model_name", "dp", "--channels", str(CHANNELS), "--batch_size", "2",
            "--patch_size", str(PATCH), "--epoch", "1", "--eval_every_epoch", "1",
            "--attention_impl", "dense", "--global_min", "200", "--global_max", "3200",
            "--train_data", "train", "--eval_data", "test", "--test_data", "test",
            "--label_dir", "label", "--eval_sharded", "true", "--eval_shard_mode", "band"]
    cli = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                            "--master_addr", "127.0.0.1", "--master_port", str(ports[1]),
                            "-m", "sshslie_torch", *argv],
                           cwd=cli_dir, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    g = _Group(out, procs, cli)
    g.params = params
    g.inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    g.sd = torch.load(os.path.join(out, "sd.pt"), weights_only=True)
    yield g
    for p in procs + [cli]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _jax_mesh_step(case, params, batch):
    """JAX's step of ``case`` on a 2-device data mesh → (terms, new params)."""
    import jax
    import jax.numpy as jnp

    from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
    from sshslie_tpu.parallel.mesh import batch_sharding, make_mesh, replicated_sharding
    from sshslie_tpu.train import TrainState, make_accum_train_step, make_optimizer, make_train_step
    from sshslie_torch.interop import jax_params_to_state_dict

    model = JaxNet(input_channels=CHANNELS, remat=case == "remat")
    tx = make_optimizer()
    mesh = make_mesh("2")
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax.device_put(TrainState(params=p, opt_state=tx.init(p),
                                      step=jnp.zeros((), jnp.int32)), replicated_sharding(mesh))
    if case == "accum":
        step = make_accum_train_step(model, tx, COEFFS, 2, mesh=mesh)
    else:
        step = make_train_step(model, tx, COEFFS, freeze_decom=case == "freeze", mesh=mesh)
    state, terms = step(state, jax.device_put(jnp.asarray(batch), batch_sharding(mesh)),
                        jnp.float32(LR))
    after = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    return {k: float(v) for k, v in terms.items()}, after


@pytest.mark.parametrize("case", STEP_CASES)
def test_dp_step_matches_jax_mesh(group, case):
    from sshslie_torch.train import LOSS_KEYS, sample_fused_batch

    batch = group.inputs["batch"]
    if case == "fused":
        batch = sample_fused_batch(torch.from_numpy(group.inputs["cubes"]),
                                   torch.from_numpy(group.inputs["draws"]), 0, PATCH).numpy()
    want_terms, want = _jax_mesh_step(case, group.params, batch)
    r0, r1 = group.ranks()
    np.testing.assert_array_equal(r0[f"{case}/terms"], r1[f"{case}/terms"])
    np.testing.assert_allclose(r0[f"{case}/terms"], [want_terms[k] for k in LOSS_KEYS], rtol=1e-5)
    for name, p0 in group.sd.items():
        got, g = r0[f"{case}/p/{name}"], r0[f"{case}/g/{name}"]
        np.testing.assert_array_equal(got, r1[f"{case}/p/{name}"], err_msg=name)
        p0 = p0.numpy()
        np.testing.assert_allclose(got, p0 - LR * g / (np.abs(g) + 1e-8), rtol=0, atol=1e-4 * LR,
                                   err_msg=f"{name}: Adam on the port's gradient")
        strong = np.abs(g) > 1e-5
        np.testing.assert_allclose(got[strong], want[name].numpy()[strong], rtol=1e-4, atol=2e-5,
                                   err_msg=f"{name}: against JAX's mesh step")
        if case == "freeze" and name.startswith("decomposition_net."):
            np.testing.assert_array_equal(got, p0, err_msg=name)


def test_prefetcher_process_slice_rebuilds_the_global_batch(group):
    r0, r1 = group.ranks()
    want = np.stack([group.inputs["batch"] * (i + 1) for i in range(3)])
    np.testing.assert_array_equal(np.concatenate([r0["prefetch"], r1["prefetch"]], axis=1), want)


def _one_process_fit(group, ckpt_dir, **kw):
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore
    from sshslie_torch.train import Trainer

    cfg = load_config(None, {**FIT, **kw})
    trainer = Trainer(cfg, CHANNELS, state_dict=group.sd)
    trainer.fit(CubeStore(os.path.join(group.out, "train"), normalization="self"),
                ckpt_dir=ckpt_dir)
    return trainer


def test_fit_two_ranks_equal_one_process(group, tmp_path):
    from sshslie_torch.train import LOSS_KEYS

    r0, r1 = group.ranks()
    np.testing.assert_array_equal(r0["fit/losses"], r1["fit/losses"])
    one = _one_process_fit(group, str(tmp_path))
    np.testing.assert_allclose(r0["fit/losses"], [one.all_epoch_losses[k] for k in LOSS_KEYS],
                               rtol=1e-5)
    # The SIGTERM on rank 1 stopped both ranks after epoch 1; rank 0 wrote latest there.
    assert int(r0["stop/epochs"]) == int(r1["stop/epochs"]) == 1
    ck = torch.load(os.path.join(group.out, "stop", "model_epoch_latest.pth"), weights_only=True)
    assert ck["epoch"] == 1


def test_elastic_resume_two_ranks_to_one(group, tmp_path):
    from sshslie_torch.train import LOSS_KEYS

    r0, _ = group.ranks()
    # The 2-rank run's epoch-2 checkpoint, resumed on one process to epoch 3.
    shutil.copy(os.path.join(group.out, "fit", "model_epoch_2.pth"),
                str(tmp_path / "model_epoch_latest.pth"))
    one = _one_process_fit(group, str(tmp_path), epoch=3, resume=True)
    assert len(one.all_epoch_losses["total_loss"]) == 1
    np.testing.assert_allclose([one.all_epoch_losses[k][0] for k in LOSS_KEYS],
                               r0["resume/losses"][:, -1], rtol=1e-5)
    for n, p in one.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), r0[f"resume/p/{n}"], rtol=1e-4, atol=2e-5,
                                   err_msg=n)


def test_band_sharded_matches_one_device_and_jax(group):
    import jax

    from sshslie_tpu.evaluate import BandShardedInferencer as JaxBand
    from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
    from sshslie_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from sshslie_torch.evaluate import Inferencer
    from sshslie_torch.models.enhance import LowLightEnhanceNet

    cube = group.inputs["cube"]
    model = LowLightEnhanceNet(CHANNELS, attention_impl="dense")
    model.load_state_dict(group.sd)
    one = [t.numpy() for t in Inferencer(model.eval())(None, cube)]
    jax_out = [np.asarray(t) for t in JaxBand(JaxNet(input_channels=CHANNELS),
                                              jax_make_mesh("2"))(
        jax.tree_util.tree_map(np.asarray, group.params), cube)]
    r0, r1 = group.ranks()
    for i, name in enumerate(("R", "I", "Id", "S")):
        got = r0[f"band/{name}"]
        np.testing.assert_array_equal(got, r1[f"band/{name}"])
        for what, want in (("one device", one[i]), ("JAX", jax_out[i])):
            span = float(want.max() - want.min())
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * span,
                                       err_msg=f"{name} against {what}")


def test_band_sharded_rejects_uneven_channels():
    from sshslie_torch.evaluate import BandShardedInferencer
    from sshslie_torch.models.enhance import LowLightEnhanceNet
    from sshslie_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="divisible"):
        BandShardedInferencer(LowLightEnhanceNet(3), Mesh(("data",), (2,), 0, "gloo"))


def test_evaluate_model_band_sharded_optin(group, tmp_path):
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore
    from sshslie_torch.evaluate import evaluate_model
    from sshslie_torch.train import Trainer

    r0, r1 = group.ranks()
    assert list(r0["eval/kinds"]) == ["BandShardedInferencer", "Inferencer"]
    assert bool(r0["eval/none"]) and bool(r1["eval/none"])
    assert os.listdir(os.path.join(group.out, "eval_out")) == ["epoch_1"]
    cfg = load_config(None, {**FIT, "global_min": 0.0, "global_max": 4095.0})
    single = Trainer(cfg, CHANNELS, state_dict=group.sd)
    evaluate_model(single, CubeStore(os.path.join(group.out, "eval"), normalization="self"),
                   str(tmp_path), 1, None)
    a = sio.loadmat(str(tmp_path / "epoch_1" / "c0.mat"))["data"]
    b = sio.loadmat(os.path.join(group.out, "eval_out", "epoch_1", "c0.mat"))["data"]
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-3)


def test_mesh_shapes_and_errors_as_jax(monkeypatch):
    from sshslie_tpu.parallel import mesh as jax_mesh
    from sshslie_torch.parallel import distributed
    from sshslie_torch.parallel import mesh

    for spec in ("4", "4x2"):
        assert mesh.parse_mesh_shape(spec) == jax_mesh.parse_mesh_shape(spec)
    assert mesh.parse_mesh_shape("") == (1,)
    one = mesh.make_mesh("1")
    assert (one.shape, one.rank, one.size) == ({"data": 1}, 0, 1)
    assert mesh.make_mesh("").shape == {"data": 1}

    def message(fn, *args, **kw):
        with pytest.raises(ValueError) as e:
            fn(*args, **kw)
        return str(e.value)

    assert message(mesh.make_mesh, "2").startswith("mesh shape (2,) needs 2 devices, have 1")
    assert (message(mesh.make_mesh, "2x2x2")
            == message(jax_mesh.make_mesh, "2x2x2"))
    assert (message(mesh.make_mesh, "2", axis_names=("a", "b"))
            == message(jax_mesh.make_mesh, "2", axis_names=("a", "b")))
    # A 2-D mesh (data x space) takes its D*S processes; one process is a 1x1 mesh.
    assert message(mesh.make_mesh, "2x2").startswith("mesh shape (2, 2) needs 4 devices, have 1")
    flat = mesh.make_mesh("1x1")
    assert (flat.shape, flat.coords, flat.data_size, flat.data_index) == (
        {"data": 1, "space": 1}, (0, 0), 1, 0)
    assert flat.shard("space").rows(8) == slice(0, 8)
    assert mesh.Mesh(("data", "space"), (2, 3), 4, "gloo").coords == (1, 1)
    two = mesh.Mesh(("data",), (2,), 0, "gloo")
    assert mesh.shard_batch_size(4, two) == jax_mesh.shard_batch_size(4, jax_mesh.make_mesh("2"))
    assert (message(mesh.shard_batch_size, 5, two)
            == message(jax_mesh.shard_batch_size, 5, jax_mesh.make_mesh("2")))
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    assert (message(distributed.process_batch_slice, 5)
            == "global batch 5 not divisible by 2 processes")


def test_group_mesh_and_ranks(group):
    r0, r1 = group.ranks()
    assert (int(r0["rank"]), int(r1["rank"])) == (0, 1)
    assert str(r0["mesh_error"]).startswith("mesh shape (4,) needs 4 devices, have 2")


def test_initialize_distributed_rules(monkeypatch):
    from sshslie_torch.parallel import distributed

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_distributed(device="cpu") is False
    assert not distributed.active()
    # A launcher's environment that cannot form the group raises; the
    # process never carries on alone.
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="launcher's environment is present"):
        distributed.initialize_distributed(device="cpu")
    assert not distributed.active()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA card"):
        distributed.initialize_distributed()


@pytest.mark.parametrize("keys,serves", [
    ({"mesh_shape": "2", "eval_sharded": True, "eval_shard_mode": "band"}, False),
    ({"mesh_shape": "2"}, False),
    ({"mesh_shape": "2", "eval_sharded": True}, False),
    ({"mesh_shape": "2", "phase": "serve"}, True),
    ({"device": "cuda:1"}, False),
    ({"mesh_shape": "2x2", "space_axis": "space"}, False),
    ({"mesh_shape": "2x2", "space_axis": "space", "phase": "serve"}, True),
], ids=["band", "dp", "spatial", "serve", "cuda-index", "dp-sp", "serve-dp-sp"])
def test_config_takes_the_data_axis_only(keys, serves, tmp_path, monkeypatch):
    """Every mesh value is taken, serving on a mesh too (the name is from when
    only the data axis was): each config loads with its values, and the
    runner hands a serve phase's mesh to the server."""
    from sshslie_torch import runner, serve
    from sshslie_torch.config import load_config
    from sshslie_torch.parallel.mesh import Mesh, parse_mesh_shape

    cfg = load_config(None, {**keys, "channels": CHANNELS})
    assert {k: getattr(cfg, k) for k in keys} == keys
    if not serves:
        return
    sizes = parse_mesh_shape(cfg.mesh_shape)
    mesh = Mesh(("data", "space")[:len(sizes)], sizes, 0, "gloo")
    got = []
    monkeypatch.setattr(serve, "serve_from_config", lambda c, mesh=None: got.append(mesh))
    monkeypatch.chdir(tmp_path)
    assert runner._run(cfg, torch.device("cpu"), mesh) == {}
    assert got == [mesh]


def test_torchrun_train_and_test_two_ranks(group):
    from glob import glob

    rc, log = group.cli_result()
    assert rc == 0, log[-4000:]
    cli = os.path.join(group.out, "cli")
    [ckpt] = glob(os.path.join(cli, "checkpoint", "dp", "Decomposition_*"))
    assert {"model_epoch_1.pth", "model_epoch_latest.pth"} <= set(os.listdir(ckpt))
    logs = sorted(glob(os.path.join(cli, "logs", "console_output_dp_*.log")))
    assert len(logs) == 2 and logs[1].endswith("_rank1.log"), logs
    text = open(logs[0]).read()
    assert "Mesh: Mesh('data': 2; rank 0, backend gloo)" in text
    assert "===> Avg.PSNR" in text
    assert "Mesh: Mesh('data': 2; rank 1, backend gloo)" in open(logs[1]).read()
    [results] = glob(os.path.join(cli, "results", "test_results_dp_*"))
    S = sio.loadmat(os.path.join(results, "c0.mat"))["data"]
    assert S.shape == (24, 24, CHANNELS) and np.isfinite(S).all()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
