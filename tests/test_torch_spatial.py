"""The space axis of the port (dp×sp training, the height-sharded
``ShardedInferencer``) on gloo groups, against the JAX package's ``data x
space`` meshes on the CPU.

Two groups run at once, each rank this file run as a script (it imports only
``sshslie_torch``) writing one ``.npz``: two ranks on a ``1x2`` mesh (and the
1-D mesh "2" of the same ranks), four on ``2x2`` (and "4"). The pytest
process compares each case with the JAX package, importing jax inside the
test functions. Sizes: 4 bands, 32x32 patches, a global batch of 2, cubes of
at most 48x48.

* Each sharded layer (3x3 stride 1, the 9x9 shallow conv on ``impl:
  kernel``, which on the CPU is its plain version, 3x3 stride 2, the
  transposed conv, ``TransformerBlock``, ``SEBlock``) and each primitive
  (``halo_rows``, ``gather_rows``, ``gather_rows_replicated``,
  ``space_mean``) on two ranks against the whole layer from seeded numpy
  inputs: forward, input and weight gradients within 1e-6 of each one's
  span (a weight gradient's floored at 1e-6 of the layer's largest span).
* The dp×sp steps from the same weights and global batch against JAX
  ``make_train_step(mesh=make_mesh(shape), space_axis="space")``: ``2x2``,
  and on ``1x2`` the plain, accumulating (JAX ``make_accum_train_step``),
  remat (JAX's plain step: remat changes no value) and fused (the port's
  draws, the global batch cropped on one process for JAX) steps. The terms
  within rtol 1e-5; the weights after Adam within JAX's own dp×sp margin
  (rtol 1e-4, atol 5e-5, ``tests/test_parallel.py``) where the reduced
  gradient is above 1e-5 (below, Adam's first step is made of rounding), and
  everywhere the first-step formula on the port's own gradients; the ranks'
  terms and weights equal bit for bit.
* ``ShardedInferencer`` on 2 ranks (an aligned cube; an unaligned height,
  held against a one-device forward with the same ``pad_multiple``, as JAX's
  test holds it) and on 4 ranks (a rank's H/8 share is one row) against
  JAX's ``ShardedInferencer`` and the port's one-device forward, within
  5e-5 (``tests/test_sharded_inference.py``); ``evaluate_model`` with
  ``eval_sharded`` and the default mode writes on rank 0 only, what the
  one-device eval writes.
* ``runner.main`` ``train_and_test`` on the ``2x2`` group with ``space_axis``
  and the height-sharded evals and test: epoch 1 (one step from the same
  weights) within rtol 1e-5 of a one-process run, the test S within 5e-5.
* The limits: a patch JAX takes but the port cannot split (40 on 2 ranks)
  raises naming its restriction, one that 2 does not divide raises JAX's
  error; serving on a mesh still raises naming item 7.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS, PATCH, BATCH, LR = 4, 32, 2, 1e-3
COEFFS = {
    "c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
    "c_loss_i_smooth_delta": 2000.0, "c_loss_fourier": 20.0, "c_loss_spectral_cons": 1.0,
    "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0,
}
# (name, in channels, input NCHW shape): each layer's seeded weights and inputs.
LAYERS = (("conv3", 8, (2, 8, 16, 12)), ("conv9_kernel", 64, (1, 64, 16, 8)),
          ("conv3_stride2", 8, (2, 8, 16, 12)), ("deconv", 8, (2, 8, 8, 6)),
          ("transformer", 8, (2, 8, 4, 6)), ("se", 16, (2, 16, 8, 6)))
PRIMITIVES = ("halo_rows", "gather_rows", "gather_rows_replicated", "space_mean")
HALO = (2, 1)                        # halo_rows' (up, down) in the primitive case
STEPS = ("2x2/step", "1x2/step", "1x2/accum", "1x2/remat", "1x2/fused")
CUBES = {"aligned": (32, 48), "unaligned": (36, 32), "n4": (32, 32)}
FIT = dict(channels=CHANNELS, patch_size=PATCH, batch_size=BATCH, epoch=1, eval_every_epoch=1,
           plot_every_epoch=100, attention_impl="dense", seed_value=41, device="cpu",
           checkpoint_async=False, global_min=200.0, global_max=3200.0)
GROUP_TIMEOUT = 240


def _layer(name: str, cin: int):
    from sshslie_torch.models.illum_adjust import SEBlock, TransformerBlock
    from sshslie_torch.models.layers import Conv2d, ConvTranspose2d

    g = torch.Generator().manual_seed(5)
    return {"conv3": lambda: Conv2d(cin, 8, 3, generator=g),
            "conv9_kernel": lambda: Conv2d(cin, 64, 9, impl="kernel", generator=g),
            "conv3_stride2": lambda: Conv2d(cin, 8, 3, stride=2, generator=g),
            "deconv": lambda: ConvTranspose2d(cin, 4, 3, stride=2, output_padding=1, generator=g),
            "transformer": lambda: TransformerBlock(cin, attention_impl="dense", generator=g),
            "se": lambda: SEBlock(cin, generator=g)}[name]()


def _layer_inputs(name: str, shape):
    """(x, the upstream gradient of the whole output) for a layer case."""
    rng = np.random.default_rng([ord(c) for c in name])
    layer = _layer(name, shape[1])
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    with torch.no_grad():
        out_shape = layer(x).shape
    return x, torch.from_numpy(rng.standard_normal(tuple(out_shape), dtype=np.float32))


# ---- the worker: one rank of a group (run as a script; no JAX) ----

def _worker(rank: int, world: int, port: int, out: str) -> None:
    sys.path.insert(0, ROOT)
    from sshslie_torch import runner
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore
    from sshslie_torch.evaluate import ShardedInferencer, _make_inferencer, evaluate_model
    from sshslie_torch.models.enhance import LowLightEnhanceNet, shard_space
    from sshslie_torch.parallel import distributed, spatial
    from sshslie_torch.parallel.mesh import make_mesh
    from sshslie_torch.train import (LOSS_KEYS, Trainer, accum_train_step, fused_train_step,
                                     make_optimizer, train_step)

    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    sd = torch.load(os.path.join(out, "sd.pt"), weights_only=True)
    distributed.initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                                       world_size=world, rank=rank)
    shape = "1x2" if world == 2 else "2x2"
    mesh = make_mesh(shape)
    line = make_mesh(str(world))              # the same ranks as a 1-D data mesh
    space = mesh.shard("space")
    res = {"mesh": np.array(str(mesh)), "coords": np.array(mesh.coords)}
    batch = torch.from_numpy(inputs["batch"])

    def model_of(**kw):
        m = LowLightEnhanceNet(CHANNELS, attention_impl="dense", **kw)
        m.load_state_dict(sd)
        return m.train()

    def step(case):
        model = model_of(remat=case == "remat")
        shard_space(model, space)
        opt = make_optimizer(model, LR)
        rows = distributed.process_batch_slice(BATCH, mesh)
        if case == "accum":
            terms = accum_train_step(model, opt, batch[rows], COEFFS, 2, mesh=mesh)
        elif case == "fused":
            terms = fused_train_step(model, opt, torch.from_numpy(inputs["cubes"]),
                                     torch.from_numpy(inputs["draws"]), 0, PATCH, COEFFS,
                                     mesh=mesh)
        else:
            terms = train_step(model, opt, batch[rows], COEFFS, mesh=mesh)
        key = f"{shape}/{case}"
        res[f"{key}/terms"] = np.array([float(terms[k]) for k in LOSS_KEYS])
        for n, p in model.named_parameters():
            res[f"{key}/p/{n}"] = p.detach().numpy().copy()
            res[f"{key}/g/{n}"] = p.grad.numpy().copy()

    def infer(case, on):
        model = model_of().eval()
        outs = ShardedInferencer(model, on)(None, inputs[f"cube/{case}"])
        for name, t in zip(("R", "I", "Id", "S"), outs):
            res[f"infer/{case}/{name}"] = t.numpy()

    if world == 2:
        for name, cin, xshape in LAYERS:
            layer = _layer(name, cin)
            x, g = _layer_inputs(name, xshape)
            for m in layer.modules():
                if hasattr(m, "space"):
                    m.space = space
            x = spatial.take_rows(x, space, 2).clone().requires_grad_(True)
            y = layer(x)
            y.backward(spatial.take_rows(g, space, 2))
            res[f"layer/{name}/out"] = y.detach().numpy()
            res[f"layer/{name}/dx"] = x.grad.numpy()
            for n, p in layer.named_parameters():
                res[f"layer/{name}/g/{n}"] = p.grad.numpy()
        x = torch.from_numpy(inputs["prim/x"])
        own = spatial.take_rows(x, space, 2)
        for name in PRIMITIVES:
            xs = (x[rank, :, :2, 0] if name == "space_mean" else own).clone().requires_grad_(True)
            if name == "halo_rows":
                y = spatial.halo_rows(xs, space, *HALO)
            elif name == "gather_rows":
                y = spatial.gather_rows(xs, space)
            elif name == "gather_rows_replicated":
                y, = spatial.gather_rows_replicated([xs], space, dim=2)
            else:
                y = spatial.space_mean(xs, space)
            y.backward(torch.from_numpy(inputs[f"prim/{name}/g"][rank]))
            res[f"prim/{name}/out"] = y.detach().numpy()
            res[f"prim/{name}/dx"] = xs.grad.numpy()
        for case in ("step", "accum", "remat", "fused"):
            step(case)
        for case in ("aligned", "unaligned"):
            infer(case, line)
        # The eval of a trainer on the 1-D mesh, height-sharded (the default mode).
        cfg = load_config(None, {**FIT, "mesh_shape": "2", "eval_sharded": True,
                                 "global_min": 0.0, "global_max": 4095.0})
        trainer = Trainer(cfg, CHANNELS, state_dict=sd, mesh=line)
        res["eval/kind"] = np.array(type(_make_inferencer(trainer.model, cfg, line)).__name__)
        scores = evaluate_model(trainer, CubeStore(os.path.join(out, "eval"), normalization="self"),
                                os.path.join(out, "eval_out"), 1, None)
        res["eval/none"] = np.array(scores is None)
        # The patch restriction, and JAX's divisibility error, at fit's start.
        store = CubeStore(os.path.join(out, "cli", "train"), normalization="self")
        for patch in (40, 31):
            cfg = load_config(None, {**FIT, "mesh_shape": "1x2", "space_axis": "space",
                                     "patch_size": patch, "batch_size": 1})
            try:
                Trainer(cfg, CHANNELS, state_dict=sd, mesh=mesh).fit(
                    store, ckpt_dir=os.path.join(out, f"patch{patch}"))
            except (NotImplementedError, ValueError) as e:
                res[f"patch{patch}"] = np.array(f"{type(e).__name__}: {e}")
    else:
        step("step")
        infer("n4", line)
        # The CLI's main on the 2x2 group: dp x sp training, sharded evals and test.
        cli = os.path.join(out, "cli")
        os.chdir(cli)
        result = runner.main(load_config(None, {
            **FIT, "mesh_shape": "2x2", "space_axis": "space", "eval_sharded": True,
            "phase": "train_and_test", "model_name": "sp", "train_data": "train",
            "eval_data": "test", "test_data": "test", "label_dir": "label"}))
        trainer = result["trainer"]
        res["cli/losses"] = np.array([trainer.all_epoch_losses[k] for k in LOSS_KEYS])
        res["cli/result_dir"] = np.array(trainer.cfg.test_result_dir)
        res["cli/scores"] = np.array(result.get("scores") is not None)
    np.savez(os.path.join(out, f"w{world}_rank{rank}.npz"), **res)
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


class _Groups:
    """The two launched groups; their ranks' results once they end."""

    def __init__(self, out, procs):
        self.out, self.procs = out, procs
        self._ranks = {}

    def ranks(self, world):
        if world not in self._ranks:
            logs = []
            for p in self.procs[world]:
                try:
                    logs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0])
            for p, log in zip(self.procs[world], logs):
                assert p.returncode == 0, log[-4000:]
            self._ranks[world] = [dict(np.load(os.path.join(self.out, f"w{world}_rank{r}.npz")))
                                  for r in range(world)]
        return self._ranks[world]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Inputs written, the two groups started."""
    import jax

    from sshslie_torch.interop import jax_params_to_state_dict
    from sshslie_torch.train import fused_draws
    from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
    from sshslie_tpu.train import init_params

    out = str(tmp_path_factory.mktemp("space"))
    try:
        ports = (_free_port(), _free_port())
    except OSError as e:  # pragma: no cover - a sandbox without sockets
        pytest.skip(f"cannot allocate a local port: {e}")
    params = jax.tree_util.tree_map(np.asarray, init_params(
        JaxNet(input_channels=CHANNELS, attention_impl="xla"), 3, PATCH))
    torch.save(jax_params_to_state_dict(params), os.path.join(out, "sd.pt"))
    rng = np.random.default_rng(17)
    prim_x = rng.standard_normal((2, 3, 8, 5), dtype=np.float32)
    halo_shape = (2, 3, 4 + sum(HALO), 5)
    np.savez(os.path.join(out, "inputs.npz"),
             batch=rng.random((BATCH, PATCH, PATCH, CHANNELS), dtype=np.float32) * 0.4 + 0.05,
             cubes=rng.random((3, 48, 48, CHANNELS), dtype=np.float32) * 0.5 + 0.05,
             draws=fused_draws(5, 0, 1, BATCH, (48, 48), PATCH)[0],
             **{f"cube/{k}": rng.random((*hw, CHANNELS), dtype=np.float32) * 0.5 + 0.05
                for k, hw in CUBES.items()},
             **{"prim/x": prim_x,
                "prim/halo_rows/g": rng.standard_normal((2, *halo_shape), dtype=np.float32),
                "prim/gather_rows/g": rng.standard_normal((2, *prim_x.shape), dtype=np.float32),
                "prim/gather_rows_replicated/g": np.stack([rng.standard_normal(
                    prim_x.shape, dtype=np.float32)] * 2),
                "prim/space_mean/g": rng.standard_normal((2, 3, 2), dtype=np.float32)})
    _write_cubes(os.path.join(out, "eval"), 1, (32, 32, CHANNELS), 12)
    cli = os.path.join(out, "cli")
    _write_cubes(os.path.join(cli, "train"), 2, (40, 40, CHANNELS), 13)
    for sub in ("test", "label"):
        _write_cubes(os.path.join(cli, sub), 1, (32, 32, CHANNELS), 14)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = {world: [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), out],
        cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)] for world, port in zip((2, 4), ports)}
    g = _Groups(out, procs)
    g.params = params
    g.inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    g.sd = torch.load(os.path.join(out, "sd.pt"), weights_only=True)
    yield g
    for p in procs[2] + procs[4]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _close(got, want, rel, what):
    span = float(want.max() - want.min()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * span, err_msg=what)


@pytest.mark.parametrize("name,cin,xshape", LAYERS, ids=[c[0] for c in LAYERS])
def test_sharded_layer_matches_the_whole_layer(groups, name, cin, xshape):
    layer = _layer(name, cin)
    x, g = _layer_inputs(name, xshape)
    x.requires_grad_(True)
    y = layer(x)
    y.backward(g)
    ranks = groups.ranks(2)
    want = y.detach().numpy()
    _close(np.concatenate([r[f"layer/{name}/out"] for r in ranks], axis=2), want, 1e-6, "out")
    _close(np.concatenate([r[f"layer/{name}/dx"] for r in ranks], axis=2), x.grad.numpy(), 1e-6,
           "dx")
    # Each weight gradient within 1e-6 of its span, floored at 1e-6 of the
    # layer's largest (k_linear's bias has an exact gradient of zero).
    floor = 1e-6 * max(float(p.grad.max() - p.grad.min()) for p in layer.parameters())
    for n, p in layer.named_parameters():
        want = p.grad.numpy()
        np.testing.assert_allclose(sum(r[f"layer/{name}/g/{n}"] for r in ranks), want, rtol=0,
                                   atol=max(1e-6 * float(want.max() - want.min()), floor),
                                   err_msg=n)


@pytest.mark.parametrize("name", PRIMITIVES)
def test_space_primitive_matches_its_definition(groups, name):
    ranks = groups.ranks(2)
    x = groups.inputs["prim/x"]
    G = groups.inputs[f"prim/{name}/g"]
    h = x.shape[2] // 2
    for s, r in enumerate(ranks):
        own = slice(s * h, (s + 1) * h)
        if name == "halo_rows":
            up, down = HALO
            padded = np.pad(x, ((0, 0), (0, 0), (up, down), (0, 0)))
            want = padded[:, :, s * h: (s + 1) * h + up + down]
            # Each rank's halo'd gradient scattered onto the padded height, summed.
            dpad = np.zeros_like(padded)
            for t in range(2):
                dpad[:, :, t * h: (t + 1) * h + up + down] += G[t]
            want_dx = dpad[:, :, up:up + 2 * h][:, :, own]
        elif name == "gather_rows":
            want, want_dx = x, G.sum(axis=0)[:, :, own]
        elif name == "gather_rows_replicated":
            want, want_dx = x, G[s][:, :, own]
        else:
            want, want_dx = x[:, :, :2, 0].mean(axis=0), G.sum(axis=0) / 2
            want = np.broadcast_to(want, G[s].shape)
        _close(r[f"prim/{name}/out"], want, 1e-6, f"rank {s} out")
        _close(r[f"prim/{name}/dx"], want_dx, 1e-6, f"rank {s} dx")


def _jax_step(case, shape, params, batch):
    """JAX's dp×sp step of ``case`` on ``make_mesh(shape)`` → (terms, params)."""
    import jax
    import jax.numpy as jnp

    from sshslie_torch.interop import jax_params_to_state_dict
    from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
    from sshslie_tpu.parallel.mesh import batch_space_sharding, make_mesh, replicated_sharding
    from sshslie_tpu.train import TrainState, make_accum_train_step, make_optimizer, make_train_step

    key = (case == "accum", shape)
    if key not in _JAX_STEPS:
        model = JaxNet(input_channels=CHANNELS, attention_impl="xla")
        tx = make_optimizer()
        mesh = make_mesh(shape)
        make = (lambda **kw: make_accum_train_step(model, tx, COEFFS, 2, **kw)) if key[0] else (
            lambda **kw: make_train_step(model, tx, COEFFS, **kw))
        _JAX_STEPS[key] = (tx, mesh, make(mesh=mesh, space_axis="space"))
    tx, mesh, step = _JAX_STEPS[key]
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax.device_put(TrainState(params=p, opt_state=tx.init(p),
                                      step=jnp.zeros((), jnp.int32)), replicated_sharding(mesh))
    state, terms = step(state, jax.device_put(jnp.asarray(batch), batch_space_sharding(mesh)),
                        jnp.float32(LR))
    after = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    return {k: float(v) for k, v in terms.items()}, after


_JAX_STEPS = {}


@pytest.mark.parametrize("key", STEPS)
def test_dp_sp_step_matches_jax(groups, key):
    from sshslie_torch.train import LOSS_KEYS, sample_fused_batch

    shape, case = key.split("/")
    batch = groups.inputs["batch"]
    if case == "fused":
        batch = sample_fused_batch(torch.from_numpy(groups.inputs["cubes"]),
                                   torch.from_numpy(groups.inputs["draws"]), 0, PATCH).numpy()
    want_terms, want = _jax_step(case, shape, groups.params, batch)
    ranks = groups.ranks(4 if shape == "2x2" else 2)
    r0 = ranks[0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{key}/terms"], r0[f"{key}/terms"])
    np.testing.assert_allclose(r0[f"{key}/terms"], [want_terms[k] for k in LOSS_KEYS], rtol=1e-5)
    for name, p0 in groups.sd.items():
        got, g = r0[f"{key}/p/{name}"], r0[f"{key}/g/{name}"]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{key}/p/{name}"], got, err_msg=name)
        np.testing.assert_allclose(got, p0.numpy() - LR * g / (np.abs(g) + 1e-8), rtol=0,
                                   atol=1e-4 * LR, err_msg=f"{name}: Adam on the port's gradient")
        strong = np.abs(g) > 1e-5
        np.testing.assert_allclose(got[strong], want[name].numpy()[strong], rtol=1e-4, atol=5e-5,
                                   err_msg=f"{name}: against JAX's dp x sp step")


def test_mesh_coordinates_and_groups(groups):
    for world, shape in ((2, (1, 2)), (4, (2, 2))):
        for r, res in enumerate(groups.ranks(world)):
            assert tuple(res["coords"]) == (r // shape[1], r % shape[1])
            assert str(res["mesh"]) == (f"Mesh('data': {shape[0]}, 'space': {shape[1]}; "
                                        f"rank {r}, backend gloo)")


@pytest.mark.parametrize("case", list(CUBES))
def test_sharded_inferencer_matches_jax_and_one_device(groups, case):
    import jax

    from sshslie_torch.evaluate import Inferencer
    from sshslie_torch.models.enhance import LowLightEnhanceNet
    from sshslie_tpu.evaluate import ShardedInferencer as JaxSharded
    from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
    from sshslie_tpu.parallel.mesh import make_mesh

    n = 4 if case == "n4" else 2
    cube = groups.inputs[f"cube/{case}"]
    model = LowLightEnhanceNet(CHANNELS, attention_impl="dense")
    model.load_state_dict(groups.sd)
    # The one-device forward with the sharded one's pad (W is a multiple of 8·n).
    one = [t.numpy() for t in Inferencer(model.eval(), pad_multiple=8 * n)(None, cube)]
    jax_out = [np.asarray(t) for t in JaxSharded(
        JaxNet(input_channels=CHANNELS, attention_impl="xla"), make_mesh(str(n)))(
        jax.tree_util.tree_map(np.asarray, groups.params), cube)]
    ranks = groups.ranks(n)
    for i, name in enumerate(("R", "I", "Id", "S")):
        got = ranks[0][f"infer/{case}/{name}"]
        assert got.shape == (*cube.shape[:2], one[i].shape[-1])
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"infer/{case}/{name}"], got)
        for what, want in (("one device", one[i]), ("JAX", jax_out[i])):
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-5,
                                       err_msg=f"{name} against {what}")


def test_evaluate_model_spatial_writes_on_rank0_only(groups, tmp_path):
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore
    from sshslie_torch.evaluate import evaluate_model
    from sshslie_torch.train import Trainer

    r0, r1 = groups.ranks(2)
    assert str(r0["eval/kind"]) == "ShardedInferencer"
    assert bool(r0["eval/none"]) and bool(r1["eval/none"])
    assert os.listdir(os.path.join(groups.out, "eval_out")) == ["epoch_1"]
    cfg = load_config(None, {**FIT, "global_min": 0.0, "global_max": 4095.0})
    single = Trainer(cfg, CHANNELS, state_dict=groups.sd)
    evaluate_model(single, CubeStore(os.path.join(groups.out, "eval"), normalization="self"),
                   str(tmp_path), 1, None)
    a = sio.loadmat(str(tmp_path / "epoch_1" / "c0.mat"))["data"]
    b = sio.loadmat(os.path.join(groups.out, "eval_out", "epoch_1", "c0.mat"))["data"]
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-3)


def test_runner_dp_sp_train_and_test(groups, tmp_path, monkeypatch):
    from glob import glob

    from sshslie_torch import runner
    from sshslie_torch.config import load_config
    from sshslie_torch.train import LOSS_KEYS

    ranks = groups.ranks(4)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["cli/losses"], ranks[0]["cli/losses"])
    assert bool(ranks[0]["cli/scores"]) and not any(bool(r["cli/scores"]) for r in ranks[1:])
    cli = os.path.join(groups.out, "cli")
    logs = sorted(glob(os.path.join(cli, "logs", "console_output_sp_*.log")))
    assert len(logs) == 4, logs
    assert "Mesh: Mesh('data': 2, 'space': 2; rank 0, backend gloo)" in open(logs[0]).read()
    got = sio.loadmat(os.path.join(cli, str(ranks[0]["cli/result_dir"]), "c0.mat"))["data"]
    # The same run in one process, from the same seeded weights.
    for sub in ("train", "test", "label"):
        os.symlink(os.path.join(cli, sub), str(tmp_path / sub))
    monkeypatch.chdir(tmp_path)
    result = runner.main(load_config(None, {
        **FIT, "phase": "train_and_test", "model_name": "one", "train_data": "train",
        "eval_data": "test", "test_data": "test", "label_dir": "label"}))
    one = result["trainer"].all_epoch_losses
    np.testing.assert_allclose(ranks[0]["cli/losses"][:, 0], [one[k][0] for k in LOSS_KEYS],
                               rtol=1e-5)
    want = sio.loadmat(os.path.join(result["trainer"].cfg.test_result_dir, "c0.mat"))["data"]
    _close(got, want, 5e-5, "test S")


def test_patch_the_port_cannot_split_raises(groups):
    r0, r1 = groups.ranks(2)
    for r in (r0, r1):
        assert str(r["patch40"]).startswith("NotImplementedError: patch_size 40 is not a multiple "
                                            "of 8 x 2"), str(r["patch40"])
        assert "documented difference from JAX" in str(r["patch40"])
        assert str(r["patch31"]) == ("ValueError: patch_size 31 not divisible by the 'space' "
                                     "mesh axis (2 shards)")


def test_serving_on_a_mesh_still_raises():
    from sshslie_torch.config import check_ported, load_config

    for shape in ("2", "2x2"):
        cfg = load_config(None, {"mesh_shape": shape, "space_axis": "space", "phase": "serve"})
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 7: serving"):
            check_ported(cfg)
    check_ported(load_config(None, {"mesh_shape": "2x2", "space_axis": "space",
                                    "eval_sharded": True}))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
