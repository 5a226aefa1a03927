"""``matmul_precision`` below full float32 in the port, on the CPU.

* ``ops.conv9.round_to_tf32`` bit for bit against an independent numpy
  rounding (float64 arithmetic: 11 significant bits for normal values, a
  quantum of 2^-136 for subnormal ones, ties away from zero): ties,
  negatives, subnormals, overflow to inf, +-inf, NaN.
* The TF32 plain versions (``conv9_plain``/``conv9_wgrad_plain`` with
  ``tf32=True``) and ShallowConv's TF32 passes against the JAX Pallas
  kernels in interpret mode and ``jax.vjp`` of ``pallas_shallow_conv``, fed
  the same inputs rounded to TF32 in numpy: the TF32 conv is the float32
  conv of the rounded operands, since a product of two TF32 values is exact
  in float32. k = 3, 9, 13, within 1e-5 of the largest result (float32 sums
  of up to 10816 products in another order).
* ``config.matmul_tf32`` on the seven values, and the Conv2d flags
  ``build_model`` sets from it.
* ``runner.main`` on the CPU: ``train_and_test`` with ``tensorfloat32``
  equals the float32 run bit for bit (the CPU stays float32, as XLA's CPU
  backend does), and the JAX runner's run with the same key within the
  golden trajectory's tolerances (every term within 2e-5 of that epoch's
  total, totals within rtol 2e-4 of ``GOLDEN_HOST_TOTAL``); a bfloat16 run
  with the key equals one without it; the runner and
  ``serve.build_server_from_config`` set both TF32 switches from the config,
  without a warning, and torch's newer ``fp32_precision`` settings follow them.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.config import Config as JaxConfig
from sshslie_tpu.config import load_config as jax_load_config
from sshslie_tpu.ops.conv_pallas import conv9_fwd as jax_conv9_fwd
from sshslie_tpu.ops.conv_pallas import conv9_wgrad as jax_conv9_wgrad
from sshslie_tpu.ops.conv_pallas import pallas_shallow_conv
from sshslie_tpu.train import Trainer as JaxTrainer
from sshslie_torch import checkpoints, interop, runner, serve
from sshslie_torch.config import TF32_PRECISIONS, load_config, matmul_tf32
from sshslie_torch.data.datasets import CubeStore
from sshslie_torch.models.enhance import build_model
from sshslie_torch.models.layers import Conv2d
from sshslie_torch.ops import conv9
from sshslie_torch.train import LOSS_KEYS, Trainer
from test_golden_trajectory import GOLDEN_HOST_TOTAL


def numpy_tf32(a):
    """float32 ``a`` rounded to TF32 in float64 arithmetic, ties away from zero."""
    a = np.asarray(a, np.float32)
    x = a.astype(np.float64)
    out = np.empty_like(x)
    finite = np.isfinite(x)
    mag = np.abs(x)
    normal = finite & (mag >= 2.0 ** -126)
    _, e = np.frexp(mag[normal])                 # mag = f 2^e, 0.5 <= f < 1
    quantum = np.ldexp(1.0, e - 11)              # 11 significant bits
    out[normal] = np.floor(mag[normal] / quantum + 0.5) * quantum
    sub = finite & ~normal
    out[sub] = np.floor(mag[sub] / 2.0 ** -136 + 0.5) * 2.0 ** -136
    out[finite] = np.copysign(out[finite], x[finite])
    out[~finite] = x[~finite]
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def test_round_to_tf32_matches_numpy():
    rng = np.random.default_rng(0)
    tiny = np.float32(2.0 ** -149)
    ties = (np.arange(1, 2049) + 0.5) * 2.0 ** -10          # mantissa halfway, 1 <= v < 3
    vals = np.concatenate([
        rng.standard_normal(4000) * 10.0 ** rng.integers(-30, 30, 4000),
        ties, -ties, ties * 2.0 ** -100,
        rng.integers(1, 2 ** 23, 2000) * tiny,              # subnormals
        (np.arange(1, 200) * 2 ** 13 + 2 ** 12) * tiny,      # subnormal ties
        [0.0, -0.0, np.inf, -np.inf, 3.4028235e38, -3.4028235e38, 3.39e38, 2.0 ** -126,
         np.float32(2.0 ** -126) - tiny, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23],
    ]).astype(np.float32)
    got = conv9.round_to_tf32(torch.from_numpy(vals)).numpy()
    want = numpy_tf32(vals)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.any(got.view(np.int32) & 0x1FFF)
    assert np.isinf(got[vals == np.float32(3.4028235e38)]).all()
    nan = conv9.round_to_tf32(torch.tensor([np.nan, -np.nan], dtype=torch.float32))
    assert torch.isnan(nan).all()
    with pytest.raises(ValueError, match="float32"):
        conv9.round_to_tf32(torch.zeros(2, dtype=torch.bfloat16))


def _inputs(seed, shape, k):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape, dtype=np.float32) * 0.9 + 0.05) * rng.choice([-1, 1], shape)
    w = (rng.standard_normal((k, k, 64, 64)) * 0.05).astype(np.float32)
    return x.astype(np.float32), w


def _rel_close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * float(np.abs(want).max()),
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("k", [3, 9, 13])
def test_tf32_plain_versions_match_pallas_interpret(k):
    x, w = _inputs(90 + k, (1, 8, 128, 64), k)
    dy = np.random.default_rng(100 + k).standard_normal(x.shape).astype(np.float32)
    xr, wr, dyr = numpy_tf32(x), numpy_tf32(w), numpy_tf32(dy)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    want = np.asarray(jax_conv9_fwd(jnp.asarray(xr), jnp.asarray(wr), interpret=True))
    got = conv9.conv9_plain(tx, tw, tf32=True)
    _rel_close(got.numpy(), want, 1e-5, f"conv9 k{k}")
    # A CPU tensor takes the plain version, with the rounding asked for.
    assert torch.equal(conv9.conv9_fwd(tx, tw, tf32=True), got)
    # The rounding is what TF32 changes: float32 operands give another result.
    assert not torch.equal(conv9.conv9_plain(tx, tw), got)
    want = np.asarray(jax_conv9_wgrad(jnp.asarray(xr), jnp.asarray(dyr), k, interpret=True))
    got = conv9.conv9_wgrad_plain(tx, tdy, k, tf32=True)
    _rel_close(got.numpy(), want, 1e-5, f"conv9_wgrad k{k}")
    assert torch.equal(conv9.conv9_wgrad(tx, tdy, k, tf32=True), got)


@pytest.mark.parametrize("k", [3, 9, 13])
def test_shallow_conv_tf32_matches_pallas_vjp(k):
    """Forward, dgrad (conv9 of the rounded gradient with the reversed,
    transposed rounded weights), weight gradient and bias gradient."""
    x, w = _inputs(110 + k, (1, 8, 128, 64), k)
    rng = np.random.default_rng(120 + k)
    b = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    y, vjp = jax.vjp(lambda x_, w_, b_: pallas_shallow_conv(x_, w_, b_, True),
                     jnp.asarray(numpy_tf32(x)), jnp.asarray(numpy_tf32(w)), jnp.asarray(b))
    dx, dw, _ = vjp(jnp.asarray(numpy_tf32(g)))
    _, _, db = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    out = conv9.shallow_conv(*ts, tf32=True)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    _rel_close(out.detach().numpy(), y, 1e-5, "y")
    for name, a, c in zip(("dx", "dw", "db"), got, (dx, dw, db)):
        _rel_close(a.numpy(), c, 1e-5, name)


@pytest.mark.parametrize("value,tf32", [
    ("", False), ("float32", False), ("highest", False), ("default", True), ("bfloat16", True),
    ("high", True), ("tensorfloat32", True),
])
def test_matmul_tf32_maps_the_seven_values(value, tf32):
    assert matmul_tf32(value) is tf32
    assert (value in TF32_PRECISIONS) is tf32
    cfg = load_config(None, {"device": "cpu", "channels": 6, "matmul_precision": value})
    flags = {m.tf32 for m in build_model(cfg, 6).modules() if isinstance(m, Conv2d)}
    assert flags == {tf32}


def test_matmul_tf32_refuses_other_values():
    with pytest.raises(ValueError, match="matmul_precision"):
        matmul_tf32("bfloat16_3x")
    with pytest.raises(ValueError, match="matmul_precision"):
        load_config(None, {"matmul_precision": "tf32"})


GOLDEN_KW = dict(channels=6, patch_size=16, batch_size=2, epoch=5, eval_every_epoch=100,
                 plot_every_epoch=100, attention_impl="xla", fused_pipeline="off",
                 sampler="python", seed_value=41, normalization="self")


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    """tests/test_golden_trajectory.py's cubes."""
    import scipy.io as sio

    d = tmp_path_factory.mktemp("golden")
    rng = np.random.RandomState(20260816)
    for i in range(4):
        sio.savemat(str(d / f"c{i}.mat"), {"data": (rng.rand(24, 24, 6) * 100).astype(np.float32)})
    return str(d)


@pytest.fixture
def tf32_switches():
    """The two TF32 switches, restored after the test."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _switches():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_runner_tensorfloat32_on_cpu_is_float32_and_jax(golden_dir, tmp_path, monkeypatch,
                                                         tf32_switches):
    monkeypatch.chdir(tmp_path)
    kw = dict(GOLDEN_KW, phase="train_and_test", train_data=golden_dir, eval_data=golden_dir,
              test_data=golden_dir, label_dir=golden_dir, model_name="run")
    # The JAX Trainer's initial params at seed 41, for the port to start from.
    jcfg = JaxConfig(**GOLDEN_KW)
    jcfg.finalize()
    sd = interop.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, JaxTrainer(jcfg, channels=6).state.params))
    interop.save_checkpoint("init.pth", sd, epoch=0)
    losses = {}
    for value in ("", "tensorfloat32"):
        cfg = load_config(None, dict(kw, device="cpu", matmul_precision=value,
                                     pretrained_model="init.pth", timestamp=f"port{value}"))
        result = runner.main(cfg)
        assert _switches() == (matmul_tf32(value),) * 2
        losses[value] = result["trainer"].all_epoch_losses
        assert np.isfinite(result["scores"]).all()
    assert losses["tensorfloat32"] == losses[""]          # bit for bit

    before = jax.config.jax_default_matmul_precision
    try:
        jax_runner = __import__("sshslie_tpu.runner", fromlist=["main"])
        jax_runner.main(jax_load_config(None, dict(kw, device="cpu", jit_cache_dir="",
                                                   matmul_precision="tensorfloat32",
                                                   timestamp="jax")))
        assert jax.config.jax_default_matmul_precision == "tensorfloat32"
    finally:
        jax.config.update("jax_default_matmul_precision", before)
    with open(os.path.join("runs", "run_jax", "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    jax_losses = {k: [r[k] for r in rows if r.get("step") is not None and k in r]
                  for k in LOSS_KEYS}
    port = losses["tensorfloat32"]
    for k in LOSS_KEYS:
        assert len(jax_losses[k]) == len(port[k]) == 5, k
        np.testing.assert_array_less(np.abs(np.subtract(port[k], jax_losses[k])),
                                     2e-5 * np.asarray(jax_losses["total_loss"]), err_msg=k)
    np.testing.assert_allclose(jax_losses["total_loss"], GOLDEN_HOST_TOTAL, rtol=2e-4)
    np.testing.assert_allclose(port["total_loss"], GOLDEN_HOST_TOTAL, rtol=2e-4)


def test_bfloat16_run_with_the_key_equals_one_without(golden_dir, tmp_path):
    runs = {}
    for value in ("", "tensorfloat32"):
        cfg = load_config(None, dict(GOLDEN_KW, device="cpu", epoch=2, precision="bfloat16",
                                     matmul_precision=value))
        trainer = Trainer(cfg, 6)
        trainer.fit(CubeStore(golden_dir, normalization="self"),
                    ckpt_dir=str(tmp_path / f"ck{value}"))
        runs[value] = trainer.all_epoch_losses
    assert runs["tensorfloat32"] == runs[""]


@pytest.mark.parametrize("value", ["tensorfloat32", "float32", "high", "", "default", "highest"])
def test_runner_and_server_set_the_switches(golden_dir, tmp_path, monkeypatch, tf32_switches,
                                            value):
    monkeypatch.chdir(tmp_path)
    want = (matmul_tf32(value),) * 2
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = not want[0]
    cfg = load_config(None, dict(GOLDEN_KW, device="cpu", epoch=1, phase="train",
                                 train_data=golden_dir, matmul_precision=value, use_mlflow=False))
    runner.main(cfg)
    assert _switches() == want
    assert os.path.exists(checkpoints.latest_path(cfg.test_model_dir))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = not want[0]
    scfg = load_config(None, dict(GOLDEN_KW, device="cpu", phase="serve", serve_port=0,
                                  test_timestamp=cfg.timestamp, matmul_precision=value))
    server = serve.build_server_from_config(scfg)
    try:
        assert _switches() == want
    finally:
        server.shutdown()


def test_switches_show_in_the_newer_precision_api(tf32_switches):
    """The legacy switches set under warnings-as-errors, and torch's
    fp32_precision settings (where this torch has them) follow them."""
    import warnings

    from sshslie_torch.device import set_matmul_precision

    for value, tf32 in (("tensorfloat32", True), ("float32", False)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert set_matmul_precision(load_config(None, {"matmul_precision": value})) is tf32
        assert _switches() == (tf32, tf32)
        matmul = getattr(torch.backends.cuda.matmul, "fp32_precision", None)
        conv = getattr(getattr(torch.backends.cudnn, "conv", None), "fp32_precision", None)
        if matmul is not None:
            assert (matmul == "tf32") is tf32 and (conv == "tf32") is tf32
