"""The port's weight-only quantization (``sshslie_torch/ops/quant.py``) against
the JAX package's (``sshslie_tpu/ops/quant.py``) on the same seeded weights.

* Quantized tensors: after the layout map (``interop.jax_layout``: ``q``
  transposed as its weight, the scale as a vector) the ``q`` bytes, the
  scales and the stats are equal, for every tensor and format (absmax),
  int4 packing with odd output counts and the ConvTranspose axis included.
* mse calibration: the same scales; where a channel's two scales differ,
  their weight errors tie within 1e-6 relative (sums in another order).
* Output calibration on a 6-band model: the same ratios, or objectives
  within 1e-5 relative.
* The forward: ``QuantizedInferencer`` within 1e-5 of JAX's (float32 sums in
  another order; measured ~1e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.config import Config as JaxConfig
from sshslie_tpu.ops import quant as jq
from sshslie_tpu.train import build_model as jax_build_model
from sshslie_tpu.train import init_params
from sshslie_torch.config import Config
from sshslie_torch.interop import jax_layout, jax_params_to_state_dict
from sshslie_torch.models.enhance import build_model
from sshslie_torch.ops import quant as tq

CHANNELS = 6
FORMATS = ("int8", "fp8", "int4")


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(channels=CHANNELS, patch_size=16, attention_impl="xla")
    jmodel = jax_build_model(jcfg, CHANNELS)
    params = init_params(jmodel, 0, 16)
    sd = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    model = build_model(Config(channels=CHANNELS, patch_size=16, device="cpu"), CHANNELS, "cpu")
    model.load_state_dict(sd)
    return jmodel, params, model


def _q_bytes(q) -> np.ndarray:
    """Stored q of either package as a numpy array of its raw bytes' dtype."""
    if isinstance(q, torch.Tensor):
        return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q).numpy()
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.itemsize == 1 and q.dtype.kind not in "iu" else q


def _jax_nodes(jqtree, params):
    """{port weight key: (JAX q in the port layout, JAX scale vector)}."""
    out = {}
    for jpath, (prefix, perm) in jax_layout(params).items():
        node = jqtree
        for part in jpath.split("."):
            node = node[part]
        node = node["kernel"]
        if isinstance(node, dict) and "__quantized__" in node:
            out[prefix + ".weight"] = (_q_bytes(node["q"]).transpose(perm),
                                       np.asarray(node["scale"]).reshape(-1))
    return out


def _int_values(q: np.ndarray, fmt: str, cout: int, axis: int) -> np.ndarray:
    """Per-channel integer (or fp8 byte) values, the output axis first."""
    if fmt == "int4":
        q = tq._unpack_int4(torch.from_numpy(np.ascontiguousarray(q)), cout, axis).numpy()
    return np.moveaxis(q, axis, 0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_state_dict_equals_jax(models, fmt):
    jmodel, params, model = models
    jqtree, jstats = jq.quantize_tree(params, fmt, calibration="absmax")
    qsd, stats = tq.quantize_state_dict(model.state_dict(), fmt, calibration="absmax",
                                        axes=tq.output_axes(model))
    assert stats == jstats
    want = _jax_nodes(jqtree, params)
    got = {k: v for k, v in qsd.items() if isinstance(v, tq.QuantizedTensor)}
    assert sorted(got) == sorted(want) and len(got) == stats["tensors_quantized"]
    for key, node in got.items():
        jqv, jscale = want[key]
        np.testing.assert_array_equal(_q_bytes(node.q), jqv, err_msg=key)
        assert _q_bytes(node.q).dtype == jqv.dtype, key
        np.testing.assert_array_equal(node.scale.numpy().reshape(-1), jscale, err_msg=key)
    # The axes: the one ConvTranspose2d weight (IOHW) quantizes along axis 1;
    # IllumAdjustmentNet's deconv1..3 are a resize and a Conv2d (OIHW).
    assert [k for k, v in got.items() if v.axis == 1] == ["decomposition_net.deconv.0.weight"]
    # Biases and small tensors stay float32 as they were.
    for key, t in qsd.items():
        if not isinstance(t, tq.QuantizedTensor):
            assert torch.equal(t, model.state_dict()[key])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", ["OIHW", "IOHW", "linear"])
def test_quantize_array_odd_outputs_equal_jax(fmt, layout):
    """Odd output counts (a padded nibble for int4) on every port layout."""
    rng = np.random.RandomState(3)
    w_jax = {"OIHW": rng.randn(3, 3, 4, 5), "IOHW": rng.randn(3, 3, 4, 7),
             "linear": rng.randn(12, 9)}[layout].astype(np.float32)
    perm, axis = {"OIHW": ((3, 2, 0, 1), 0), "IOHW": ((2, 3, 0, 1), 1),
                  "linear": ((1, 0), 0)}[layout]
    jnode = jq.quantize_array(jnp.asarray(w_jax), fmt)
    node = tq.quantize_array(torch.from_numpy(np.ascontiguousarray(w_jax.transpose(perm))),
                             fmt, axis=axis)
    np.testing.assert_array_equal(_q_bytes(node.q), _q_bytes(jnode["q"]).transpose(perm))
    np.testing.assert_array_equal(node.scale.numpy().reshape(-1),
                                  np.asarray(jnode["scale"]).reshape(-1))
    np.testing.assert_array_equal(tq.dequantize_array(node).numpy(),
                                  np.asarray(jq.dequantize_array(jnode)).transpose(perm))


def test_pack_int4_round_trip_along_each_axis():
    q = torch.arange(-7, 8, dtype=torch.int8).reshape(3, 5)
    for axis in (0, 1):
        p = tq._pack_int4(q, axis)
        assert p.dtype == torch.uint8 and p.shape[axis] == (q.shape[axis] + 1) // 2
        assert torch.equal(tq._unpack_int4(p, q.shape[axis], axis), q.to(torch.int32))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_mse_calibration_matches_jax(models, fmt):
    _, params, model = models
    jqtree, _ = jq.quantize_tree(params, fmt, calibration="mse")
    qsd, _ = tq.quantize_state_dict(model.state_dict(), fmt, calibration="mse",
                                    axes=tq.output_axes(model))
    want = _jax_nodes(jqtree, params)
    sd = model.state_dict()
    qmax = tq._FORMATS[fmt]["max"]
    differing = 0
    for key, (jqv, jscale) in want.items():
        node = qsd[key]
        scale = node.scale.numpy().reshape(-1)
        w = np.moveaxis(sd[key].numpy().astype(np.float64), node.axis, 0)
        w = w.reshape(w.shape[0], -1)
        same = scale == jscale
        for c in np.flatnonzero(~same):
            # A tie: both scales give the same weight error within 1e-6.
            errs = [np.sum((np.clip(np.round(w[c] / np.float32(s)), -qmax, qmax) * s - w[c]) ** 2)
                    for s in (scale[c], jscale[c])]
            np.testing.assert_allclose(errs[0], errs[1], rtol=1e-6, err_msg=f"{key}[{c}]")
        differing += int((~same).sum())
        cout = scale.size
        got_v = _int_values(_q_bytes(node.q), fmt, cout, node.axis)
        want_v = _int_values(jqv, fmt, cout, node.axis)
        np.testing.assert_array_equal(got_v[same], want_v[same], err_msg=key)
    assert differing <= 2


def test_output_calibration_matches_jax(models, rng):
    jmodel, params, model = models
    cubes = [(rng.rand(24, 24, CHANNELS) * 0.8).astype(np.float32)]
    _, jstats, jratios = jq.calibrate_quantize_tree(jmodel, params, cubes, "int4")
    qsd, stats, ratios = tq.calibrate_quantize_state_dict(model, cubes, "int4")
    assert stats == jstats
    layout = jax_layout(params)
    jratios = {layout[p[:-len("/kernel")].replace("/", ".")][0] + ".weight": r
               for p, r in jratios.items()}
    assert sorted(ratios) == sorted(jratios)
    if ratios != jratios:
        # A near tie went the other way: both choices score the same.
        x = torch.from_numpy(cubes[0])[None]
        with torch.inference_mode():
            ref = model(x)[3]

        def objective(rs):
            q = dict(tq.quantize_state_dict(model.state_dict(), "int4", calibration="absmax",
                                            axes=tq.output_axes(model))[0])
            axes = tq.output_axes(model)
            for k, r in rs.items():
                if r != 1.0:
                    q[k] = tq._ratio_quantize(model.state_dict()[k], "int4", r, axes[k])
            with torch.inference_mode():
                return float(torch.mean((tq._quantized_forward(model, q, x)[3] - ref) ** 2))

        np.testing.assert_allclose(objective(ratios), objective(jratios), rtol=1e-5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_inferencer_matches_jax(models, rng, fmt):
    jmodel, params, model = models
    cube = (rng.rand(24, 24, CHANNELS) * 0.8).astype(np.float32)
    jqtree, _ = jq.quantize_tree(params, fmt)
    qsd, _ = tq.quantize_state_dict(model.state_dict(), fmt, axes=tq.output_axes(model))
    want = jq.QuantizedInferencer(jmodel, jqtree)(None, cube)
    got = tq.QuantizedInferencer(model, qsd)(None, cube)
    for name, a, b in zip(("R_low", "I_low", "I_delta", "S"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


def test_quantized_inferencer_pads(models, rng):
    _, _, model = models
    qsd, _ = tq.quantize_state_dict(model.state_dict(), axes=tq.output_axes(model))
    R, I, Id, S = tq.QuantizedInferencer(model, qsd, pad_multiple=16)(
        None, (rng.rand(20, 22, CHANNELS)).astype(np.float32))
    assert S.shape == (20, 22, CHANNELS) and I.shape == (20, 22, 1)


@pytest.mark.parametrize("fmt,calibration", [("int8", "auto"), ("int4", "absmax")])
def test_quantization_impact_matches_jax(models, rng, fmt, calibration):
    jmodel, params, model = models
    cubes = [(rng.rand(24, 24, CHANNELS) * 0.8).astype(np.float32) for _ in range(2)]
    want = jq.quantization_impact(jmodel, params, cubes, fmt, calibration)
    got = tq.quantization_impact(model, cubes, fmt, calibration)
    for key in ("fmt", "calibration", "bytes_fp32", "bytes_quant", "compression",
                "tensors_quantized"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["psnr_vs_fp32"], want["psnr_vs_fp32"], atol=1e-2)
    assert got["psnr_vs_fp32_avg"] > (35.0 if fmt == "int8" else 25.0)


def test_zero_channel_and_denormal_amax_stay_finite():
    """A zero channel dequantizes to zeros; a denormal amax gives finite
    weights. (There the scales differ from JAX's: XLA flushes the denormal
    amax / Qmax to 0 and takes scale 1, torch keeps the denormal scale.)"""
    zero = torch.zeros(4, 2, 3, 3)
    np.testing.assert_array_equal(tq.dequantize_array(tq.quantize_array(zero, "int8")).numpy(),
                                  zero.numpy())
    w = torch.full((4, 3), 2e-38)
    for fmt in FORMATS:
        node = tq.quantize_array(w, fmt)
        assert bool(torch.isfinite(node.scale).all()) and bool(
            torch.isfinite(tq.dequantize_array(node)).all()), fmt
        assert float(tq.dequantize_array(node).abs().max()) <= 2.1e-38, fmt


def test_unknown_format_and_calibration_raise():
    with pytest.raises(ValueError):
        tq.quantize_state_dict({"k": torch.ones(8, 8)}, "int2")
    with pytest.raises(ValueError):
        tq.quantize_array(torch.ones(8, 8), "int4", "percentile")
