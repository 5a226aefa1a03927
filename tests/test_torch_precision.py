"""``precision: bfloat16`` and ``remat`` of the port against the JAX package on the CPU.

* The bfloat16 forward (all four outputs) against JAX ``build_model(precision=
  "bfloat16")`` on transplanted weights: 4 bands with the TransformerBlock and
  with the SEBlock, and 64 bands with ``conv_impl: kernel`` (the shallow conv
  through ShallowConv on its plain passes; the JAX side takes the XLA conv,
  the same function at the same rounding points, since the Pallas gate needs
  W % 128). Both packages cast each layer's input and parameters to
  bfloat16, add the bias after the product in bfloat16, and return float32.
  What is left between them is the rare bfloat16 rounding that falls the
  other way because a float32 sum ran in another order (about 1e-4 of a
  conv's outputs, either package against the exactly rounded sum), carried
  through the nets. So each output is held to
  - max|port - JAX| <= MAX_ATOL[name], one to two bfloat16 steps of that
    output (measured: R and I 1.2e-4, I_delta 4.9e-4 to 7.3e-4, S 2.5e-4 to
    3.8e-4), and
  - mean|port - JAX| <= 0.6 of mean|JAX bf16 - JAX f32| (measured 0.07 of it
    for R and I, 0.42 to 0.48 for I_delta and S), so a silent float32 run,
    which sits at the whole gap, fails;
  and the port's own bfloat16 S must differ from its float32 S by at least
  3e-4 (JAX at 4 bands, 16^2: 5.6e-4; the port 5.2e-4 to 5.6e-4).
* The bfloat16 loss and gradients at the stock loss weights: bfloat16
  rounding noise dominates both, so a port and a JAX run sit about as far
  apart as bfloat16 and float32 do (the terms' bf16-f32 gap is up to 1.5e-3;
  the gradients' 3.8e-2 in L2). The test holds the 7 terms to rtol 5e-3 of
  JAX's (measured <= 2.7e-3), all gradients together to 0.1 of JAX's L2 norm
  (measured 2.8e-2), the gradients in float32, and the port's bfloat16
  gradients at least 1e-2 of that norm away from its float32 ones, so the
  step did run in bfloat16. The forward test above is the one that tells a
  silent float32 run apart.
* The loss already receives float32: R, I and I_delta leave the nets in
  float32, so S and R_enh are float32 under bfloat16 in both packages (JAX's
  rfft2 refuses bfloat16; no upcast is needed).
* The plain conv9 versions on bfloat16 operands against the Pallas kernels in
  interpret mode on the same operands: the forward in bfloat16, within one
  bfloat16 step of its largest output (2^-7 of it, 0.105; measured 3.1e-2,
  single steps in 2.3e-4 of the outputs; summing the 81 taps in bfloat16
  instead is 0.25 off); the weight gradient in
  float32 within 1e-5 of its largest magnitude (measured 1.7e-7).
* ShallowConv's bfloat16 gradients come back in bfloat16 and reach the
  float32 parameters in float32.
* remat: gradients and outputs equal those without it, bit for bit on the
  CPU (the same arithmetic, recomputed), with the same state-dict keys.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.config import Config as JaxConfig
from sshslie_tpu.ops.conv_pallas import conv9_fwd as jax_conv9_fwd
from sshslie_tpu.ops.conv_pallas import conv9_wgrad as jax_conv9_wgrad
from sshslie_tpu.train import _make_loss_fn, build_model as jax_build_model, init_params
from sshslie_torch.config import load_config
from sshslie_torch.interop import jax_params_to_state_dict
from sshslie_torch.models.enhance import build_model
from sshslie_torch.ops import conv9
from sshslie_torch.ops.losses import total_loss
from sshslie_torch.train import LOSS_KEYS

OUTPUTS = ("R_low", "I_low", "I_delta", "S")
MAX_ATOL = {"R_low": 2.5e-4, "I_low": 2.5e-4, "I_delta": 1e-3, "S": 5e-4}
COEFFS = {
    "c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
    "c_loss_i_smooth_delta": 2000.0, "c_loss_fourier": 20.0, "c_loss_spectral_cons": 1.0,
    "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0,
}
VARIANTS = {
    "transformer": dict(channels=4, use_attention=False, conv_impl="torch"),
    "se": dict(channels=4, use_attention=True, conv_impl="torch"),
    "kernel_64": dict(channels=64, use_attention=False, conv_impl="kernel"),
}


@functools.cache
def _jax(variant, precision, hw=16, batch=1):
    """JAX model at ``precision``, its params (one init, seed 0), its input
    and outputs; and the port's state dict of those params."""
    v = VARIANTS[variant]
    jcfg = JaxConfig(channels=v["channels"], patch_size=hw, precision=precision,
                     attention_impl="xla", use_attention=v["use_attention"])
    jm = jax_build_model(jcfg, v["channels"])
    params = init_params(jm, 0, hw)
    x = np.random.RandomState(0).rand(batch, hw, hw, v["channels"]).astype(np.float32)
    outs = [np.asarray(o) for o in jm.apply({"params": params}, jnp.asarray(x))]
    sd = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    return jm, params, x, outs, sd


def _port(variant, precision, sd, **extra):
    v = VARIANTS[variant]
    cfg = load_config(None, dict(channels=v["channels"], precision=precision,
                                 attention_impl="dense", use_attention=v["use_attention"],
                                 conv_impl=v["conv_impl"], device="cpu", **extra))
    model = build_model(cfg, v["channels"], "cpu")
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_forward_matches_jax(variant):
    _, _, x, want, sd = _jax(variant, "bfloat16")
    _, _, _, want_f32, _ = _jax(variant, "float32")
    with torch.no_grad():
        got = [t.numpy() for t in _port(variant, "bfloat16", sd)(torch.from_numpy(x))]
        got_f32 = [t.numpy() for t in _port(variant, "float32", sd)(torch.from_numpy(x))]
    for name, a, b, b32 in zip(OUTPUTS, got, want, want_f32):
        assert a.dtype == np.float32 and b.dtype == np.float32, name
        err = np.abs(a - b)
        gap = np.abs(b - b32).mean()
        assert err.max() <= MAX_ATOL[name], f"{name}: max|d| {err.max():.3e}"
        assert err.mean() <= 0.6 * gap, f"{name}: mean|d| {err.mean():.3e} vs gap {gap:.3e}"
    assert np.abs(got[3] - got_f32[3]).max() >= 3e-4, "bfloat16 S equals float32 S: not bf16"


def test_bf16_loss_and_grads_match_jax():
    batch = np.random.default_rng(4).random((2, 16, 16, 4), dtype=np.float32) * 0.4 + 0.05
    jm, params, _, _, sd = _jax("transformer", "bfloat16")
    (_, want_terms), want = jax.jit(jax.value_and_grad(_make_loss_fn(jm, COEFFS), has_aux=True))(
        params, jnp.asarray(batch))
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want))
    grads = {}
    for precision in ("bfloat16", "float32"):
        model = _port("transformer", precision, sd).train()
        xb = torch.from_numpy(batch)
        outs = model.forward_with_redecomposition(xb)
        assert all(t.dtype == torch.float32 for t in outs)
        total, terms = total_loss(xb, *outs, COEFFS)
        total.backward()
        assert all(p.grad.dtype == torch.float32 for p in model.parameters())
        grads[precision] = np.concatenate([p.grad.numpy().ravel() for p in model.parameters()])
        if precision == "bfloat16":
            for k in LOSS_KEYS:
                np.testing.assert_allclose(float(terms[k].detach()), float(want_terms[k]), rtol=5e-3,
                                           err_msg=k)
    want = np.concatenate([want[n].numpy().ravel() for n, _ in model.named_parameters()])
    norm = np.linalg.norm(want)
    assert np.linalg.norm(grads["bfloat16"] - want) <= 0.1 * norm
    assert np.linalg.norm(grads["bfloat16"] - grads["float32"]) >= 0.01 * norm


def test_loss_inputs_are_float32_under_bf16():
    jm, params, x, _, sd = _jax("transformer", "bfloat16")
    from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet

    jouts = jm.apply({"params": params}, jnp.asarray(x),
                     method=JaxNet.forward_with_redecomposition)
    assert all(o.dtype == jnp.float32 for o in jouts)
    with torch.no_grad():
        outs = _port("transformer", "bfloat16", sd).forward_with_redecomposition(torch.from_numpy(x))
    assert [t.dtype for t in outs] == [torch.float32] * 5


def _conv_bf16_inputs(seed=7, shape=(1, 8, 128, 64), k=9):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray((rng.standard_normal((k, k, 64, 64)) * 0.05).astype(np.float32)).astype(jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)

    def to_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)

    return (x, w, dy), (to_torch(x), to_torch(w), to_torch(dy))


def test_conv9_plain_bf16_matches_pallas_interpret():
    (jx, jw, jdy), (x, w, dy) = _conv_bf16_inputs()
    want = np.asarray(jax_conv9_fwd(jx, jw, interpret=True).astype(jnp.float32))
    got = conv9.conv9_fwd(x, w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7 * np.abs(want).max(), rtol=0)
    want_dw = np.asarray(jax_conv9_wgrad(jx, jdy, 9, interpret=True))
    got_dw = conv9.conv9_wgrad(x, dy, 9)
    assert got_dw.dtype == torch.float32
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=1e-5 * np.abs(want_dw).max(), rtol=0)


def test_shallow_conv_bf16_gradients_reach_float32_parameters():
    (_, _, _), (x, w, dy) = _conv_bf16_inputs(shape=(1, 6, 10, 64))
    w32 = w.float().requires_grad_()
    b32 = torch.linspace(-0.1, 0.1, 64).requires_grad_()
    xb = x.clone().requires_grad_()
    seen = {}

    def keep(name):
        def hook(g):
            seen[name] = g.dtype
        return hook

    wb, bb = w32.to(torch.bfloat16), b32.to(torch.bfloat16)
    wb.register_hook(keep("w"))
    bb.register_hook(keep("b"))
    y = conv9.shallow_conv(xb, wb, bb)
    assert y.dtype == torch.bfloat16
    y.backward(dy)
    assert seen == {"w": torch.bfloat16, "b": torch.bfloat16} and xb.grad.dtype == torch.bfloat16
    assert w32.grad.dtype == b32.grad.dtype == torch.float32
    # dw: the float32 weight gradient rounded to bfloat16 once.
    want = conv9.conv9_wgrad_plain(x, dy, 9).to(torch.bfloat16).float()
    assert torch.equal(w32.grad, want)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_remat_matches_no_remat(precision):
    _, _, _, _, sd = _jax("transformer", "float32")
    batch = torch.from_numpy(np.random.default_rng(5).random((2, 16, 16, 4), dtype=np.float32))
    grads, outs = {}, {}
    for remat in (False, True):
        model = _port("transformer", precision, sd, remat=remat).train()
        assert model.remat is remat
        out = model.forward_with_redecomposition(batch)
        total_loss(batch, *out, COEFFS)[0].backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
        outs[remat] = [t.detach() for t in out]
        assert set(model.state_dict()) == set(sd)
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)
    assert grads[False].keys() == grads[True].keys()
    for n in grads[False]:
        assert torch.equal(grads[False][n], grads[True][n]), n
