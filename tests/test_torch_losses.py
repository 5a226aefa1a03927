"""sshslie_torch.ops.losses against sshslie_tpu.ops.losses on the CPU.

The same numpy draws of the model's five outputs (R_low, I_low, I_delta, S,
R_enh) and the input batch go through both; every term and the weighted
total are compared, and the gradient of the total with respect to all five
outputs (torch autograd against ``jax.grad``). Sizes: even (16x16), odd
(15x17) and mixed (16x13), with 6 and 64 bands; the stock config's weights
(c_loss_i_smooth_delta 2000, c_loss_fourier 20).

Tolerances, relative to each quantity's scale (float32 reductions over up to
2*15*17*64 values in another order, and another FFT library):
terms rtol 1e-5 (measured <= 3.2e-6); gradients 1e-5 of the gradient's
largest magnitude (measured <= 1.3e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.ops import losses as jl
from sshslie_torch.ops import losses as tl
from sshslie_torch.train import LOSS_KEYS

COEFFS = {
    "c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
    "c_loss_i_smooth_delta": 2000.0, "c_loss_fourier": 20.0, "c_loss_spectral_cons": 1.0,
    "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0,
}
RTOL = 1e-5
GRAD_REL = 1e-5
SHAPES = [(2, 16, 16, 6), (2, 15, 17, 6), (1, 16, 13, 64), (2, 15, 17, 64)]


def _outputs(shape, seed=0):
    """input, R_low, I_low, I_delta, S, R_enh as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    x = rng.random(shape, dtype=np.float32) * 0.5
    R = rng.random(shape, dtype=np.float32)
    I = rng.random((b, h, w, 1), dtype=np.float32)
    Id = rng.random((b, h, w, 1), dtype=np.float32) * 0.5
    S = R * Id + R * I
    R_enh = np.clip(R + 0.05 * rng.standard_normal(shape).astype(np.float32), 0, 1)
    return x, R, I, Id, S, R_enh


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_terms_and_total_match_jax(shape):
    arrs = _outputs(shape)
    jt, jterms = jax.jit(lambda *a: jl.total_loss(*a, COEFFS))(*map(jnp.asarray, arrs))
    tt, tterms = tl.total_loss(*map(torch.from_numpy, arrs), COEFFS)
    assert set(tterms) == set(LOSS_KEYS) == set(jterms)
    for k in LOSS_KEYS:
        assert tterms[k].dtype == torch.float32
        np.testing.assert_allclose(float(tterms[k]), float(jterms[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(tt), float(jt), rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_total_loss_gradients_match_jax(shape):
    x, *outs = _outputs(shape, seed=1)
    jgrads = jax.jit(jax.grad(lambda *o: jl.total_loss(jnp.asarray(x), *o, COEFFS)[0],
                              argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, outs))
    touts = [torch.from_numpy(a).requires_grad_() for a in outs]
    tgrads = torch.autograd.grad(tl.total_loss(torch.from_numpy(x), *touts, COEFFS)[0], touts)
    for name, a, b in zip(("R_low", "I_low", "I_delta", "S", "R_enh"), tgrads, jgrads):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) or 1.0
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_REL * scale, err_msg=name)


@pytest.mark.parametrize("fn", ["reconstruction", "structure", "smooth", "fourier", "spectral"])
def test_each_term_matches_jax_at_odd_size(fn):
    x, R, I, Id, S, R_enh = _outputs((2, 15, 17, 6), seed=2)
    calls = {
        "reconstruction": lambda m, a: [m.reconstruction_loss(a(R), a(I), a(x))],
        "structure": lambda m, a: list(m.structure_aware_loss(a(R), a(I), a(R_enh), alpha=1.0,
                                                              beta=0.5)),
        "smooth": lambda m, a: [m.smooth_loss(a(Id), a(R), alpha=10.0)],
        "fourier": lambda m, a: [m.fourier_spectrum_loss(a(x), a(S)),
                                 m.fourier_spectrum_loss(a(x), a(S), loss_type="l2")],
        "spectral": lambda m, a: [m.spectral_smoothness_loss(a(S)),
                                  m.spectral_smoothness_loss(a(S), loss_type="l2")],
    }[fn]
    for got, want in zip(calls(tl, torch.from_numpy), calls(jl, jnp.asarray)):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("h,w", [(16, 16), (15, 17), (128, 128), (7, 4)])
def test_halfplane_weights_equal_jax(h, w):
    np.testing.assert_array_equal(tl._halfplane_weights_np(h, w, 0.1),
                                  jl._halfplane_weights_np(h, w, 0.1))
    np.testing.assert_array_equal(tl._mask_np(h, w, 0.1), jl._mask_np(h, w, 0.1))


def test_fourier_half_plane_equals_full_grid_masked_sum():
    """The folded weights reproduce the reference's full fft2 masked sum (PARITY #11)."""
    x, *_rest, S, _ = _outputs((1, 15, 17, 6), seed=3)
    a, b = torch.from_numpy(x), torch.from_numpy(S)
    mask = torch.from_numpy(np.array(tl._mask_np(15, 17, 0.1)))[None, :, :, None]
    full = (mask * (torch.fft.fft2(a, dim=(1, 2)).abs()
                    - torch.fft.fft2(b, dim=(1, 2)).abs()).abs()).sum() / a.numel()
    np.testing.assert_allclose(float(tl.fourier_spectrum_loss(a, b)), float(full), rtol=RTOL)
