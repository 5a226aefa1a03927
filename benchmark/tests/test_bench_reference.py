"""The plain reference against the port's plain CPU path at a tiny size: the
forward with its re-decomposition, the six loss terms, the gradients and one
Adam step; the crops and their draws; the controls' rounding."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model
from benchmark.reference import precision
from benchmark.reference import train as ref_train

COEFFS = {"c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
          "c_loss_i_smooth_delta": 2000.0, "c_loss_fourier": 20.0, "c_loss_spectral_cons": 1.0,
          "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0}
BANDS = 64


@pytest.fixture(scope="module")
def setup():
    from sshslie_torch.models.enhance import LowLightEnhanceNet

    torch.manual_seed(0)
    params = inputs.weights(11, BANDS, torch.device("cpu"))
    model = LowLightEnhanceNet(input_channels=BANDS, conv_impl="torch")
    model.load_state_dict(params, strict=True)
    cubes = inputs.normalise(inputs.counts(11, 2, 2, 32, 40, BANDS, torch.device("cpu")))
    return params, model, cubes


def test_weights_cover_the_ports_state_dict(setup):
    params, model, _ = setup
    assert list(params) == list(model.state_dict())
    for (name, (shape, fan_in)) in ref_model.param_shapes(BANDS).items():
        assert tuple(params[name].shape) == shape
        assert float(params[name].abs().max()) <= fan_in ** -0.5


def test_counts_are_low_light_12_bit():
    c = inputs.counts(3, 2, 2, 48, 40, BANDS, torch.device("cpu"))
    assert c.shape == (2, 48, 40, BANDS)
    assert float(c.min()) >= 238 and float(c.max()) <= 4095
    assert torch.equal(c, c.round()) and float(c.mean()) < 1000
    assert torch.equal(c, inputs.counts(3, 2, 2, 48, 40, BANDS, torch.device("cpu")))


def test_forward_equals_the_port(setup):
    params, model, cubes = setup
    with torch.no_grad():
        got = model.forward_with_redecomposition(cubes)
        want = ref_model.Reference(params, BANDS).forward_with_redecomposition(cubes)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * max(1.0, float(w.abs().max()))


def test_loss_terms_and_gradients_equal_the_port(setup):
    from sshslie_torch.ops.losses import total_loss

    params, model, cubes = setup
    model.zero_grad()
    tot, terms = total_loss(cubes, *model.forward_with_redecomposition(cubes), COEFFS)
    tot.backward()
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    rtot, rterms = ref_loss.total(
        cubes, *ref_model.Reference(leaves, BANDS).forward_with_redecomposition(cubes), COEFFS)
    rtot.backward()
    for k in ref_loss.TERMS:
        assert float(terms[k].detach()) == pytest.approx(float(rterms[k].detach()), rel=2e-5, abs=1e-9)
    grads = dict(model.named_parameters())
    # A leaf's scale: its own largest gradient, or the median leaf's where that
    # is larger (the key bias's gradient is nought to rounding under softmax).
    med = float(np.median([float(v.grad.abs().max()) for v in leaves.values()]))
    for k, leaf in leaves.items():
        scale = max(float(leaf.grad.abs().max()), med)
        assert float((grads[k].grad - leaf.grad).abs().max()) <= 2e-3 * scale, k


def test_adam_equals_the_ports(setup):
    from sshslie_torch.train import make_optimizer

    params, _, _ = setup
    a = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    b = [v.clone() for v in params.values()]
    port = make_optimizer(torch.nn.ParameterList([torch.nn.Parameter(v) for v in a.values()]),
                          1e-3)
    ref = ref_train.Adam(b)
    g = torch.Generator().manual_seed(5)
    for _ in range(3):
        grads = [torch.randn(v.shape, generator=g) * 1e-3 for v in b]
        for p, gr in zip(port.param_groups[0]["params"], grads):
            p.grad = gr.clone()
        port.step()
        ref.step(grads, 1e-3)
    for p, q in zip(port.param_groups[0]["params"], b):
        assert float((p.detach() - q).abs().max()) <= 1e-7


def test_crops_equal_the_fused_pipeline(setup):
    from sshslie_torch.train import fused_draws, sample_fused_batch

    _, _, cubes = setup
    stack = torch.cat([cubes, cubes.flip(1)])
    for seed in (0, 2 ** 31 + 3):
        table = ref_train.draws(seed, 4, 2, 2, (32, 40), 16)
        assert np.array_equal(table, fused_draws(seed, 4, 2, 2, (32, 40), 16))
        for b in range(2):
            got = sample_fused_batch(stack, torch.from_numpy(table[b]), 2 * b, 16)
            assert torch.equal(got, ref_train.batch(stack, table[b], 2 * b, 16))


def test_served_path_equals_the_ports_decode(setup):
    from sshslie_torch.utils.io_hsi import normalize_like_load_torch

    counts = inputs.counts(8, 2, 1, 32, 32, BANDS, torch.device("cpu"))[0]
    want = normalize_like_load_torch(counts, "global_normalization", 4095.0, 238.0)
    assert torch.equal(ref_train.normalise(counts, 238.0, 4095.0), want)


def test_roundings():
    from sshslie_torch.ops.conv9 import round_to_tf32

    x = torch.randn(4096, generator=torch.Generator().manual_seed(1)) * 3
    assert torch.equal(precision.rounded(x, "tf32"), round_to_tf32(x))
    f8 = precision.rounded(x, "fp8")
    assert torch.equal(f8, x.to(torch.float8_e4m3fn).float())
    assert precision.rounded(x, None) is x
    y = x.clone().requires_grad_(True)
    precision.rounded(y, "fp8").sum().backward()
    assert torch.equal(y.grad, torch.ones_like(x))
