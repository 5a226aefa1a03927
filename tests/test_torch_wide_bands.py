"""SS-HSLIE at 224 input bands on the CPU: the port against the benchmark's
plain reference (``benchmark/reference/``, float32, no JAX), the wide shallow
conv's plain versions against ``F.conv2d``, ``ShallowConv`` at wide weights,
the dispatch of ``Conv2d`` and the count of the passes it sends to
``F.conv2d``, and the float32 entry's split at the 224-band cell's shape.

Tolerances, each from float32 sums taken in another order than the
reference's (no product is rounded below float32 on either side):

* the forward's five outputs: 1e-5 of max(1, their largest magnitude). R, I
  and S come through sigmoids of sums of up to 9*9*224 = 18,144 products;
* the six loss terms: 2e-5 relative (means over the batch of the outputs
  above, and an FFT);
* the gradients: 2e-3 of each leaf's scale (its largest gradient, or the
  median leaf's where that is larger). The L1 terms' signs flip where a
  difference is near nought, so a gradient carries rounding of the order of
  ~1e-3 of its scale on any float32 path (``benchmark/tests``' 64-band test
  holds the same);
* the plain convs against ``F.conv2d``: 2e-5 of the largest output (k*k
  matrix products of 224 or 64 terms each, summed tap by tap).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import inputs
from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model
from sshslie_torch.models.layers import Conv2d
from sshslie_torch.ops import conv9

BANDS = 224
# The Li et al. indoor recipe's loss weights (config_indoor_li_et_al_cv1.yml).
COEFFS = {"c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
          "c_loss_i_smooth_delta": 20.0, "c_loss_fourier": 0.2, "c_loss_spectral_cons": 1.0,
          "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0}


@pytest.fixture(autouse=True)
def _one_thread():
    # Small convolutions: one thread, not the pool's contention with other test workers.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _close(got, want, rel, what=""):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: max|d| {err:.3e} > {rel:.0e} x {scale:.3e}"


@pytest.fixture(scope="module")
def seeded():
    """Seeded weights (PyTorch's default envelope) and two 16 x 16 crops of
    synthetic 224-band counts, normalised as the loader does."""
    params = inputs.weights(23, BANDS, torch.device("cpu"))
    cubes = inputs.normalise(inputs.counts(23, 2, 2, 16, 16, BANDS, torch.device("cpu")))
    return params, cubes


# "kernel": the shallow conv on ShallowConv's passes (the plain versions on
# the CPU, the wide kernels on a card); "torch": on F.conv2d.
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_step_at_224_bands_equals_the_reference(seeded, impl):
    from sshslie_torch.models.enhance import LowLightEnhanceNet
    from sshslie_torch.ops.losses import total_loss

    params, cubes = seeded
    model = LowLightEnhanceNet(input_channels=BANDS, conv_impl=impl)
    model.load_state_dict(params, strict=True)
    shallow = model.decomposition_net.shallow_conv[0]
    assert shallow._use_kernel(cubes.permute(0, 3, 1, 2)) is (impl == "kernel")
    before = conv9.conv9_fwd.launches
    outs = model.forward_with_redecomposition(cubes)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    want = ref_model.Reference(leaves, BANDS).forward_with_redecomposition(cubes)
    for name, g, w in zip(("R", "I", "I_delta", "S", "R_enh"), outs, want):
        assert g.shape == w.shape
        _close(g.detach(), w.detach(), 1e-5, name)
    tot, terms = total_loss(cubes, *outs, COEFFS)
    tot.backward()
    rtot, rterms = ref_loss.total(cubes, *want, COEFFS)
    rtot.backward()
    for k in ref_loss.TERMS:
        assert float(terms[k].detach()) == pytest.approx(float(rterms[k].detach()), rel=2e-5,
                                                         abs=1e-9), k
    grads = dict(model.named_parameters())
    med = float(np.median([float(v.grad.abs().max()) for v in leaves.values()]))
    for k, leaf in leaves.items():
        scale = max(float(leaf.grad.abs().max()), med)
        assert float((grads[k].grad - leaf.grad).abs().max()) <= 2e-3 * scale, k
    assert grads["decomposition_net.shallow_conv.0.weight"].shape == (64, BANDS, 9, 9)
    # The CPU takes the plain versions: no kernel launch is counted.
    assert conv9.conv9_fwd.launches == before


@pytest.mark.parametrize("ci,co", [(224, 64), (64, 224), (96, 64)])
def test_plain_convs_match_torch_at_wide_channels(ci, co):
    g = torch.Generator().manual_seed(ci + co)
    x = torch.randn(2, 11, 13, ci, generator=g)
    w = torch.randn(9, 9, ci, co, generator=g) * 0.05
    dy = torch.randn(2, 11, 13, co, generator=g)
    xc = x.permute(0, 3, 1, 2).requires_grad_(True)
    wc = w.permute(3, 2, 0, 1).contiguous().requires_grad_(True)
    yc = F.conv2d(xc, wc, padding=4)
    yc.backward(dy.permute(0, 3, 1, 2))
    _close(conv9.conv9_plain(x, w), yc.detach().permute(0, 2, 3, 1), 2e-5, "forward")
    dx = conv9.conv9_plain(dy, conv9.conv9_dgrad_weights(w))
    assert dx.shape == x.shape
    _close(dx, xc.grad.permute(0, 2, 3, 1), 2e-5, "dgrad")
    dw = conv9.conv9_wgrad_plain(x, dy, 9)
    assert dw.shape == (9, 9, ci, co)
    _close(dw, wc.grad.permute(2, 3, 1, 0), 2e-5, "wgrad")


def test_shallow_conv_at_wide_weights_on_cpu():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 12, 10, BANDS, generator=g, requires_grad=True)
    w = (torch.randn(9, 9, BANDS, 64, generator=g) * 0.02).requires_grad_(True)
    b = torch.randn(64, generator=g, requires_grad=True)
    dy = torch.randn(2, 12, 10, 64, generator=g)
    before = (conv9.conv9_fwd.launches, conv9.conv9_wgrad.launches)
    y = conv9.shallow_conv(x, w, b)
    y.backward(dy)
    assert before == (conv9.conv9_fwd.launches, conv9.conv9_wgrad.launches)
    xr, wr, br = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    yr = F.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), br, padding=4)
    yr.backward(dy.permute(0, 3, 1, 2))
    _close(y.detach(), yr.detach().permute(0, 2, 3, 1), 2e-5, "y")
    for name, got, want in (("dx", x.grad, xr.grad), ("dw", w.grad, wr.grad), ("db", b.grad, br.grad)):
        assert got.shape == want.shape
        _close(got, want, 2e-5, name)


@pytest.mark.parametrize("bands,dtype,want", [
    (224, None, True),               # float32: the wide entries
    (96, None, True),
    (224, torch.bfloat16, False),    # no wide bfloat16 entry: F.conv2d
    (12, None, False),               # not a multiple of 32
])
def test_conv2d_dispatch_at_wide_bands(bands, dtype, want):
    conv = Conv2d(bands, 64, 9, impl="kernel")
    conv.compute_dtype = dtype
    x = torch.zeros(1, bands, 8, 8, dtype=dtype or torch.float32)
    assert conv._use_kernel(x) is want


def test_library_passes_count_the_shallow_conv_sent_to_torch():
    conv9.reset_counts()
    x = torch.rand(2, BANDS, 8, 6, requires_grad=True)
    key = (2, 8, 6, BANDS, 64)
    # 'auto' on the CPU: F.conv2d, counted with the passes its backward will run.
    Conv2d(BANDS, 64, 9, impl="auto")(x).sum().backward()
    assert conv9.library_passes == {(p, torch.float32, key): 1 for p in ("forward", "dgrad", "wgrad")}
    with torch.no_grad():
        Conv2d(BANDS, 64, 9, impl="auto")(x)
    assert conv9.library_passes[("forward", torch.float32, key)] == 2
    assert conv9.library_passes[("dgrad", torch.float32, key)] == 1
    # A conv that is not the shallow one ('torch') and a shallow conv on the
    # kernel's path count nothing.
    Conv2d(BANDS, 64, 3)(x)
    Conv2d(BANDS, 64, 9, impl="kernel")(x)
    assert sum(conv9.library_passes.values()) == 4
    conv9.reset_counts()
    assert conv9.library_passes == {}


def test_split_of_the_wide_float32_entry():
    h100 = (132, 3)
    # The 224-band cell (b8 x 128^2): the forward 224 -> 64 keeps whole
    # 64-channel units (Cin scales every unit alike, so it is no argument).
    assert conv9.conv9_f32_parts(8, 128, 128, 9, h100) == 1
    assert conv9.conv9_f32_load(8, 128, 128, 1, h100) == 8.0
    assert conv9.conv9_f32_load(8, 128, 128, 2, h100) > 8.0
    assert conv9.conv9_f32_load(8, 128, 128, 4, h100) > 8.0
    # The 64-channel answers are what they were.
    assert conv9.conv9_f32_parts(2, 128, 128, 9, h100) == 1
    assert conv9.conv9_f32_parts(1, 128, 128, 9, h100) == 4


def test_wide_wrappers_take_the_plain_versions_on_cpu():
    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 9, 7, BANDS, generator=g)
    w = torch.randn(3, 3, BANDS, 64, generator=g)
    dy = torch.randn(1, 9, 7, 64, generator=g)
    assert torch.equal(conv9.conv9_fwd(x, w), conv9.conv9_plain(x, w))
    assert torch.equal(conv9.conv9_wgrad(x, dy, 3), conv9.conv9_wgrad_plain(x, dy, 3))


def test_library_input_gradient_equals_the_plain_one():
    """The wide input gradient a card takes from cuDNN (``_library_dgrad``),
    here on the CPU's own conv, against the plain version, counted once."""
    conv9.reset_counts()
    g = torch.Generator().manual_seed(12)
    dy = torch.randn(2, 11, 13, 64, generator=g)
    w = torch.randn(9, 9, BANDS, 64, generator=g) * 0.05
    dx = conv9._library_dgrad(dy, w, (2, 11, 13, BANDS))
    assert dx.shape == (2, 11, 13, BANDS)
    _close(dx, conv9.conv9_plain(dy, conv9.conv9_dgrad_weights(w)), 2e-5, "dgrad")
    assert conv9.library_passes == {("dgrad", torch.float32, (2, 11, 13, BANDS, 64)): 1}
    conv9.reset_counts()
