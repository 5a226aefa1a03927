"""The CUDA kernels against their plain versions on the card.

Every test here needs a CUDA card and nvcc, carries the ``cuda`` marker and
skips without one. The file imports only torch, numpy and the port, so it
runs on a machine without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Tolerances: conv9 5e-5 absolute at outputs of order 10 (float32 sums of up
to 5184 products in another order; chip_smoke.py measured 4.8e-6 at 512^2
and 1.6e-5 at 37x53); flash 1e-5 absolute (exp2 with a folded scale against
exp; chip_smoke.py measured up to 5.7e-7). conv9_wgrad: 2e-5 of the largest |dw|
(float32 sums over B*H*W pixels, split into slices, in another order than
the plain version's matrix products). Gradients of the autograd Functions
against autograd through the plain versions: 2e-5 of each gradient's
largest magnitude.

The bfloat16 entries (tensor-core kernels), at the main path's shapes and
at ragged shapes for k = 3, 9 and 13, against the plain versions on the
same bfloat16 operands: conv9 and its dgrad within one bfloat16 step
of the largest output, 2^-7 of it (both sum in float32 and round once; the
sums' order differs, so a value near a rounding boundary may round the other
way); conv9_wgrad, whose output is float32, within 2e-5 of the largest |dw|;
flash, which carries p as a bfloat16 pair hi + lo (the Pallas kernel's
float32 p to ~2^-17), within one bfloat16 step of the largest |o| of
``sdpa_chunked`` on the operands widened to float32 (chip_smoke.py measured
4.9e-4 at max|o| 0.28 and 2.4e-4 at 0.12, a third of a step), and within that
plus 2^-9 of the largest |v| of the plain ``sdpa_chunked`` on the bfloat16
operands, which rounds p to bfloat16 before P V (measured 9.8e-4 and 4.9e-4).
Mixed dtypes raise; repeats are bit-identical.
"""

import numpy as np
import pytest
import torch

from sshslie_torch.ops import attention, conv9


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_inputs(seed, shape, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, 64, 64)) * 0.05).astype(np.float32)
    return x, w


def _rel_close(got, want, rel, what=""):
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: max|d| {err:.3e} > {rel:.0e} x {scale:.3e}"


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((1, 64, 96, 64), 9), ((2, 37, 53, 64), 9), ((1, 19, 70, 64), 3)])
def test_conv9_kernel_matches_plain_on_card(cuda_device, shape, k):
    x, w = _conv_inputs(9, shape, k)
    x, w = torch.from_numpy(x).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    before = conv9.conv9_fwd.launches
    got = conv9.conv9_fwd(x, w)
    torch.cuda.synchronize()
    assert conv9.conv9_fwd.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), conv9.conv9_plain(x, w).cpu().numpy(), atol=5e-5)


@pytest.mark.cuda
def test_conv9_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 8, 64, device=cuda_device)
    with pytest.raises(ValueError):
        conv9.conv9_fwd(x, torch.zeros(4, 4, 64, 64, device=cuda_device))
    with pytest.raises(ValueError):
        conv9.conv9_fwd(x.double(), torch.zeros(3, 3, 64, 64, device=cuda_device).double())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 4096, 16), (1, 4, 4100, 16), (2, 3, 100, 32),
                                   (1, 2, 3, 64),
                                   # fewer keys than the 8 lanes that split a row's keys
                                   (1, 1, 1, 16), (1, 1, 2, 16), (1, 1, 3, 16),
                                   # a ragged last 128-key tile; the 1024^2 cube's S
                                   (1, 4, 4097, 16), (1, 4, 16384, 16),
                                   # the other head dims at the main path's S; B*H = 8
                                   (1, 2, 4100, 32), (1, 2, 4100, 64), (2, 4, 300, 16)])
def test_flash_kernel_matches_plain_on_card(cuda_device, shape):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(5, shape))
    before = attention.flash_attention.launches
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), attention.sdpa_chunked(q, k, v).cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 4100, 16), (1, 2, 300, 32), (1, 2, 300, 64)])
def test_flash_kernel_is_deterministic_on_card(cuda_device, shape):
    # No atomics, sums in a fixed order: two calls give the same bits.
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(8, shape))
    assert torch.equal(attention.flash_attention(q, k, v), attention.flash_attention(q, k, v))


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 1, 8, 24, device=cuda_device)   # head dim 24 is not built
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((2, 128, 128, 64), 9), ((1, 37, 53, 64), 9),
                                     ((2, 19, 70, 64), 3), ((1, 5, 9, 64), 13)])
def test_conv9_wgrad_kernel_matches_plain_on_card(cuda_device, shape, k):
    rng = np.random.default_rng(11)
    x, dy = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
             for _ in range(2))
    before = conv9.conv9_wgrad.launches
    got = conv9.conv9_wgrad(x, dy, k)
    torch.cuda.synchronize()
    assert conv9.conv9_wgrad.launches == before + 1
    _rel_close(got, conv9.conv9_wgrad_plain(x, dy, k), 2e-5, f"wgrad {shape} k{k}")
    # Deterministic: the partials are summed in a fixed order.
    assert torch.equal(got, conv9.conv9_wgrad(x, dy, k))


@pytest.mark.cuda
def test_conv9_wgrad_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 8, 64, device=cuda_device)
    with pytest.raises(ValueError):
        conv9.conv9_wgrad(x, torch.zeros(1, 8, 9, 64, device=cuda_device), 9)   # shapes differ
    with pytest.raises(ValueError):
        conv9.conv9_wgrad(x, x, 4)                                               # even k
    with pytest.raises(ValueError):
        conv9.conv9_wgrad(x.double(), x.double(), 9)
    with pytest.raises(ValueError):
        conv9.conv9_wgrad(x, x.transpose(1, 2), 9)                               # not contiguous


@pytest.mark.cuda
def test_shallow_conv_grads_on_card_match_plain_autograd(cuda_device):
    x, w = _conv_inputs(13, (2, 32, 48, 64), 9)
    rng = np.random.default_rng(14)
    b = rng.standard_normal(64).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((2, 32, 48, 64)).astype(np.float32)).to(cuda_device)

    def grads(fn):
        xs, ws, bs = (torch.from_numpy(a).to(cuda_device).requires_grad_() for a in (x, w, b))
        return torch.autograd.grad(fn(xs, ws, bs), (xs, ws, bs), g)

    before = (conv9.conv9_fwd.launches, conv9.conv9_wgrad.launches)
    got = grads(conv9.shallow_conv)
    torch.cuda.synchronize()
    # forward + dgrad on the conv9 kernel, dw on the wgrad kernel
    assert (conv9.conv9_fwd.launches, conv9.conv9_wgrad.launches) == (before[0] + 2, before[1] + 1)
    shape = (torch.float32, (2, 32, 48, 64))
    assert conv9.conv9_fwd.launches_by_shape[("forward", *shape)] >= 1
    assert conv9.conv9_fwd.launches_by_shape[("dgrad", *shape)] >= 1
    assert conv9.conv9_wgrad.launches_by_shape[("wgrad", *shape)] >= 1
    want = grads(lambda xs, ws, bs: conv9.conv9_plain(xs, ws) + bs)
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        _rel_close(a, c, 2e-5, name)


@pytest.mark.cuda
def test_flash_attention_grads_on_card_match_chunked_autograd(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(15, (1, 4, 600, 16)))
    g = torch.from_numpy(_qkv(16, (1, 4, 600, 16))[0]).to(cuda_device)

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*ts), ts, g)

    got = grads(attention.flash_attention)
    want = grads(attention.sdpa_chunked)
    for name, a, c in zip(("dq", "dk", "dv"), got, want):
        _rel_close(a, c, 2e-5, name)


@pytest.mark.cuda
def test_kernel_outputs_carry_grad_fn(cuda_device):
    x = torch.randn(1, 8, 8, 64, device=cuda_device, requires_grad=True)
    w = torch.randn(9, 9, 64, 64, device=cuda_device)
    b = torch.zeros(64, device=cuda_device)
    assert conv9.shallow_conv(x, w, b).grad_fn is not None
    with pytest.raises(RuntimeError, match="not differentiable"):
        conv9.conv9_fwd(x, w)
    q = torch.randn(1, 1, 64, 16, device=cuda_device, requires_grad=True)
    assert attention.flash_attention(q, q.detach(), q.detach()).grad_fn is not None


BF16_STEP = 2.0 ** -7    # one bfloat16 step of a value's magnitude, at most


def _bf16(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(torch.bfloat16)


# The main path's shapes at k = 9; ragged tiles (H, W not multiples of the
# 8 x 64 output tile) at k = 3, 9 and 13; an image smaller than the k = 13
# halo.
CONV_BF16_CASES = [((1, 512, 512, 64), 9), ((8, 128, 128, 64), 9), ((1, 37, 53, 64), 9),
                   ((1, 37, 53, 64), 3), ((1, 37, 53, 64), 13), ((3, 19, 70, 64), 3),
                   ((3, 19, 70, 64), 9), ((3, 19, 70, 64), 13), ((2, 5, 9, 64), 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", CONV_BF16_CASES)
def test_conv9_bf16_kernel_matches_plain_on_card(cuda_device, shape, k):
    x, w = _bf16(21, shape).to(cuda_device), _bf16(22, (k, k, 64, 64), 0.05).to(cuda_device)
    before = conv9.conv9_fwd.launches_by_dtype[torch.bfloat16]
    got = conv9.conv9_fwd(x, w)
    torch.cuda.synchronize()
    assert conv9.conv9_fwd.launches_by_dtype[torch.bfloat16] == before + 1
    assert got.dtype == torch.bfloat16
    _rel_close(got.float(), conv9.conv9_plain(x, w).float(), BF16_STEP, f"conv9 bf16 {shape} k{k}")
    # dgrad: the same entry with the reversed, transposed weights
    wd = conv9.conv9_dgrad_weights(w)
    _rel_close(conv9.conv9_fwd(x, wd).float(), conv9.conv9_plain(x, wd).float(), BF16_STEP, "dgrad")
    assert torch.equal(got, conv9.conv9_fwd(x, w))


# The main path's shape; ragged segments (W not a multiple of the 64-pixel
# segment) at k = 3, 9 and 13; B*H = 2 rows, fewer than the one-wave split
# count, and an image smaller than the k = 13 halo, where most kernel rows
# find only padding.
WGRAD_BF16_CASES = [((8, 128, 128, 64), 9), ((1, 37, 53, 64), 9), ((1, 37, 53, 64), 3),
                    ((1, 37, 53, 64), 13), ((3, 19, 70, 64), 3), ((3, 19, 70, 64), 9),
                    ((3, 19, 70, 64), 13), ((1, 2, 40, 64), 9), ((2, 5, 9, 64), 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", WGRAD_BF16_CASES)
def test_conv9_wgrad_bf16_kernel_matches_plain_on_card(cuda_device, shape, k):
    x, dy = _bf16(23, shape).to(cuda_device), _bf16(24, shape).to(cuda_device)
    before = conv9.conv9_wgrad.launches_by_dtype[torch.bfloat16]
    got = conv9.conv9_wgrad(x, dy, k)
    torch.cuda.synchronize()
    assert conv9.conv9_wgrad.launches_by_dtype[torch.bfloat16] == before + 1
    assert got.dtype == torch.float32
    _rel_close(got, conv9.conv9_wgrad_plain(x, dy, k), 2e-5, f"wgrad bf16 {shape} k{k}")
    assert torch.equal(got, conv9.conv9_wgrad(x, dy, k))


# The float32 cases' edges: fewer keys than a row's 16-key mma step (1, 2,
# 3), ragged last 128-key stages (4097, 4100), the 1024^2 cube's S, B*H = 8,
# and the other head dims at the main path's S.
FLASH_BF16_CASES = [(1, 4, 4096, 16), (1, 4, 4100, 16), (1, 1, 1, 16), (1, 1, 2, 16), (1, 1, 3, 16),
                    (1, 4, 4097, 16), (1, 4, 16384, 16), (2, 4, 300, 16), (1, 2, 300, 32),
                    (1, 2, 300, 64), (1, 2, 4100, 32), (1, 2, 4100, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_BF16_CASES)
def test_flash_bf16_kernel_matches_plain_on_card(cuda_device, shape):
    q, k, v = (_bf16(30 + i, shape).to(cuda_device) for i in range(3))
    before = attention.flash_attention.launches_by_dtype[torch.bfloat16]
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches_by_dtype[torch.bfloat16] == before + 1
    assert got.dtype == torch.bfloat16
    vmax = float(v.float().abs().max())
    # The plain version rounds p to bfloat16 before P V.
    want = attention.sdpa_chunked(q, k, v).float()
    tol = BF16_STEP * float(want.abs().max()) + 2.0 ** -9 * vmax
    err = float((got.float() - want).abs().max())
    assert err <= tol, f"flash bf16 {shape} vs plain: max|d| {err:.3e} > {tol:.3e}"
    # The Pallas kernel's float32 p: sdpa_chunked on the operands widened to float32.
    want32 = attention.sdpa_chunked(q.float(), k.float(), v.float())
    tol = BF16_STEP * float(want32.abs().max())
    err = float((got.float() - want32).abs().max())
    assert err <= tol, f"flash bf16 {shape} vs float32 p: max|d| {err:.3e} > {tol:.3e}"
    assert torch.equal(got, attention.flash_attention(q, k, v))


@pytest.mark.cuda
def test_kernels_refuse_mixed_dtypes(cuda_device):
    x32 = torch.zeros(1, 8, 8, 64, device=cuda_device)
    x16 = x32.to(torch.bfloat16)
    w32 = torch.zeros(9, 9, 64, 64, device=cuda_device)
    for x, w in ((x32, w32.to(torch.bfloat16)), (x16, w32)):
        with pytest.raises(ValueError, match="all-float32 or all-bfloat16"):
            conv9.conv9_fwd(x, w)
    with pytest.raises(ValueError, match="all-float32 or all-bfloat16"):
        conv9.conv9_wgrad(x16, x32, 9)
    q = torch.zeros(1, 1, 8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="all-float32 or all-bfloat16"):
        attention.flash_attention(q.to(torch.bfloat16), q, q)
    with pytest.raises(ValueError):
        attention.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.cuda
def test_shallow_conv_bf16_grads_on_card_match_plain_passes(cuda_device):
    x, w, g = _bf16(40, (8, 32, 48, 64)), _bf16(41, (9, 9, 64, 64), 0.05), _bf16(42, (8, 32, 48, 64))
    b = _bf16(43, (64,), 0.1)

    def grads(dev):
        ts = [t.to(dev).requires_grad_() for t in (x, w, b)]
        return [t.float().cpu() for t in torch.autograd.grad(conv9.shallow_conv(*ts), ts, g.to(dev))]

    got, want = grads(cuda_device), grads("cpu")     # the CPU takes the plain passes
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        _rel_close(a, c, BF16_STEP, name)
