"""sshslie_torch.ops.conv9: the plain versions and the ShallowConv autograd
Function against the JAX Pallas kernels (interpret mode, as
tests/test_conv_pallas.py runs them) and the shape gate. The CUDA kernels
are held against the plain versions on the card in
tests/test_torch_kernels_cuda.py.

Tolerances: forward, float32 sums of k*k*64 products in another order;
measured max|d| 1.4e-6 (k = 3) and 5.0e-6 (k = 9) on these inputs, held at
2e-5 and 5e-5. Gradients and the weight gradient: 1e-5 of each result's
largest magnitude (sums over up to 1024 pixels in another order); measured
ShallowConv dx/dw/db <= 1.1e-6 of scale, conv9_wgrad_plain <= 5.6e-7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.ops.conv_pallas import _dgrad_weights
from sshslie_tpu.ops.conv_pallas import conv9_fwd as jax_conv9_fwd
from sshslie_tpu.ops.conv_pallas import conv9_wgrad as jax_conv9_wgrad
from sshslie_tpu.ops.conv_pallas import pallas_shallow_conv
from sshslie_torch.models.layers import Conv2d
from sshslie_torch.ops import conv9


def _inputs(seed, shape, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, 64, 64)) * 0.05).astype(np.float32)
    return x, w


@pytest.mark.parametrize("k,atol", [(3, 2e-5), (9, 5e-5)])
def test_plain_matches_pallas_interpret(k, atol):
    x, w = _inputs(7, (1, 8, 128, 64), k)
    want = np.asarray(jax_conv9_fwd(jnp.asarray(x), jnp.asarray(w), interpret=True))
    before = conv9.conv9_fwd.launches
    got = conv9.conv9_fwd(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=atol)
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert conv9.conv9_fwd.launches == before
    np.testing.assert_array_equal(got, conv9.conv9_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy())


def test_plain_matches_torch_conv_at_odd_sizes():
    x, w = _inputs(8, (2, 13, 21, 64), 9)
    want = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                      torch.from_numpy(w).permute(3, 2, 0, 1), padding=4)
    got = conv9.conv9_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), atol=5e-5)


def test_gate():
    assert conv9.conv9_supported((1, 512, 512, 64), 9, 64, 64)
    assert conv9.conv9_supported((2, 37, 53, 64), 3, 64, 64)   # any H, W: no 128-lane rule
    assert not conv9.conv9_supported((1, 8, 128, 64), 9, 64, 64, stride=2)
    assert not conv9.conv9_supported((1, 8, 128, 64), 4, 64, 64)    # even k
    assert not conv9.conv9_supported((1, 8, 128, 64), 1, 64, 64)    # k < 3
    assert not conv9.conv9_supported((1, 8, 128, 64), 15, 64, 64)   # past the kernel's k
    # 224-band data: the wide float32 entries take it; bfloat16 and TF32 have none.
    assert conv9.conv9_supported((1, 8, 128, 224), 9, 224, 64)
    assert conv9.conv9_supported((1, 8, 128, 224), 9, 224, 64, dtype=torch.float32)
    assert not conv9.conv9_supported((1, 8, 128, 224), 9, 224, 64, dtype=torch.bfloat16)
    assert not conv9.conv9_supported((1, 8, 128, 224), 9, 224, 64, dtype=conv9.TF32)
    assert not conv9.conv9_supported((1, 8, 128, 12), 9, 12, 64)    # 12 bands: not a multiple of 32
    assert not conv9.conv9_supported((1, 8, 128, 288), 9, 288, 64)  # past 256
    assert not conv9.conv9_supported((1, 8, 128, 224), 9, 224, 64, stride=2)
    assert not conv9.conv9_supported((1, 8, 128, 64), 9, 224, 64)   # x's channels are not Cin
    # The 64 -> 64 answers take any dtype, as before.
    assert conv9.conv9_supported((1, 8, 128, 64), 9, 64, 64, dtype=torch.bfloat16)
    assert conv9.conv9_supported((1, 8, 128, 64), 9, 64, 64, dtype=conv9.TF32)
    assert not conv9.conv9_supported((1, 8, 128, 64), 9, 64, 32)
    assert not conv9.conv9_supported((1, 8, 128, 64), 9, 64, 224)   # the wide weight gradient takes 64 out
    assert not conv9.conv9_supported((8, 128, 64), 9, 64, 64)       # rank 3


@pytest.mark.parametrize("impl,shape,want", [
    ("kernel", (1, 64, 8, 8), True),
    ("kernel", (1, 12, 8, 8), False),   # 12 bands: F.conv2d
    ("torch", (1, 64, 8, 8), False),
    ("auto", (1, 64, 8, 8), False),     # 'auto' means the kernel on CUDA only
])
def test_conv2d_dispatch(impl, shape, want):
    conv = Conv2d(shape[1], 64, 9, impl=impl)
    assert conv._use_kernel(torch.zeros(shape)) is want
    assert Conv2d(64, 64, 3, stride=2, impl="kernel")._use_kernel(torch.zeros(1, 64, 8, 8)) is False


def test_conv2d_kernel_impl_on_cpu_matches_torch_impl(rng):
    x = torch.from_numpy(rng.randn(1, 64, 11, 14).astype(np.float32))
    a = Conv2d(64, 64, 9, impl="kernel", generator=torch.Generator().manual_seed(0))
    b = Conv2d(64, 64, 9, impl="torch", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(a(x).numpy(), b(x).numpy(), atol=2e-5)


GRAD_REL = 1e-5


def _assert_rel_close(got, want, rel, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("k", [3, 9])
def test_shallow_conv_grads_match_pallas_vjp(k):
    """dx, dw, db of sum(sin(conv(x, w) + b)), the loss of tests/test_conv_pallas.py."""
    x, w = _inputs(21, (1, 8, 128, 64), k)
    b = np.random.default_rng(22).standard_normal(64).astype(np.float32)
    want = jax.grad(lambda x_, w_, b_: jnp.sum(jnp.sin(pallas_shallow_conv(x_, w_, b_, True))),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = torch.autograd.grad(torch.sin(conv9.shallow_conv(*ts)).sum(), ts)
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        _assert_rel_close(a.numpy(), c, GRAD_REL, name)


def test_wgrad_plain_matches_pallas_interpret_and_autograd():
    x, _ = _inputs(23, (2, 4, 128, 64), 3)
    dy = np.random.default_rng(24).standard_normal(x.shape).astype(np.float32)
    for k in (3, 9):
        got = conv9.conv9_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy), k)
        assert got.shape == (k, k, 64, 64)
        want = jax_conv9_wgrad(jnp.asarray(x), jnp.asarray(dy), k, interpret=True)
        _assert_rel_close(got.numpy(), want, GRAD_REL, f"k={k} vs Pallas")
        w = torch.zeros(64, 64, k, k, requires_grad=True)
        y = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, padding=k // 2)
        (dw,) = torch.autograd.grad(y, w, torch.from_numpy(dy).permute(0, 3, 1, 2))
        _assert_rel_close(got.numpy(), dw.permute(2, 3, 1, 0).numpy(), GRAD_REL, f"k={k} vs autograd")
        # On a CPU tensor the wrapper is the plain version and counts no launch.
        before = conv9.conv9_wgrad.launches
        np.testing.assert_array_equal(
            conv9.conv9_wgrad(torch.from_numpy(x), torch.from_numpy(dy), k).numpy(), got.numpy())
        assert conv9.conv9_wgrad.launches == before


@pytest.mark.parametrize("k", [3, 9])
def test_dgrad_weights_equal_jax(k):
    _, w = _inputs(25, (1, 1, 1, 64), k)
    got = conv9.conv9_dgrad_weights(torch.from_numpy(w))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(_dgrad_weights(jnp.asarray(w))))


def test_no_input_grad_skips_the_dgrad_pass(monkeypatch):
    calls = []
    real = conv9.conv9_fwd
    monkeypatch.setattr(conv9, "conv9_fwd",
                        lambda x, w, *tf32: calls.append(x.shape) or real(x, w, *tf32))
    x, w = _inputs(26, (1, 6, 10, 64), 9)
    x = torch.from_numpy(x)                     # a batch: no gradient wanted
    w = torch.from_numpy(w).requires_grad_()
    b = torch.zeros(64, requires_grad=True)
    conv9.shallow_conv(x, w, b).sum().backward()
    assert len(calls) == 1                      # the forward only
    assert w.grad is not None and b.grad is not None
    conv9.shallow_conv(x.requires_grad_(), w, b).sum().backward()
    assert len(calls) == 3                      # forward and dgrad
    assert x.grad is not None


def test_raw_wrappers_refuse_to_drop_gradients():
    x, w = _inputs(27, (1, 4, 4, 64), 3)
    with pytest.raises(RuntimeError, match="not differentiable"):
        conv9.conv9_fwd(torch.from_numpy(x).requires_grad_(), torch.from_numpy(w))
    with pytest.raises(RuntimeError, match="not differentiable"):
        conv9.conv9_wgrad(torch.from_numpy(x).requires_grad_(), torch.from_numpy(x), 3)
    with torch.no_grad():
        conv9.conv9_fwd(torch.from_numpy(x).requires_grad_(), torch.from_numpy(w))


# The bfloat16 weight-gradient kernel's split plan (csrc/conv9_wgrad.cu):
# the wrapper's slice count, and the slices' row ranges as the kernel
# computes them, rows * s // splits .. rows * (s + 1) // splits.

@pytest.mark.parametrize("k", conv9.KERNEL_SIZES)
def test_wgrad_bf16_split_plan_fills_one_wave(k):
    taps = conv9.conv9_wgrad_bf16_taps(k)
    groups = -(-k // taps)
    if k <= 9:
        assert (taps, groups) == (k, 1)             # a block owns the whole kernel row
    else:
        assert (taps, groups) == ((k + 1) // 2, 2)  # half of it
    per_slice = k * groups                      # blocks of one slice: (kernel row, tap group)
    for rows, resident in ((1024, 132), (2, 132), (37, 264), (1, 9), (5000, 396), (500, 5)):
        splits = conv9.conv9_wgrad_bf16_splits(rows, k, resident)
        assert 1 <= splits <= rows
        if resident >= per_slice:
            assert splits * per_slice <= resident                          # one wave
            assert splits == rows or (splits + 1) * per_slice > resident   # as many as fit
        else:
            assert splits == 1


@pytest.mark.parametrize("shape,k", [((2, 5, 9, 64), 3), ((1, 7, 11, 64), 9), ((3, 4, 6, 64), 13)])
def test_wgrad_bf16_slices_sum_to_the_weight_gradient(shape, k):
    """Partials over the kernel's row slices, summed in slice order, give
    conv9_wgrad_plain: every image row falls in exactly one slice."""
    rng = np.random.default_rng(28)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rows = shape[0] * shape[1]
    splits = conv9.conv9_wgrad_bf16_splits(rows, k, resident=132)
    owner = torch.full((rows,), -1)
    total = torch.zeros(k, k, 64, 64)
    for s in range(splits):
        r0, r1 = rows * s // splits, rows * (s + 1) // splits
        assert (owner[r0:r1] == -1).all()
        owner[r0:r1] = s
        mask = torch.zeros(rows)
        mask[r0:r1] = 1.0
        total += conv9.conv9_wgrad_plain(x, dy * mask.view(shape[0], shape[1], 1, 1), k)
    assert (owner >= 0).all()
    _assert_rel_close(total.numpy(), conv9.conv9_wgrad_plain(x, dy, k).numpy(), GRAD_REL, f"k={k}")


# The float32 entry's units (csrc/conv9.cu, conv_c64_f32_kernel): block u is
# the unit (part, tile column, tile row, batch), the part fastest, of a 4 x 32
# pixel tile and 64 / parts output channels. The shapes are the kernel
# table's float32 conv9 rows and one ragged shape.

F32_SHAPES = [(1, 512, 512), (2, 512, 512), (4, 512, 512), (1, 1024, 1024), (2, 128, 128),
              (1, 128, 128), (2, 72, 128), (1, 264, 512), (1, 37, 53)]


@pytest.mark.parametrize("resident", [(132, 1), (132, 2), (114, 2)])
@pytest.mark.parametrize("b,h,w", F32_SHAPES)
def test_f32_units_cover_every_output_once_and_fill_the_card(b, h, w, resident):
    parts = conv9.conv9_f32_parts(b, h, w, 9, resident)
    assert parts in conv9.F32_PARTS
    th, tw = conv9.F32_TILE
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    units = conv9.conv9_f32_units(b, h, w, parts)
    assert units == b * tiles_h * tiles_w * parts
    cover = np.zeros((parts, b, tiles_h * th, tiles_w * tw), np.int32)
    for u in range(units):
        part, rest = u % parts, u // parts
        w0, rest = (rest % tiles_w) * tw, rest // tiles_w
        h0, bb = (rest % tiles_h) * th, rest // tiles_h
        cover[part, bb, h0:h0 + th, w0:w0 + tw] += 1
    # Every pixel once in each part, and the parts' channel ranges tile 0..63 once.
    assert (cover[:, :, :h, :w] == 1).all() and cover.sum() == units * th * tw
    co = np.zeros(64, np.int32)
    for part in range(parts):
        co[part * 64 // parts:(part + 1) * 64 // parts] += 1
    assert (co == 1).all()
    # The choice has the least load; where it leaves an SM idle, no finer
    # split would lower the busiest SM's load.
    loads = {p: conv9.conv9_f32_load(b, h, w, p, resident) for p in conv9.F32_PARTS}
    assert loads[parts] <= min(loads.values()) + 1e-9
    if units < resident[0]:
        assert all(loads[p] >= loads[parts] - 1e-9 for p in conv9.F32_PARTS if p > parts)


# The split that was fastest at each float32 conv9 row of the kernel table on
# an H100 (132 SMs, 4 unsplit blocks an SM at k = 9; tools/conv_bench.py
# --parts 1 2 4; PERF.md), and the one the selector picks there.
@pytest.mark.parametrize("b,h,w,parts", [
    (1, 128, 128, 4), (2, 72, 128, 4), (2, 128, 128, 1), (1, 264, 512, 1), (1, 512, 512, 1)])
def test_f32_split_choice_on_an_h100(b, h, w, parts):
    assert conv9.conv9_f32_parts(b, h, w, 9, (132, 4)) == parts
