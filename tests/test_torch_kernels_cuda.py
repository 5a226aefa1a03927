"""The CUDA kernels against their plain versions on the card.

Every test here needs a CUDA card and nvcc, carries the ``cuda`` marker and
skips without one. The file imports only torch, numpy and the port, so it
runs on a machine without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Tolerances: conv9 5e-5 absolute at outputs of order 10 (float32 sums of up
to 5184 products in another order; chip_smoke.py measured 4.8e-6 at 512^2
and 1.6e-5 at 37x53); its splits of the float32 units at k = 3 .. 13 2e-5
of the largest output, the splits bit for bit equal; flash 1e-5 absolute (exp2 with a folded scale against
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

The TF32 entries (``tf32=True``: float32 operands rounded to TF32, products
on the tensor cores), at the main path's shapes and at ragged shapes for
k = 3, 9 and 13, against the plain versions with ``tf32=True`` (the same
rounding, exact products, float32 sums in another order): conv9, its dgrad
and conv9_wgrad within 1e-5 of the largest output (a kernel that truncated
its operands instead of rounding them would be off by ~2^-11 of the sum of
|terms|); and against a float64 conv of the unrounded operands, elementwise
within (2u + u^2 + n 2^-23) conv(|x|, |w|), u = 2^-11 the TF32 rounding of
each operand and n 2^-23 the float32 sums of the n = k*k*64 products (of
the B*H*W pixels for the weight gradient), however they round. Repeats are
bit-identical; the launches count under "tf32".
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


# The float32 entry's splits of its units (ops/conv9.py::F32_PARTS): every
# odd k on ragged shapes, forward and dgrad, within 2e-5 of the largest
# output (chip_smoke.py's float32 tolerance; at k = 13 a sum holds 10,816
# products in another order than the plain version's), and bit for bit
# equal to each other (one summation order for every split).
F32_SPLIT_CASES = [((1, 37, 45, 64), k) for k in conv9.KERNEL_SIZES] + [
    ((2, 13, 100, 64), 9), ((3, 15, 47, 64), 5), ((1, 5, 9, 64), 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", F32_SPLIT_CASES)
def test_conv9_f32_splits_match_plain_and_each_other_on_card(cuda_device, shape, k):
    x, w = _conv_inputs(31, shape, k)
    x, w = torch.from_numpy(x).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    for what, ww in (("forward", w), ("dgrad", conv9.conv9_dgrad_weights(w))):
        plain = conv9.conv9_plain(x, ww)
        outs = [conv9.conv9_fwd(x, ww, parts=p) for p in conv9.F32_PARTS]
        for p, got in zip(conv9.F32_PARTS, outs):
            _rel_close(got, plain, 2e-5, f"{what} {shape} k{k} parts {p}")
            assert torch.equal(got, outs[0]), f"{what} {shape} k{k}: parts {p} differs from parts 1"
        assert torch.equal(conv9.conv9_fwd(x, ww), outs[0])


@pytest.mark.cuda
def test_conv9_f32_splits_agree_across_batch_and_rows_on_card(cuda_device):
    """Sample 0 of a b2 batch equals the same sample alone, and a rank's
    rows (2, 72, 128, 64) equal the b2 run's rows 0..67 (68..71 see the
    slice's edge), bit for bit, in every split."""
    x, w = _conv_inputs(32, (2, 128, 128, 64), 9)
    x, w = torch.from_numpy(x).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    want = conv9.conv9_fwd(x, w, parts=1)
    for p in conv9.F32_PARTS:
        assert torch.equal(conv9.conv9_fwd(x[:1].contiguous(), w, parts=p), want[:1])
        assert torch.equal(conv9.conv9_fwd(x[:, :72].contiguous(), w, parts=p)[:, :68], want[:, :68])


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


# The wide float32 entries (Cin -> 64, Cin other than 64): the 224-band
# cell's shapes and ragged ones, against the plain versions within 2e-5 of
# the largest output (a sum holds up to 9*9*224 = 18,144 products in another
# order), every split bit for bit equal to the others and to the selector's.
WIDE_CASES = [((8, 128, 128, 224), 9), ((1, 37, 45, 224), 3), ((1, 37, 45, 224), 13),
              ((2, 19, 70, 96), 9), ((1, 20, 33, 32), 5)]


def _wide_inputs(seed, shape, co, k, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    w = (rng.standard_normal((k, k, shape[-1], co)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((*shape[:3], co)).astype(np.float32)
    return x, torch.from_numpy(w).to(device), torch.from_numpy(dy).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", WIDE_CASES)
def test_wide_f32_conv_matches_plain_in_every_split_on_card(cuda_device, shape, k):
    x, w, _ = _wide_inputs(21, shape, 64, k, cuda_device)
    key = ("wide_forward", torch.float32, (*shape, 64))
    before = conv9.conv9_fwd.launches_by_shape.get(key, 0)
    auto = conv9.conv9_fwd(x, w)
    assert conv9.conv9_fwd.launches_by_shape[key] == before + 1
    assert auto.shape == (*shape[:3], 64)
    _rel_close(auto, conv9.conv9_plain(x, w), 2e-5, f"wide {shape} -> 64 k{k}")
    for p in conv9.F32_PARTS:
        assert torch.equal(conv9.conv9_fwd(x, w, parts=p), auto), f"{shape} -> 64: parts {p}"
    assert torch.equal(conv9.conv9_fwd(x, w), auto)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((8, 128, 128, 224), 9), ((1, 37, 53, 224), 3),
                                     ((2, 19, 70, 96), 13)])
def test_wide_f32_wgrad_matches_plain_on_card(cuda_device, shape, k):
    x, _, dy = _wide_inputs(22, shape, 64, k, cuda_device)
    key = ("wide_wgrad", torch.float32, (*shape, 64))
    before = conv9.conv9_wgrad.launches_by_shape.get(key, 0)
    got = conv9.conv9_wgrad(x, dy, k)
    assert conv9.conv9_wgrad.launches_by_shape[key] == before + 1
    assert got.shape == (k, k, shape[-1], 64)
    _rel_close(got, conv9.conv9_wgrad_plain(x, dy, k), 2e-5, f"wide wgrad {shape} k{k}")
    assert torch.equal(got, conv9.conv9_wgrad(x, dy, k))


@pytest.mark.cuda
def test_wide_entries_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros(1, 8, 8, 224, device=cuda_device)
    w = torch.zeros(9, 9, 224, 64, device=cuda_device)
    dy = torch.zeros(1, 8, 8, 64, device=cuda_device)
    x200, w200 = x[..., :200].contiguous(), w[:, :, :200].contiguous()
    w_to224 = torch.zeros(9, 9, 64, 224, device=cuda_device)
    for what, bad in (("TF32", lambda: conv9.conv9_fwd(x, w, tf32=True)),
                      ("bfloat16", lambda: conv9.conv9_fwd(x.bfloat16(), w.bfloat16())),
                      ("a split of 64 into 3", lambda: conv9.conv9_fwd(x, w, parts=3)),
                      ("200 channels", lambda: conv9.conv9_fwd(x200, w200)),
                      ("64 -> 224", lambda: conv9.conv9_fwd(dy, w_to224)),
                      ("TF32 wgrad", lambda: conv9.conv9_wgrad(x, dy, 9, tf32=True)),
                      ("wgrad to 224", lambda: conv9.conv9_wgrad(x, x, 9)),
                      ("wgrad pixels differ",
                       lambda: conv9.conv9_wgrad(x, torch.zeros(1, 8, 9, 64, device=cuda_device), 9))):
        with pytest.raises(ValueError):
            bad()
            pytest.fail(what)


@pytest.mark.cuda
def test_shallow_conv_wide_grads_on_card_match_plain_autograd(cuda_device):
    rng = np.random.default_rng(15)
    x, w, g = _wide_inputs(16, (2, 32, 40, 224), 64, 9, cuda_device)
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(cuda_device)

    def grads(fn):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        return torch.autograd.grad(fn(xs, ws, bs), (xs, ws, bs), g)

    conv9.reset_counts()
    got = grads(conv9.shallow_conv)
    torch.cuda.synchronize()
    f32 = torch.float32
    # The forward and the weight gradient on the wide kernels, the input
    # gradient on cuDNN (faster there), counted as a library pass.
    assert conv9.conv9_fwd.launches_by_shape == {("wide_forward", f32, (2, 32, 40, 224, 64)): 1}
    assert conv9.conv9_wgrad.launches_by_shape == {("wide_wgrad", f32, (2, 32, 40, 224, 64)): 1}
    assert conv9.library_passes == {("dgrad", f32, (2, 32, 40, 224, 64)): 1}
    want = grads(lambda xs, ws, bs: conv9.conv9_plain(xs, ws) + bs)
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        _rel_close(a, c, 2e-5, name)


# sha256 (first 16 hex digits) of the 64 -> 64 entries' outputs on seeded
# inputs, recorded on an H100 (132 SMs: the weight gradients' slice counts
# follow the card) from the kernels as they were before the wide entries
# shared their code: float32 (every split), TF32 and bfloat16, forward, dgrad
# and weight gradient.
RECORDED_C64 = {
    'bf16 fwd 1x37x45x64k13': '1497c483d2d1d7eb',
    'bf16 fwd 1x37x45x64k3': '76ff2f85a54074ef',
    'bf16 fwd 2x128x128x64k9': 'e4f939ee2122ae11',
    'bf16 fwd 8x128x128x64k9': '360263685497e461',
    'bf16 wgrad 1x37x45x64k13': 'b47164eb24a2fb93',
    'bf16 wgrad 1x37x45x64k3': 'a34abd16587e77cb',
    'bf16 wgrad 2x128x128x64k9': '8863f21b2ac68e08',
    'bf16 wgrad 8x128x128x64k9': '8586aa0282eb74e2',
    'f32 dgrad 1x37x45x64k13 p1': '2f85343428e89cb2',
    'f32 dgrad 1x37x45x64k13 p2': '2f85343428e89cb2',
    'f32 dgrad 1x37x45x64k13 p4': '2f85343428e89cb2',
    'f32 dgrad 1x37x45x64k3 p1': 'bd3598289447b005',
    'f32 dgrad 1x37x45x64k3 p2': 'bd3598289447b005',
    'f32 dgrad 1x37x45x64k3 p4': 'bd3598289447b005',
    'f32 dgrad 2x128x128x64k9 p1': 'c6ce7ad279bac067',
    'f32 dgrad 2x128x128x64k9 p2': 'c6ce7ad279bac067',
    'f32 dgrad 2x128x128x64k9 p4': 'c6ce7ad279bac067',
    'f32 dgrad 8x128x128x64k9 p1': '4480ff0bf940f85f',
    'f32 dgrad 8x128x128x64k9 p2': '4480ff0bf940f85f',
    'f32 dgrad 8x128x128x64k9 p4': '4480ff0bf940f85f',
    'f32 fwd 1x37x45x64k13 auto': '07cc4d3f2714f771',
    'f32 fwd 1x37x45x64k13 p1': '07cc4d3f2714f771',
    'f32 fwd 1x37x45x64k13 p2': '07cc4d3f2714f771',
    'f32 fwd 1x37x45x64k13 p4': '07cc4d3f2714f771',
    'f32 fwd 1x37x45x64k3 auto': 'a3cc40214e1b0230',
    'f32 fwd 1x37x45x64k3 p1': 'a3cc40214e1b0230',
    'f32 fwd 1x37x45x64k3 p2': 'a3cc40214e1b0230',
    'f32 fwd 1x37x45x64k3 p4': 'a3cc40214e1b0230',
    'f32 fwd 2x128x128x64k9 auto': 'bbebe1be99b25b36',
    'f32 fwd 2x128x128x64k9 p1': 'bbebe1be99b25b36',
    'f32 fwd 2x128x128x64k9 p2': 'bbebe1be99b25b36',
    'f32 fwd 2x128x128x64k9 p4': 'bbebe1be99b25b36',
    'f32 fwd 8x128x128x64k9 auto': 'e95f3d7be13a407b',
    'f32 fwd 8x128x128x64k9 p1': 'e95f3d7be13a407b',
    'f32 fwd 8x128x128x64k9 p2': 'e95f3d7be13a407b',
    'f32 fwd 8x128x128x64k9 p4': 'e95f3d7be13a407b',
    'f32 wgrad 1x37x45x64k13': '73afcdb46bc8aea9',
    'f32 wgrad 1x37x45x64k3': '8fd2e02f1f6c04f8',
    'f32 wgrad 2x128x128x64k9': '7470bad73394c03a',
    'f32 wgrad 8x128x128x64k9': 'd691a860be4e2662',
    'tf32 fwd 1x37x45x64k13': 'f8bc23e0b09b4714',
    'tf32 fwd 1x37x45x64k3': 'f76fb89059240bd4',
    'tf32 fwd 2x128x128x64k9': '13cc4b476d3649ee',
    'tf32 fwd 8x128x128x64k9': 'a946624272aedc7c',
    'tf32 wgrad 1x37x45x64k13': 'aaccf2100b27d738',
    'tf32 wgrad 1x37x45x64k3': 'f3f0691f4f68777b',
    'tf32 wgrad 2x128x128x64k9': '72b94b3b164caa36',
    'tf32 wgrad 8x128x128x64k9': '4eaff5e476ef9fd7',
}


def c64_digests(device) -> dict:
    import hashlib

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]

    def inputs(shape, k, dtype):
        rng = np.random.default_rng(41)
        x = rng.standard_normal(shape).astype(np.float32)
        w = (rng.standard_normal((k, k, 64, 64)) * 0.05).astype(np.float32)
        dy = rng.standard_normal(shape).astype(np.float32)
        return (torch.from_numpy(a).to(device, dtype) for a in (x, w, dy))

    out = {}
    for shape, k in (((2, 128, 128, 64), 9), ((1, 37, 45, 64), 3), ((1, 37, 45, 64), 13),
                     ((8, 128, 128, 64), 9)):
        x, w, dy = inputs(shape, k, torch.float32)
        tag = "x".join(map(str, shape)) + f"k{k}"
        for p in conv9.F32_PARTS:
            out[f"f32 fwd {tag} p{p}"] = digest(conv9.conv9_fwd(x, w, parts=p))
            out[f"f32 dgrad {tag} p{p}"] = digest(conv9.conv9_fwd(x, conv9.conv9_dgrad_weights(w),
                                                                  parts=p))
        out[f"f32 fwd {tag} auto"] = digest(conv9.conv9_fwd(x, w))
        out[f"f32 wgrad {tag}"] = digest(conv9.conv9_wgrad(x, dy, k))
        out[f"tf32 fwd {tag}"] = digest(conv9.conv9_fwd(x, w, tf32=True))
        out[f"tf32 wgrad {tag}"] = digest(conv9.conv9_wgrad(x, dy, k, tf32=True))
        xb, wb, dyb = inputs(shape, k, torch.bfloat16)
        out[f"bf16 fwd {tag}"] = digest(conv9.conv9_fwd(xb, wb))
        out[f"bf16 wgrad {tag}"] = digest(conv9.conv9_wgrad(xb, dyb, k))
    return out


@pytest.mark.cuda
def test_c64_entries_give_the_bits_recorded_before_the_wide_entries(cuda_device):
    assert c64_digests(cuda_device) == RECORDED_C64


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


# The TF32 entries: the main path's shapes at k = 9 (the test phase's 512^2
# cube, the training batch), ragged tiles (H, W not multiples of the 8 x 32
# output tile or the 64-pixel segment) at k = 3, 9 and 13, an image smaller
# than the k = 13 halo, and B*H = 2 rows; then B*H*W not a multiple of the
# 8 x 32 tile with H and W both ragged, at k = 5, 7 and 11.
CONV_TF32_CASES = [((1, 512, 512, 64), 9), ((2, 128, 128, 64), 9), ((1, 37, 53, 64), 3),
                   ((1, 37, 53, 64), 9), ((1, 37, 53, 64), 13), ((3, 19, 70, 64), 3),
                   ((3, 19, 70, 64), 13), ((2, 5, 9, 64), 13), ((1, 2, 40, 64), 9),
                   ((2, 13, 100, 64), 11), ((1, 9, 33, 64), 7), ((3, 15, 47, 64), 5)]
# conv9_wgrad's TF32 entry also at: W < 64, so a segment is mostly padding;
# B*H below the slice count of one wave; k = 11 and 13, whose kernel row
# spans two blocks, with a W that leaves a short last segment.
WGRAD_TF32_CASES = CONV_TF32_CASES + [((2, 9, 40, 64), 9), ((1, 3, 21, 64), 9),
                                      ((1, 4, 130, 64), 13), ((2, 24, 77, 64), 13),
                                      ((1, 6, 65, 64), 11)]
TF32_U = 2.0 ** -11


def _f32(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _within_float64_bound(got, want64, abs_sum64, n, what):
    """|got - want64| <= (2u + u^2 + n 2^-23) * abs_sum64, elementwise."""
    bound = (2 * TF32_U + TF32_U ** 2 + n * 2.0 ** -23) * abs_sum64
    excess = float(((got.double() - want64).abs() - bound).max())
    assert excess <= 0, f"{what}: over the float64 bound by {excess:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", CONV_TF32_CASES)
def test_conv9_tf32_kernel_matches_plain_on_card(cuda_device, shape, k):
    x, w = _f32(51, shape).to(cuda_device), _f32(52, (k, k, 64, 64), 0.05).to(cuda_device)
    wd = conv9.conv9_dgrad_weights(w)
    conv9.reset_counts()
    for what, ww in (("forward", w), ("dgrad", wd)):
        got = conv9.conv9_fwd(x, ww, tf32=True)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        _rel_close(got, conv9.conv9_plain(x, ww, tf32=True), 1e-5, f"conv9 tf32 {what} {shape} k{k}")
        want64 = conv9.conv9_plain(x.double(), ww.double())
        _within_float64_bound(got, want64, conv9.conv9_plain(x.double().abs(), ww.double().abs()),
                              k * k * 64, f"conv9 tf32 {what} {shape} k{k} vs float64")
        assert torch.equal(got, conv9.conv9_fwd(x, ww, tf32=True))
    assert conv9.conv9_fwd.launches_by_dtype == {torch.float32: 0, torch.bfloat16: 0, "tf32": 4}
    assert conv9.conv9_fwd.launches_by_shape == {("forward", "tf32", shape): 4}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", WGRAD_TF32_CASES)
def test_conv9_wgrad_tf32_kernel_matches_plain_on_card(cuda_device, shape, k):
    x, dy = _f32(53, shape).to(cuda_device), _f32(54, shape).to(cuda_device)
    conv9.reset_counts()
    got = conv9.conv9_wgrad(x, dy, k, tf32=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (k, k, 64, 64)
    _rel_close(got, conv9.conv9_wgrad_plain(x, dy, k, tf32=True), 1e-5, f"wgrad tf32 {shape} k{k}")
    _within_float64_bound(got, conv9.conv9_wgrad_plain(x.double(), dy.double(), k),
                          conv9.conv9_wgrad_plain(x.double().abs(), dy.double().abs(), k),
                          x.numel() // 64, f"wgrad tf32 {shape} k{k} vs float64")
    assert torch.equal(got, conv9.conv9_wgrad(x, dy, k, tf32=True))
    assert conv9.conv9_wgrad.launches_by_shape == {("wgrad", "tf32", shape): 2}


@pytest.mark.cuda
def test_shallow_conv_tf32_grads_on_card_match_plain_passes(cuda_device):
    """All three kernel passes take the TF32 entries: against the plain
    passes with the same rounding (the CPU's ShallowConv with tf32)."""
    x, w, g = _f32(55, (2, 40, 72, 64)), _f32(56, (9, 9, 64, 64), 0.05), _f32(57, (2, 40, 72, 64))
    b = _f32(58, (64,), 0.1)

    def grads(dev):
        ts = [t.to(dev).requires_grad_() for t in (x, w, b)]
        y = conv9.shallow_conv(*ts, tf32=True)
        return [y.detach().cpu()] + [t.cpu() for t in torch.autograd.grad(y, ts, g.to(dev))]

    conv9.reset_counts()
    got = grads(cuda_device)
    counts = {**conv9.conv9_fwd.launches_by_shape, **conv9.conv9_wgrad.launches_by_shape}
    want = grads("cpu")
    assert counts == {("forward", "tf32", x.shape): 1, ("dgrad", "tf32", x.shape): 1,
                      ("wgrad", "tf32", x.shape): 1}
    for name, a, c in zip(("y", "dx", "dw", "db"), got, want):
        _rel_close(a, c, 1e-5, name)


@pytest.mark.cuda
def test_tf32_takes_float32_operands_only(cuda_device):
    x = torch.zeros(1, 8, 8, 64, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(9, 9, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tf32 takes float32"):
        conv9.conv9_fwd(x, w, tf32=True)
    with pytest.raises(ValueError, match="tf32 takes float32"):
        conv9.conv9_wgrad(x, x, 9, tf32=True)
