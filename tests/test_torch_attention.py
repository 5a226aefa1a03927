"""sshslie_torch.ops.attention against sshslie_tpu.ops.attention on the CPU
(the Pallas flash kernel in interpret mode, blocks of 32 as in
tests/test_attention.py) and the 'auto' dispatch. The CUDA kernel is held
against its plain version on the card in tests/test_torch_kernels_cuda.py.

Tolerance 2e-5 absolute, as tests/test_attention.py holds the JAX forms to
each other; the measured gaps here are below 1e-6. The FlashAttention
gradients against ``jax.grad`` through ``_flash_attention_ad`` (interpret
mode): 1e-5 of each gradient's largest magnitude (measured <= 9.8e-7).
bfloat16 operands: one bfloat16 step of max|o| against JAX's sdpa_chunked
(measured 0 and 4.9e-4 at max|o| 0.79 and 0.56), plus 2^-9 of max|v|
against the Pallas kernel, whose p stays float32 (measured 3.9e-3 and
2.0e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.ops import attention as ja
from sshslie_torch.ops import attention as ta

ATOL = 2e-5
BF16_STEP = 2.0 ** -7    # one bfloat16 step of a value's magnitude, at most


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture
def qkv():
    # S = 100 is not a multiple of the 32-key blocks: the masked path runs.
    return _qkv(3, (2, 4, 100, 16))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def test_dense_matches_jax_sdpa_xla(qkv):
    np.testing.assert_allclose(ta.sdpa_dense(*_t(qkv)).numpy(), np.asarray(ja.sdpa_xla(*_j(qkv))),
                               atol=ATOL)


def test_chunked_matches_jax_chunked(qkv):
    got = ta.sdpa_chunked(*_t(qkv), block_k=32).numpy()
    np.testing.assert_allclose(got, np.asarray(ja.sdpa_chunked(*_j(qkv), block_k=32)), atol=ATOL)
    np.testing.assert_allclose(ta.sdpa_chunked(*_t(qkv)).numpy(), got, atol=ATOL)


def test_flash_plain_path_matches_pallas_interpret(qkv):
    want = np.asarray(ja.flash_attention(*_j(qkv), block_q=32, block_k=32, interpret=True))
    before = ta.flash_attention.launches
    got = ta.flash_attention(*_t(qkv)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # A CPU tensor takes sdpa_chunked: no kernel launch is counted.
    assert ta.flash_attention.launches == before


@pytest.mark.parametrize("s", [1, 3, 257])
def test_flash_plain_path_matches_pallas_interpret_at_edges(s):
    # Fewer keys than the kernel's 8 key lanes (1, 3), and a ragged last tile
    # of its 128-key stages (257), through the path the kernel is held to.
    arrs = _qkv(8, (1, 2, s, 16))
    want = np.asarray(ja.flash_attention(*_j(arrs), block_q=32, block_k=32, interpret=True))
    got = ta.flash_attention(*_t(arrs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("s", [100, 257])
def test_flash_plain_path_bf16_matches_jax(s):
    # bfloat16 operands in both frameworks. The port's CPU path is
    # sdpa_chunked, which rounds p to bfloat16 before P V as JAX's does: one
    # bfloat16 step of max|o| (a sum in another order may round the other
    # way). The Pallas kernel keeps p in float32, which moves o by at most
    # 2^-9 of max|v| more.
    arrs = _qkv(9, (1, 2, s, 16))
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    got = ta.flash_attention(*tb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    vmax = float(np.abs(tb[2].float().numpy()).max())
    want = np.asarray(ja.sdpa_chunked(*jb).astype(jnp.float32))
    tol = BF16_STEP * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol
    want = np.asarray(ja.flash_attention(*jb, block_q=32, block_k=32, interpret=True).astype(jnp.float32))
    tol = BF16_STEP * float(np.abs(want).max()) + 2.0 ** -9 * vmax
    assert float(np.abs(got - want).max()) <= tol


def test_auto_short_sequence_is_dense(qkv):
    got = ta.multi_head_attention(*_t(qkv), impl="auto").numpy()
    np.testing.assert_array_equal(got, ta.sdpa_dense(*_t(qkv)).numpy())
    np.testing.assert_allclose(got, np.asarray(ja.multi_head_attention(*_j(qkv), impl="auto")),
                               atol=ATOL)


def test_auto_long_sequence_is_chunked_on_cpu():
    arrs = _qkv(4, (1, 1, 2100, 16))   # S > 2048, not a multiple of 512
    got = ta.multi_head_attention(*_t(arrs), impl="auto").numpy()
    np.testing.assert_array_equal(got, ta.sdpa_chunked(*_t(arrs)).numpy())
    np.testing.assert_allclose(got, np.asarray(ja.multi_head_attention(*_j(arrs), impl="auto")),
                               atol=ATOL)


def test_dispatch_names(qkv):
    for impl in ("dense", "chunked", "kernel"):
        np.testing.assert_allclose(ta.multi_head_attention(*_t(qkv), impl=impl).numpy(),
                                   ta.sdpa_dense(*_t(qkv)).numpy(), atol=ATOL)
    with pytest.raises(ValueError):
        ta.multi_head_attention(*_t(qkv), impl="xla")


def test_flash_attention_grads_match_jax_custom_vjp():
    """FlashAttention's backward recomputes through sdpa_chunked, as JAX
    ``_flash_bwd`` does; S = 300 is not a multiple of the 256-query or the
    512-key block."""
    q, k, v = _qkv(6, (1, 2, 300, 16))
    g = _qkv(7, (1, 2, 300, 16))[0]
    _, vjp = jax.vjp(lambda *a: ja._flash_attention_ad(*a, True), *_j((q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [t.requires_grad_() for t in _t((q, k, v))]
    out = ta.flash_attention(*ts)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * float(np.abs(b).max()), err_msg=name)
    # Only the inputs that ask for a gradient get one.
    q2 = torch.from_numpy(q).requires_grad_()
    (dq,) = torch.autograd.grad(ta.flash_attention(q2, *_t((k, v))), q2, torch.from_numpy(g))
    np.testing.assert_array_equal(dq.numpy(), got[0].numpy())
