"""Spatial self-attention for the TransformerBlock, over (B, heads, S, D) tensors.

Counterpart of ``sshslie_tpu/ops/attention.py``:

* :func:`sdpa_dense` (the JAX ``sdpa_xla``): the full (S, S) logits in
  float32, softmax, product with V. For short sequences.
* :func:`sdpa_chunked`: an online softmax over key blocks of 512, keys past S
  masked with -1e30; O(S * block) memory. The plain version of the kernel.
* :func:`flash_attention`: the kernel of ``csrc/flash_attn.cu`` behind the
  :class:`FlashAttention` autograd Function (JAX ``_flash_attention_ad``). On
  a CUDA tensor the forward launches the kernel and counts the launch in
  ``flash_attention.launches``, ``flash_attention.launches_by_dtype`` and
  ``flash_attention.launches_by_shape[("forward", dtype, q.shape)]``, or
  raises; on a CPU tensor it computes :func:`sdpa_chunked`. q, k and v are
  all float32 or all bfloat16 (the bfloat16 entry keeps m, l and the
  accumulator in float32 and returns bfloat16); mixed dtypes raise. The
  backward recomputes through :func:`sdpa_chunked` under autograd, as JAX
  ``_flash_bwd`` does: there is no backward kernel.
* :func:`multi_head_attention`: 'auto' takes the dense form up to 2048 tokens
  and past that the kernel on CUDA and ``sdpa_chunked`` on the CPU, as the JAX
  dispatch takes the Pallas kernel on a TPU and the chunked form elsewhere.

The softmax scale is 1/sqrt(D), as the reference's scaled dot product.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch
from torch.autograd.function import once_differentiable

from sshslie_torch.ops import _build, at_least_float32

NEG_INF = -1e30
DENSE_MAX_SEQ = 2048
HEAD_DIMS = (16, 32, 64)
# The dtypes the kernel takes, and the suffix of each one's C entry.
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def sdpa_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense scaled-dot-product attention with float32 (at least) logits."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhsd,bhtd->bhst", at_least_float32(q), at_least_float32(k))
    weights = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bhsd", at_least_float32(weights),
                        at_least_float32(v)).to(q.dtype)


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention over key blocks; m, l and acc in float32."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    block_k = min(block_k, s)
    qf = q.float()
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, block_k):
        k_blk = k[:, :, k0:k0 + block_k].float()
        v_blk = v[:, :, k0:k0 + block_k]
        n = k_blk.shape[2]
        if n < block_k:
            # Zero-padded keys masked to -1e30, as the JAX scan pads its last block.
            pad = (0, 0, 0, block_k - n)
            k_blk = torch.nn.functional.pad(k_blk, pad)
            v_blk = torch.nn.functional.pad(v_blk, pad)
        logits = torch.einsum("bhsd,bhtd->bhst", qf, k_blk) * scale
        if n < block_k:
            logits[..., n:] = NEG_INF
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v_blk.float())
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attn")
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"sshslie_flash_attn_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The forward of :class:`FlashAttention`: the kernel on CUDA tensors,
    :func:`sdpa_chunked` on CPU tensors."""
    if q.device.type == "cpu":
        return sdpa_chunked(q, k, v)
    b, h, s, d = q.shape
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: the kernel takes all-float32 or all-bfloat16 q, k, v, "
                         f"got {[t.dtype for t in (q, k, v)]}")
    if k.shape != q.shape or v.shape != q.shape or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (head dim in {HEAD_DIMS})")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous and 16-byte aligned")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _library()
    code = getattr(lib, f"sshslie_flash_attn_{KERNEL_DTYPES[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, s, d,
        math.log2(math.e) / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _count(q.dtype, ("forward", q.dtype, tuple(q.shape)))
    _build.check(lib, code, "flash attention kernel launch")
    return o


class FlashAttention(torch.autograd.Function):
    """Flash attention forward on the kernel; backward by recomputation through
    :func:`sdpa_chunked` (JAX ``_flash_fwd``/``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad)]
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(sdpa_chunked(*inputs), wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D)) V over (B, H, S, D) -> (B, H, S, D), differentiable.

    CPU tensors take :func:`sdpa_chunked`. CUDA tensors take the kernel; a
    shape, type or layout the kernel does not take raises.
    """
    return FlashAttention.apply(q, k, v)


# The counts are read-modify-writes from every thread that launches (the
# training thread and the async-eval worker): one lock keeps them exact.
_COUNT_LOCK = threading.Lock()


def _count(dtype: torch.dtype, key: tuple = ()) -> None:
    with _COUNT_LOCK:
        flash_attention.launches += 1
        flash_attention.launches_by_dtype[dtype] += 1
        flash_attention.launches_by_shape[key] = flash_attention.launches_by_shape.get(key, 0) + 1


def reset_counts() -> None:
    """Set the kernel's launch counts to 0."""
    with _COUNT_LOCK:
        flash_attention.launches = 0
        flash_attention.launches_by_dtype = dict.fromkeys(KERNEL_DTYPES, 0)
        flash_attention.launches_by_shape = {}


reset_counts()


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         impl: str = "auto") -> torch.Tensor:
    """Attention over (B, H, S, D) by ``impl``: auto | dense | chunked | kernel."""
    if impl == "auto":
        if q.shape[2] <= DENSE_MAX_SEQ:
            impl = "dense"
        else:
            impl = "kernel" if q.is_cuda else "chunked"
    if impl == "dense":
        return sdpa_dense(q, k, v)
    if impl == "chunked":
        return sdpa_chunked(q, k, v)
    if impl == "kernel":
        return flash_attention(q, k, v)
    raise ValueError(f"unknown attention impl {impl!r}")
