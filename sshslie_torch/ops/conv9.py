"""The shallow k x k 64 -> 64 convolution: CUDA kernels, plain versions, autograd.

Counterpart of ``sshslie_tpu/ops/conv_pallas.py`` (``conv9_supported``,
``conv9_fwd``, ``conv9_wgrad``, ``_dgrad_weights``, ``pallas_shallow_conv``).
Layout as in the JAX package: x is NHWC (B, H, W, 64), w is HWIO
(k, k, 64, 64), the result NHWC.

* :func:`conv9_fwd` is the wrapper of ``csrc/conv9.cu``. On a CUDA tensor it
  launches the kernel and counts the launch in ``conv9_fwd.launches``, or
  raises; on a CPU tensor it computes :func:`conv9_plain`.
* :func:`conv9_wgrad` is the wrapper of ``csrc/conv9_wgrad.cu``, the weight
  gradient, counted in ``conv9_wgrad.launches``; on a CPU tensor it computes
  :func:`conv9_wgrad_plain`.
* Both take float32 or bfloat16 operands, as the Pallas kernels do, and
  dispatch by dtype: all-float32 to the float32 entry, all-bfloat16 to the
  bfloat16 one (float32 accumulation; conv9's output in bfloat16, the weight
  gradient in float32). Mixed dtypes raise; nothing is converted. Each
  launch also counts in ``launches_by_dtype[dtype]`` and in
  ``launches_by_shape[(pass, dtype, x.shape)]``, pass "forward", "dgrad"
  (conv9_fwd called from :class:`ShallowConv`'s backward) or "wgrad".
* Neither wrapper is differentiable: called where autograd would record it
  (grad mode on, an input that requires grad) it raises.
  :class:`ShallowConv` is the differentiable conv whose three passes all run
  on those wrappers: forward ``conv9_fwd(x, w) + b``; input gradient
  ``conv9_fwd(g, conv9_dgrad_weights(w))``, only when x needs one; weight
  gradient ``conv9_wgrad(x, g, k)``; bias gradient a plain sum.
* The plain versions are the same functions in plain PyTorch, tap by tap as
  the kernels sum them: k*k matrix products over the B*H*W pixels, summed in
  float32 at least whatever the operands' dtype (the TPU kernels accumulate
  in float32); the conv's result is cast to x's dtype, the weight gradient
  stays float32.
* :func:`conv9_supported` is the gate ``models/layers.py::Conv2d`` uses:
  stride 1, odd k from 3 to 13, 64 channels in and out. It is the JAX gate
  without its TPU tile rules (W % 128), plus the kernels' own k limit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sshslie_torch.ops import _build, at_least_float32

CHANNELS = 64
KERNEL_SIZES = (3, 5, 7, 9, 11, 13)
# The dtypes the kernels take, and the suffix of each one's C entry.
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def conv9_supported(shape: Tuple[int, ...], k: int, ci: int, co: int, stride: int = 1) -> bool:
    """Can the kernel take this conv? (Conv2d sends everything else to F.conv2d.)"""
    return (stride == 1 and k in KERNEL_SIZES and ci == CHANNELS and co == CHANNELS
            and len(shape) == 4 and shape[-1] == CHANNELS)


def conv9_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv, NHWC x HWIO -> NHWC, as a sum of per-tap products
    in float32 at least, cast to x's dtype."""
    b, h, wd, _ = x.shape
    k = w.shape[0]
    p = (k - 1) // 2
    xp = F.pad(at_least_float32(x), (0, 0, p, p, p, p))
    wf = at_least_float32(w)
    y = xp.new_zeros((b, h, wd, w.shape[-1]))
    for kh in range(k):
        for kw in range(k):
            y += xp[:, kh:kh + h, kw:kw + wd, :] @ wf[kh, kw]
    return y.to(x.dtype)


def conv9_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dw[kh,kw,ci,co] = sum_{b,h,w} xpad[b,h+kh,w+kw,ci] dy[b,h,w,co] -> (k,k,64,64),
    summed and returned in float32 at least."""
    b, h, wd, ci = x.shape
    p = (k - 1) // 2
    xp = F.pad(at_least_float32(x), (0, 0, p, p, p, p))
    dyf = at_least_float32(dy).reshape(-1, dy.shape[-1])
    dw = xp.new_empty((k, k, ci, dy.shape[-1]))
    for kh in range(k):
        for kw in range(k):
            dw[kh, kw] = xp[:, kh:kh + h, kw:kw + wd, :].reshape(-1, ci).T @ dyf
    return dw


def conv9_dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """The weights that make dx a plain forward conv of dy: spatial reverse and
    in/out transpose (exact for odd k, stride 1; JAX ``_dgrad_weights``)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _not_differentiable(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is not differentiable: its output would carry no gradient. "
            "Call ops.conv9.shallow_conv (the ShallowConv autograd Function) instead")


def _check_cuda_operands(name: str, *tensors: torch.Tensor) -> str:
    """Raise unless the operands suit a kernel entry; return the entry's
    dtype suffix ('f32' or 'bf16')."""
    dev = tensors[0].device
    if not tensors[0].is_cuda or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands on {[str(t.device) for t in tensors]}; "
                         "the kernel needs one CUDA device")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: the kernel takes all-float32 or all-bfloat16 operands, "
                         f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return KERNEL_DTYPES[tensors[0].dtype]


# The counts are read-modify-writes from every thread that launches (the
# training thread and the async-eval worker): one lock keeps them exact.
_COUNT_LOCK = threading.Lock()
# The pass a conv9_fwd launch counts under in launches_by_shape, per thread:
# "dgrad" while ShallowConv.backward runs it, else "forward".
_PASS = threading.local()


def _count(wrapper, dtype: torch.dtype, key: tuple = ()) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.launches_by_dtype[dtype] += 1
        wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def reset_counts() -> None:
    """Set the launch counts of both wrappers to 0."""
    with _COUNT_LOCK:
        for wrapper in (conv9_fwd, conv9_wgrad):
            wrapper.launches = 0
            wrapper.launches_by_dtype = dict.fromkeys(KERNEL_DTYPES, 0)
            wrapper.launches_by_shape = {}


def conv9_wgrad_bf16_taps(k: int) -> int:
    """Taps of one kernel row that a block of the bfloat16 weight-gradient
    kernel owns, 3 to a warpgroup (csrc/conv9_wgrad.cu, TcWTile::kTaps): the
    whole row up to k = 9, half of it (rounded up) above."""
    return k if k <= 9 else (k + 1) // 2


def conv9_wgrad_bf16_splits(rows: int, k: int, resident: int) -> int:
    """Pixel-row slices of the bfloat16 weight-gradient kernel for B*H =
    ``rows`` image rows, where the card holds ``resident`` of its blocks at
    once: one wave. A slice takes k * ceil(k / taps) blocks (kernel row,
    group of taps); at least 1 slice, at most one row a slice. The wrapper
    allocates ``splits * k * k * 64 * 64`` float32 of partials."""
    per_slice = k * -(-k // conv9_wgrad_bf16_taps(k))
    return max(1, min(rows, resident // per_slice))


def _library() -> ctypes.CDLL:
    lib = _build.library("conv9")
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"sshslie_conv_c64_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _wgrad_library() -> ctypes.CDLL:
    lib = _build.library("conv9_wgrad")
    lib.sshslie_conv9_wgrad_splits.argtypes = [ctypes.c_int] * 3
    lib.sshslie_conv9_wgrad_splits.restype = ctypes.c_int
    lib.sshslie_conv9_wgrad_resident_bf16.argtypes = [ctypes.c_int]
    lib.sshslie_conv9_wgrad_resident_bf16.restype = ctypes.c_int
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"sshslie_conv9_wgrad_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def conv9_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME k x k conv, NHWC (B, H, W, 64) x HWIO (k, k, 64, 64) -> NHWC
    in x's dtype (float32 or bfloat16, float32 accumulation).

    CPU tensors take :func:`conv9_plain`. CUDA tensors take the kernel; a
    shape, type or layout the kernel does not take raises. Not
    differentiable: see :class:`ShallowConv`.
    """
    _not_differentiable("conv9_fwd", x, w)
    if x.device.type == "cpu":
        return conv9_plain(x, w)
    suffix = _check_cuda_operands("conv9_fwd", x, w)
    k = w.shape[0]
    if tuple(w.shape) != (k, k, CHANNELS, CHANNELS) or not conv9_supported(x.shape, k, CHANNELS, CHANNELS):
        raise ValueError(f"conv9_fwd: unsupported shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    b, h, wd, _ = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _library()
    code = getattr(lib, f"sshslie_conv_c64_{suffix}")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    _count(conv9_fwd, x.dtype, (getattr(_PASS, "name", "forward"), x.dtype, tuple(x.shape)))
    _build.check(lib, code, "conv9 kernel launch")
    return y


def conv9_wgrad(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME k x k 64 -> 64 conv -> (k, k, 64, 64)
    in float32, from float32 or bfloat16 x and dy.

    CPU tensors take :func:`conv9_wgrad_plain`. CUDA tensors take the kernel
    (a split reduction over pixel rows into scratch, then a fixed-order sum
    of the partials); a shape, type or layout it does not take raises.
    """
    _not_differentiable("conv9_wgrad", x, dy)
    if x.device.type == "cpu":
        return conv9_wgrad_plain(x, dy, k)
    suffix = _check_cuda_operands("conv9_wgrad", x, dy)
    if x.shape != dy.shape or not conv9_supported(x.shape, k, CHANNELS, CHANNELS):
        raise ValueError(f"conv9_wgrad: unsupported shapes x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}, k {k}")
    b, h, wd, _ = x.shape
    if x.numel() == 0:
        return x.new_zeros((k, k, CHANNELS, CHANNELS), dtype=torch.float32)
    lib = _wgrad_library()
    # float32: the kernel's slice count; bfloat16: its resident blocks, from
    # which conv9_wgrad_bf16_splits derives the slice count.
    query = (lib.sshslie_conv9_wgrad_splits(b, h, k) if suffix == "f32"
             else lib.sshslie_conv9_wgrad_resident_bf16(k))
    if query < 0:
        _build.check(lib, -query, "conv9_wgrad occupancy query")
    splits = query if suffix == "f32" else conv9_wgrad_bf16_splits(b * h, k, query)
    part = torch.empty((splits, k, k, CHANNELS, CHANNELS), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, k, CHANNELS, CHANNELS), dtype=torch.float32, device=x.device)
    code = getattr(lib, f"sshslie_conv9_wgrad_{suffix}")(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), b, h, wd, k, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _count(conv9_wgrad, x.dtype, ("wgrad", x.dtype, tuple(x.shape)))
    _build.check(lib, code, "conv9_wgrad kernel launch")
    return dw


reset_counts()


class ShallowConv(torch.autograd.Function):
    """``conv9_fwd(x, w) + b`` with every pass on the conv9 kernels
    (JAX ``pallas_shallow_conv`` with ``_psc_fwd``/``_psc_bwd``; the JAX VJP
    takes dw from XLA, the port from its own ``conv9_wgrad`` kernel).

    x NHWC (B, H, W, 64), w HWIO (k, k, 64, 64), b (64,), all of one dtype,
    float32 or bfloat16. The gradients come back in that dtype, as in
    ``_psc_bwd``: dx from the conv9 kernel, dw from the float32 weight
    gradient rounded to w's dtype, db a float32 sum cast to it. On CPU
    tensors the same passes run on the plain versions.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return conv9_fwd(x, w) + b

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        # The incoming gradient may be any strided view; the kernels read
        # contiguous NHWC (a copy when it is not already).
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            _PASS.name = "dgrad"
            try:
                dx = conv9_fwd(g, conv9_dgrad_weights(w))
            finally:
                _PASS.name = "forward"
        if ctx.needs_input_grad[1]:
            dw = conv9_wgrad(x, g, w.shape[0]).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = at_least_float32(g).sum(dim=(0, 1, 2)).to(w.dtype)
        return dx, dw, db


def shallow_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bias-included, differentiable shallow conv (NHWC, HWIO) on the kernels."""
    return ShallowConv.apply(x, w, b)
