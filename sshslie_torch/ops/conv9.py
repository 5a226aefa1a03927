"""The shallow k x k convolution, 64 -> 64 channels (and Cin -> 64 in float32):
CUDA kernels, plain versions, autograd.

Counterpart of ``sshslie_tpu/ops/conv_pallas.py`` (``conv9_supported``,
``conv9_fwd``, ``conv9_wgrad``, ``_dgrad_weights``, ``pallas_shallow_conv``).
Layout as in the JAX package: x is NHWC (B, H, W, 64), w is HWIO
(k, k, 64, 64), the result NHWC.

* :func:`conv9_fwd` is the wrapper of ``csrc/conv9.cu``. On a CUDA tensor it
  launches the kernel and counts the launch in ``conv9_fwd.launches``, or
  raises; on a CPU tensor it computes :func:`conv9_plain`. The float32 entry
  splits its units' output channels as :func:`conv9_f32_parts` picks from the
  shape and the card (every split gives the same bits) and reads a planar,
  zero-padded copy of x that its prep kernel writes into scratch the wrapper
  allocates: two CUDA launches, one counted launch.
* :func:`conv9_wgrad` is the wrapper of ``csrc/conv9_wgrad.cu``, the weight
  gradient, counted in ``conv9_wgrad.launches``; on a CPU tensor it computes
  :func:`conv9_wgrad_plain`.
* Both take float32 or bfloat16 operands, as the Pallas kernels do, and
  dispatch by dtype: all-float32 to the float32 entry, all-bfloat16 to the
  bfloat16 one (float32 accumulation; conv9's output in bfloat16, the weight
  gradient in float32). Mixed dtypes raise; nothing is converted. With
  ``tf32=True`` (``matmul_precision`` tensorfloat32 and its kin on the
  card) float32 operands go to the TF32 entry instead: both operands
  rounded to TF32 (:func:`round_to_tf32`), products on the tensor cores,
  float32 sums; other dtypes raise. Each launch also counts in
  ``launches_by_dtype[label]`` and in ``launches_by_shape[(pass, label,
  x.shape)]``, label the dtype or "tf32", pass "forward", "dgrad"
  (conv9_fwd called from :class:`ShallowConv`'s backward) or "wgrad"; a
  launch captured into a CUDA graph counts once a replay
  (``ops/launch_capture.py``).
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
  stays float32. With ``tf32=True`` they round both operands to TF32 first
  (the products of two TF32 values are exact in float32).
* :func:`conv9_supported` is the gate ``models/layers.py::Conv2d`` uses:
  stride 1, odd k from 3 to 13, 64 channels in and out in any dtype, or in
  float32 (TF32 off) Cin in :data:`WIDE_CHANNELS` (224-band cubes) to 64. It
  is the JAX gate without its TPU tile rules (W % 128), plus the kernels'
  own k limit and their channel counts. A wide shallow conv's input
  gradient runs on cuDNN on a card (:class:`ShallowConv`), where it is
  faster than the wide kernel.
* The wide entries (float32 only): :func:`conv9_fwd` and
  :func:`conv9_wgrad` take Cin in :data:`WIDE_CHANNELS` with Cout 64 (the
  224 -> 64 forward and its (k, k, 224, 64) weight gradient). They count
  under the passes "wide_forward" and "wide_wgrad" with the shape (B, H, W,
  Cin, Cout), so no key of the 64-channel passes changes. The forward's
  kernels' names hold "wide_f32"; the weight gradient runs
  ``wgrad_c64_kernel<K, 0>`` and ``wgrad_reduce_kernel``, the 64-channel
  entry's kernels at another instantiation.
* :data:`library_passes` counts the shallow conv's passes that ``Conv2d``
  sends to ``F.conv2d`` instead (cuDNN on a card), by (pass, dtype, (B, H,
  W, Cin, Cout)): a run whose shallow conv fell back shows there.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sshslie_torch.ops import _build, at_least_float32, launch_capture

CHANNELS = 64
KERNEL_SIZES = (3, 5, 7, 9, 11, 13)
# The wide float32 entries' channel counts: multiples of 32 up to 256.
WIDE_CHANNELS = tuple(range(32, 257, 32))
# The dtypes the kernels take, and the suffix of each one's C entry.
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The label and C-entry suffix of the TF32 entries (float32 operands).
TF32 = "tf32"


def conv9_supported(shape: Tuple[int, ...], k: int, ci: int, co: int, stride: int = 1,
                    dtype=torch.float32) -> bool:
    """Can the kernels take all three passes of this conv? (Conv2d sends
    everything else to F.conv2d.) 64 -> 64 in any dtype the kernels take;
    Cin in WIDE_CHANNELS -> 64 only in float32 (``dtype`` the operands'
    dtype, or TF32 for float32 under TF32, which has no wide entry)."""
    if not (stride == 1 and k in KERNEL_SIZES and len(shape) == 4 and shape[-1] == ci):
        return False
    if ci == co == CHANNELS:
        return True
    return dtype == torch.float32 and co == CHANNELS and ci in WIDE_CHANNELS


def _wide(ci: int, co: int) -> bool:
    """Channels that take the wide float32 entries rather than the 64-channel ones."""
    return (ci, co) != (CHANNELS, CHANNELS)


def round_to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as PTX ``cvt.rna.tf32.f32``: on the int32 bits, the
    magnitude plus 0x1000 with the low 13 bits then cleared. Inf and NaN
    stay as they are; a magnitude that rounds past the largest finite value
    becomes inf. Returns a new float32 tensor."""
    if t.dtype != torch.float32:
        raise ValueError(f"round_to_tf32 takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    rounded = ((mag + 0x1000) & -0x2000) | (bits & -0x80000000)
    return torch.where(mag >= 0x7F800000, bits, rounded).view(torch.float32)


def _operand(t: torch.Tensor, tf32: bool) -> torch.Tensor:
    t = at_least_float32(t)
    return round_to_tf32(t) if tf32 else t


def conv9_plain(x: torch.Tensor, w: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Stride-1 SAME conv, NHWC x HWIO -> NHWC, as a sum of per-tap products
    in float32 at least, cast to x's dtype; ``tf32``: both operands rounded
    to TF32 first."""
    b, h, wd, _ = x.shape
    k = w.shape[0]
    p = (k - 1) // 2
    xp = F.pad(_operand(x, tf32), (0, 0, p, p, p, p))
    wf = _operand(w, tf32)
    y = xp.new_zeros((b, h, wd, w.shape[-1]))
    for kh in range(k):
        for kw in range(k):
            y += xp[:, kh:kh + h, kw:kw + wd, :] @ wf[kh, kw]
    return y.to(x.dtype)


def conv9_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, k: int, tf32: bool = False) -> torch.Tensor:
    """dw[kh,kw,ci,co] = sum_{b,h,w} xpad[b,h+kh,w+kw,ci] dy[b,h,w,co] -> (k,k,64,64),
    summed and returned in float32 at least; ``tf32``: x and dy rounded to
    TF32 first."""
    b, h, wd, ci = x.shape
    p = (k - 1) // 2
    xp = F.pad(_operand(x, tf32), (0, 0, p, p, p, p))
    dyf = _operand(dy, tf32).reshape(-1, dy.shape[-1])
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


def _check_cuda_operands(name: str, *tensors: torch.Tensor, tf32: bool = False) -> str:
    """Raise unless the operands suit a kernel entry; return the entry's
    suffix ('f32', 'bf16', or 'tf32' for float32 operands with ``tf32``)."""
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
    if tf32:
        if tensors[0].dtype != torch.float32:
            raise ValueError(f"{name}: tf32 takes float32 operands, got {tensors[0].dtype}")
        return TF32
    return KERNEL_DTYPES[tensors[0].dtype]


# The counts are read-modify-writes from every thread that launches (the
# training thread and the async-eval worker): one lock keeps them exact.
_COUNT_LOCK = threading.Lock()
# The pass a conv9_fwd launch counts under in launches_by_shape, per thread:
# "dgrad" while ShallowConv.backward runs it, else "forward".
_PASS = threading.local()
# {(pass, dtype, (B, H, W, Cin, Cout)): count} of the shallow conv's passes
# that Conv2d sent to F.conv2d; reset with the launch counts.
library_passes: dict = {}


def _count(wrapper, label, key: tuple = ()) -> None:
    """One launch, under ``label``: the operands' dtype, or TF32; a launch
    captured into a CUDA graph counts at each replay (``launch_capture``)."""
    if launch_capture.recorded(_count, wrapper, label, key):
        return
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.launches_by_dtype[label] += 1
        wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def count_library_pass(key: tuple) -> None:
    """One pass of a shallow conv that Conv2d sent to F.conv2d, under
    ``key`` (pass, dtype, (B, H, W, Cin, Cout)) in :data:`library_passes`;
    a pass captured into a CUDA graph counts at each replay."""
    if launch_capture.recorded(count_library_pass, key):
        return
    with _COUNT_LOCK:
        library_passes[key] = library_passes.get(key, 0) + 1


def reset_counts() -> None:
    """Set the launch counts of both wrappers, and the library passes, to 0."""
    with _COUNT_LOCK:
        for wrapper in (conv9_fwd, conv9_wgrad):
            wrapper.launches = 0
            wrapper.launches_by_dtype = dict.fromkeys((*KERNEL_DTYPES, TF32), 0)
            wrapper.launches_by_shape = {}
        library_passes.clear()


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


# The float32 entry's units (csrc/conv9.cu, F32Tile): a 4 x 32 pixel output
# tile and 64 / parts of its output channels.
F32_TILE = (4, 32)
F32_PARTS = (1, 2, 4)
# A unit's time over its share of a tile's products, by parts (the finer
# splits load a weight for fewer products), and by the blocks an SM runs at
# once (each puts one warp on each scheduler; one or two leave the
# schedulers idle on load latency, three or more do not). From
# tools/conv_bench.py --parts on an H100 (PERF.md).
F32_PART_COST = {1: 1.0, 2: 1.06, 4: 1.07}
F32_CONCURRENCY_COST = {1: 1.2, 2: 1.04}


def conv9_f32_units(b: int, h: int, w: int, parts: int) -> int:
    """Blocks of the float32 entry for a (b, h, w, 64) input split ``parts`` ways."""
    return b * -(-h // F32_TILE[0]) * -(-w // F32_TILE[1]) * parts


def conv9_f32_load(b: int, h: int, w: int, parts: int, resident: Tuple[int, int]) -> float:
    """The busiest SM's time, in units of one tile's products at full
    concurrency, for a (b, h, w, Cin) input split ``parts`` ways on a card of
    ``resident = (SMs, blocks of the unsplit kernel an SM holds)``: ceil(units
    / SMs) units of 1 / parts of a tile, weighted by F32_PART_COST and by
    F32_CONCURRENCY_COST of the blocks it runs at once (at most that many
    units; a finer split holds at least as many blocks). Cin scales every
    unit alike, so it is not an argument."""
    sms, per_sm = resident
    busiest = -(-conv9_f32_units(b, h, w, parts) // sms)
    concurrent = min(busiest, per_sm)
    return busiest / parts * F32_PART_COST[parts] * F32_CONCURRENCY_COST.get(concurrent, 1.0)


def conv9_f32_parts(b: int, h: int, w: int, k: int, resident: Tuple[int, int]) -> int:
    """Output-channel parts of the float32 entries' units for a (b, h, w,
    Cin) input at kernel size ``k`` on a card of ``resident`` (see
    :func:`conv9_f32_load`): the split with the least load, ties to fewer
    parts. ``k`` changes no unit's share of the work, so not the choice. On
    an H100 (132 SMs, 3 unsplit blocks an SM at k = 9) the 224-band cell's
    wide forward, (8, 128, 128, 224) -> 64 in 1024 tiles, takes parts 1 (load
    8, against 8.48 for 2 and 8.56 for 4)."""
    loads = [(conv9_f32_load(b, h, w, parts, resident), parts) for parts in F32_PARTS]
    return min(loads)[1]


def _library() -> ctypes.CDLL:
    lib = _build.library("conv9")
    for suffix in ("bf16", TF32):
        fn = getattr(lib, f"sshslie_conv_c64_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.sshslie_conv_c64_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.sshslie_conv_c64_f32.restype = ctypes.c_int
    lib.sshslie_conv_c64_f32_scratch.argtypes = [ctypes.c_int] * 5
    lib.sshslie_conv_c64_f32_scratch.restype = ctypes.c_longlong
    lib.sshslie_conv_wide_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.sshslie_conv_wide_f32.restype = ctypes.c_int
    lib.sshslie_conv_wide_f32_scratch.argtypes = [ctypes.c_int] * 6
    lib.sshslie_conv_wide_f32_scratch.restype = ctypes.c_longlong
    lib.sshslie_conv_c64_f32_resident.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.sshslie_conv_c64_f32_resident.restype = ctypes.c_int
    lib.sshslie_conv_wide_f32_resident.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.sshslie_conv_wide_f32_resident.restype = ctypes.c_int
    return lib


# (device index, k, wide) -> (SMs, blocks of the unsplit float32 kernel an
# SM holds): the occupancy query runs once, off every later launch's path.
_F32_RESIDENT: dict = {}


def f32_resident(device: torch.device, k: int, wide: bool = False) -> Tuple[int, int]:
    """(SMs, blocks an SM holds) of the float32 entry's unsplit kernel (64
    output channels a unit; ``wide``: the wide entry's) at ``k`` on ``device``."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), k, wide)
    got = _F32_RESIDENT.get(key)
    if got is None:
        lib = _library()
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            if wide:
                code = lib.sshslie_conv_wide_f32_resident(k, ctypes.byref(sms), ctypes.byref(per_sm))
            else:
                code = lib.sshslie_conv_c64_f32_resident(k, 1, ctypes.byref(sms),
                                                         ctypes.byref(per_sm))
        _build.check(lib, code, "conv9 float32 occupancy query")
        got = _F32_RESIDENT[key] = (sms.value, per_sm.value)
    return got


def _wgrad_library() -> ctypes.CDLL:
    lib = _build.library("conv9_wgrad")
    lib.sshslie_conv9_wgrad_splits.argtypes = [ctypes.c_int] * 3
    lib.sshslie_conv9_wgrad_splits.restype = ctypes.c_int
    lib.sshslie_conv9_wgrad_resident_bf16.argtypes = [ctypes.c_int]
    lib.sshslie_conv9_wgrad_resident_bf16.restype = ctypes.c_int
    lib.sshslie_conv9_wgrad_splits_tf32.argtypes = [ctypes.c_int] * 3
    lib.sshslie_conv9_wgrad_splits_tf32.restype = ctypes.c_int
    for suffix in (*KERNEL_DTYPES.values(), TF32):
        fn = getattr(lib, f"sshslie_conv9_wgrad_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.sshslie_conv9_wgrad_wide_splits.argtypes = [ctypes.c_int] * 4
    lib.sshslie_conv9_wgrad_wide_splits.restype = ctypes.c_int
    lib.sshslie_conv9_wgrad_wide_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.sshslie_conv9_wgrad_wide_f32.restype = ctypes.c_int
    return lib


def conv9_fwd(x: torch.Tensor, w: torch.Tensor, tf32: bool = False,
              parts: Optional[int] = None) -> torch.Tensor:
    """Stride-1 SAME k x k conv, NHWC (B, H, W, 64) x HWIO (k, k, 64, 64) -> NHWC
    in x's dtype (float32 or bfloat16, float32 accumulation); ``tf32``:
    float32 operands rounded to TF32, products on the tensor cores. In
    float32 also (B, H, W, Cin) x (k, k, Cin, 64) -> (B, H, W, 64), Cin in
    WIDE_CHANNELS (the wide entry, counted as "wide_forward").

    CPU tensors take :func:`conv9_plain`. CUDA tensors take the kernel; a
    shape, type or layout the kernel does not take raises. ``parts``: the
    float32 entries' units split that many ways by output channel, one of
    F32_PARTS (None: :func:`conv9_f32_parts`'s choice); every
    split gives the same bits. Not differentiable: see :class:`ShallowConv`.
    """
    _not_differentiable("conv9_fwd", x, w)
    if x.device.type == "cpu":
        return conv9_plain(x, w, tf32)
    suffix = _check_cuda_operands("conv9_fwd", x, w, tf32=tf32)
    k, ci, co = w.shape[0], x.shape[-1], w.shape[-1]
    label = TF32 if tf32 else x.dtype
    if tuple(w.shape) != (k, k, ci, co) or not conv9_supported(x.shape, k, ci, co, 1, label):
        raise ValueError(f"conv9_fwd: unsupported shapes x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"({suffix}; other channels than 64 -> 64 take float32 only)")
    if parts is not None and (suffix != "f32" or parts not in F32_PARTS):
        raise ValueError(f"conv9_fwd: parts {parts} needs float32 operands and one of {F32_PARTS}")
    wide = _wide(ci, co)
    b, h, wd, _ = x.shape
    y = x.new_empty((b, h, wd, co))
    if y.numel() == 0:
        return y
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if wide:
        parts = parts or conv9_f32_parts(b, h, wd, k, f32_resident(x.device, k, wide=True))
        scratch = torch.empty(lib.sshslie_conv_wide_f32_scratch(b, h, wd, ci, k, parts),
                              dtype=torch.float32, device=x.device)
        code = lib.sshslie_conv_wide_f32(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                         scratch.data_ptr(), b, h, wd, ci, k, parts, stream)
    elif suffix == "f32":
        # The planar padded input and the repacked weights the kernel reads.
        parts = parts or conv9_f32_parts(b, h, wd, k, f32_resident(x.device, k))
        scratch = torch.empty(lib.sshslie_conv_c64_f32_scratch(b, h, wd, k, parts),
                              dtype=torch.float32, device=x.device)
        code = lib.sshslie_conv_c64_f32(x.data_ptr(), w.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                                        b, h, wd, k, parts, stream)
    else:
        code = getattr(lib, f"sshslie_conv_c64_{suffix}")(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, k, stream)
    _count(conv9_fwd, label, ("wide_forward", label, (b, h, wd, ci, co)) if wide
           else (getattr(_PASS, "name", "forward"), label, tuple(x.shape)))
    _build.check(lib, code, "conv9 kernel launch")
    return y


def conv9_wgrad(x: torch.Tensor, dy: torch.Tensor, k: int, tf32: bool = False) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME k x k 64 -> 64 conv -> (k, k, 64, 64)
    in float32, from float32 or bfloat16 x and dy; ``tf32``: float32 x and
    dy rounded to TF32, products on the tensor cores. In float32 also x
    (B, H, W, Cin), Cin in WIDE_CHANNELS, and dy (B, H, W, 64) -> (k, k, Cin,
    64) (the wide entry, counted as "wide_wgrad").

    CPU tensors take :func:`conv9_wgrad_plain`. CUDA tensors take the kernel
    (a split reduction over pixel rows into scratch, then a fixed-order sum
    of the partials); a shape, type or layout it does not take raises.
    """
    _not_differentiable("conv9_wgrad", x, dy)
    if x.device.type == "cpu":
        return conv9_wgrad_plain(x, dy, k, tf32)
    suffix = _check_cuda_operands("conv9_wgrad", x, dy, tf32=tf32)
    ci, co = x.shape[-1], dy.shape[-1]
    label = TF32 if tf32 else x.dtype
    if x.shape[:-1] != dy.shape[:-1] or not conv9_supported(x.shape, k, ci, co, 1, label):
        raise ValueError(f"conv9_wgrad: unsupported shapes x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}, k {k} ({suffix}; other channels than 64 -> 64 "
                         "take float32 only)")
    wide = _wide(ci, co)
    b, h, wd, _ = x.shape
    if x.numel() == 0:
        return x.new_zeros((k, k, ci, co), dtype=torch.float32)
    lib = _wgrad_library()
    # float32 and TF32: the kernel's slice count; bfloat16: its resident
    # blocks, from which conv9_wgrad_bf16_splits derives the slice count.
    if wide:
        query = lib.sshslie_conv9_wgrad_wide_splits(b, h, ci, k)
    elif suffix == "bf16":
        query = lib.sshslie_conv9_wgrad_resident_bf16(k)
    elif suffix == TF32:
        query = lib.sshslie_conv9_wgrad_splits_tf32(b, h, k)
    else:
        query = lib.sshslie_conv9_wgrad_splits(b, h, k)
    if query < 0:
        _build.check(lib, -query, "conv9_wgrad occupancy query")
    splits = conv9_wgrad_bf16_splits(b * h, k, query) if suffix == "bf16" else query
    part = torch.empty((splits, k, k, ci, co), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, k, ci, co), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if wide:
        code = lib.sshslie_conv9_wgrad_wide_f32(x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                                                dw.data_ptr(), b, h, wd, ci, k, splits, stream)
    else:
        code = getattr(lib, f"sshslie_conv9_wgrad_{suffix}")(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), b, h, wd, k, splits,
            stream)
    _count(conv9_wgrad, label, ("wide_wgrad", label, (b, h, wd, ci, co)) if wide
           else ("wgrad", label, tuple(x.shape)))
    _build.check(lib, code, "conv9_wgrad kernel launch")
    return dw


reset_counts()


def _library_dgrad(g: torch.Tensor, w: torch.Tensor, x_shape) -> torch.Tensor:
    """The input gradient of a wide shallow conv on a card, from cuDNN
    (``F.conv2d``'s own backward), counted in :data:`library_passes`: at the
    224-band cell's (8, 128, 128, 64) -> 224, cuDNN's float32 call took
    2.46 ms on an H100 and the forward's kernel design, run 64 -> 224, 6.38
    (bound 4.54: cuDNN's FFT algorithm does fewer operations; PERF.md), so
    this pass stays with cuDNN and the wide entries take Cout 64 only.
    NHWC g, HWIO w -> NHWC dx."""
    b, h, wd, ci = x_shape
    dx = torch.nn.grad.conv2d_input((b, ci, h, wd), w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2),
                                    padding=(w.shape[0] - 1) // 2)
    count_library_pass(("dgrad", g.dtype, (b, h, wd, ci, w.shape[-1])))
    return dx.permute(0, 2, 3, 1)


class ShallowConv(torch.autograd.Function):
    """``conv9_fwd(x, w) + b`` with every pass on the conv9 kernels
    (JAX ``pallas_shallow_conv`` with ``_psc_fwd``/``_psc_bwd``; the JAX VJP
    takes dw from XLA, the port from its own ``conv9_wgrad`` kernel).

    x NHWC (B, H, W, 64), w HWIO (k, k, 64, 64), b (64,), all of one dtype,
    float32 or bfloat16; or in float32 x (B, H, W, Cin) and w (k, k, Cin,
    64), Cin in WIDE_CHANNELS: the forward Cin -> 64 and the weight gradient
    (k, k, Cin, 64) on the wide entries, the input gradient 64 -> Cin from
    cuDNN on a card (:func:`_library_dgrad`, faster there), from the plain
    version on the CPU. The gradients come back in that dtype, as in
    ``_psc_bwd``: dx from the conv9 kernel, dw from the float32 weight
    gradient rounded to w's dtype, db a float32 sum cast to it. ``tf32``
    (float32 only) takes the TF32 entries in all three kernel passes. On CPU
    tensors the same passes run on the plain versions.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tf32: bool = False) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.tf32 = tf32
        return conv9_fwd(x, w, tf32) + b

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        # The incoming gradient may be any strided view; the kernels read
        # contiguous NHWC (a copy when it is not already).
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0] and g.is_cuda and _wide(x.shape[-1], w.shape[-1]):
            dx = _library_dgrad(g, w, x.shape)
        elif ctx.needs_input_grad[0]:
            _PASS.name = "dgrad"
            try:
                dx = conv9_fwd(g, conv9_dgrad_weights(w), ctx.tf32)
            finally:
                _PASS.name = "forward"
        if ctx.needs_input_grad[1]:
            dw = conv9_wgrad(x, g, w.shape[0], ctx.tf32).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = at_least_float32(g).sum(dim=(0, 1, 2)).to(w.dtype)
        return dx, dw, db, None


def shallow_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
    """Bias-included, differentiable shallow conv (NHWC, HWIO) on the kernels;
    ``tf32``: float32 operands rounded to TF32 in every pass."""
    return ShallowConv.apply(x, w, b, tf32)
