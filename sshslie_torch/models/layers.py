"""Building blocks with PyTorch-default semantics, as ``sshslie_tpu/models/layers.py``.

Layout: inside the nets, activations are NCHW-shaped tensors, and the model's
NHWC input reaches them as a permuted view, so their memory is channels_last
(physically NHWC) and the conv kernel takes them without a copy. Parameters
keep torch's own layouts and names (Conv2d OIHW, ConvTranspose2d IOHW, Linear
(out, in)), so the reference state dict loads as it is.

* :class:`Conv2d`: ``nn.Conv2d(k, stride, padding=(k-1)//2)``; symmetric zero
  padding, which at stride 2 is the JAX package's explicit pad pair. Shapes
  and dtypes that ``ops/conv9.py::conv9_supported`` takes go to the CUDA
  kernel when the impl asks for it ('kernel', or 'auto' on CUDA; the 224 ->
  64 shallow conv of 224-band cubes in float32 too); everything else goes
  to ``F.conv2d``, as the JAX package sends them to ``lax.conv``, and a
  shallow conv (impl not 'torch') that goes there counts its passes in
  ``conv9.library_passes``. Its ``tf32``
  flag (``matmul_precision`` below float32) takes the kernels' TF32 entries
  for float32 operands on CUDA; ``F.conv2d``, ``ConvTranspose2d`` and
  ``Dense`` follow cuDNN's and cuBLAS's own TF32 switches
  (``device.set_matmul_precision``), and the CPU stays float32.
* :class:`ConvTranspose2d`: ``nn.ConvTranspose2d(k3, s2, p1, op1)``; the JAX
  package's flipped, input-dilated conv is this op.
* :class:`Dense`: ``nn.Linear``.
* :func:`nearest_resize`: ``F.interpolate(mode='nearest')`` index math,
  src = floor(dst * in/out) in float32, written out as the JAX package does.

Height sharding (the space axis, ``parallel/spatial.py``): a Conv2d or
ConvTranspose2d whose ``space`` is set (a ``Shard``, set like ``tf32`` by
``models/enhance.py::shard_space``) holds only its rank's rows of the
height and computes only its rank's rows of the output. It takes the rows
its taps read beyond the share from its neighbours (``halo_rows``) and pads
only the width:

* k x k, stride 1: (k-1)/2 rows each side; on the CUDA kernel, which pads
  SAME, the kernel runs on the rows plus the halo and (k-1)/2 rows are
  cropped each side;
* stride s, padding p: output row i reads input rows s*i - p .. s*i - p + k - 1,
  so the rank needs p rows from the previous rank and k - s - p from the
  next (1 and 0 at k 3, s 2);
* the transposed conv (k 3, s 2, p 1, op 1): its output rows [2a, 2b) read
  input rows a .. b, one row from the next rank; the rows past 2b are
  cropped.

Every layer draws its initial weights and biases from U(-1/sqrt(fan_in),
1/sqrt(fan_in)), PyTorch's default envelope, from an explicit generator.

Precision (JAX ``layers.py:68-89, 120-136, 152-154``): parameters are stored
in float32. A layer whose ``compute_dtype`` is set (``precision: bfloat16``;
``LowLightEnhanceNet`` sets it on every layer) casts its input and its
parameters to that dtype, runs the product in it, and adds the bias after
the product, in it, as the JAX layers do. No ``torch.autocast``: the layers
cast where the JAX package casts, and the nets cast their outputs back to
float32 where it does. ``compute_dtype`` None computes in the input's dtype
with the bias fused into the product.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sshslie_torch.ops import conv9
from sshslie_torch.parallel.spatial import Shard, halo_rows


def _uniform_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Conv2d(nn.Module):
    """k x k conv, padding (k-1)//2, OIHW weight, with the shallow-conv dispatch."""

    compute_dtype: Optional[torch.dtype] = None
    tf32: bool = False
    space: Optional[Shard] = None

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 impl: str = "torch", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.stride, self.impl = k, stride, impl
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch))
        fan_in = in_ch * k * k
        _uniform_(self.weight, fan_in, generator)
        _uniform_(self.bias, fan_in, generator)

    def _kernel_tf32(self, x: torch.Tensor) -> bool:
        """The kernels' TF32 entries: float32 operands on CUDA with ``tf32``."""
        return self.tf32 and x.is_cuda and x.dtype == torch.float32

    def _use_kernel(self, x: torch.Tensor, w: Optional[torch.Tensor] = None) -> bool:
        if self.impl == "torch" or (self.impl == "auto" and not x.is_cuda):
            return False
        out_ch, in_ch = (self.weight if w is None else w).shape[:2]
        return conv9.conv9_supported((x.shape[0], x.shape[2], x.shape[3], in_ch),
                                     self.k, in_ch, out_ch, self.stride,
                                     conv9.TF32 if self._kernel_tf32(x) else x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_with(x, self.weight, self.bias)

    def conv_with(self, x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
        """This conv with ``weight`` (OIHW) and ``bias`` (None: no bias) in its
        parameters' place: the band-sharded forward's slices of them."""
        x, w = _cast(self.compute_dtype, x, weight)
        b = bias if bias is None else _cast(self.compute_dtype, bias)[0]
        p = (self.k - 1) // 2
        halo = self.space is not None and p > 0
        if halo:
            # The rows beyond this rank's share come from its neighbours.
            x = halo_rows(x, self.space, p, max(self.k - self.stride - p, 0))
        if b is not None and self._use_kernel(x, w):
            y = conv9.shallow_conv(x.permute(0, 2, 3, 1).contiguous(),
                                   w.permute(2, 3, 1, 0).contiguous(), b, self._kernel_tf32(x))
            y = y.permute(0, 3, 1, 2)
            # The kernel pads SAME: on a halo'd share its edge rows are cropped.
            return y[:, :, p:y.shape[2] - p] if halo else y
        if self.impl != "torch":
            self._count_library_passes(x, w)
        pad = (0, p) if halo else p
        if self.compute_dtype is None or b is None:
            return F.conv2d(x, w, b, stride=self.stride, padding=pad)
        return F.conv2d(x, w, None, stride=self.stride, padding=pad) + b[:, None, None]

    def _count_library_passes(self, x: torch.Tensor, w: torch.Tensor) -> None:
        """The passes of this shallow conv that F.conv2d is about to run: the
        forward, and the input and weight gradients that autograd records
        for the backward (counted now, with the forward)."""
        grad = torch.is_grad_enabled()
        key = (x.shape[0], x.shape[2], x.shape[3], w.shape[1], w.shape[0])
        for name, runs in (("forward", True), ("dgrad", grad and x.requires_grad),
                           ("wgrad", grad and w.requires_grad)):
            if runs:
                conv9.count_library_pass((name, x.dtype, key))


class ConvTranspose2d(nn.Module):
    """``nn.ConvTranspose2d(k, stride, padding=(k-1)//2, output_padding)``, IOHW weight."""

    compute_dtype: Optional[torch.dtype] = None
    space: Optional[Shard] = None

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, stride: int = 2,
                 output_padding: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.stride, self.output_padding = k, stride, output_padding
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch))
        # PyTorch's ConvTranspose2d init takes fan_in = weight.size(1) * k * k.
        fan_in = out_ch * k * k
        _uniform_(self.weight, fan_in, generator)
        _uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self.compute_dtype, x, self.weight, self.bias)
        p, s = (self.k - 1) // 2, self.stride
        kw = dict(stride=s, padding=p, output_padding=self.output_padding)
        rows = None
        if self.space is not None:
            # Output rows [s*a, s*b) read input rows a - (k-1-p)//s .. b - 1 + (p-1)//s + 1.
            up, rows = (self.k - 1 - p) // s, s * x.shape[2]
            x = halo_rows(x, self.space, up, (p - 1) // s + 1)
        if self.compute_dtype is None:
            y = F.conv_transpose2d(x, w, b, **kw)
        else:
            y = F.conv_transpose2d(x, w, None, **kw) + b[:, None, None]
        return y if rows is None else y[:, :, s * up: s * up + rows]


class Dense(nn.Module):
    """``nn.Linear``: (out, in) weight."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        _uniform_(self.weight, in_features, generator)
        _uniform_(self.bias, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self.compute_dtype, x, self.weight, self.bias)
        if self.compute_dtype is None:
            return F.linear(x, w, b)
        return F.linear(x, w) + b


def _cast(dtype: Optional[torch.dtype], *tensors: torch.Tensor):
    """The tensors in ``dtype``, or as they are when it is None."""
    return tensors if dtype is None else tuple(t.to(dtype) for t in tensors)


def conv_block(conv: nn.Module, relu: bool) -> nn.Sequential:
    """``Sequential(conv[, ReLU])``: the reference's module nesting, hence its
    ``<name>.0.weight`` state-dict keys."""
    return nn.Sequential(conv, nn.ReLU()) if relu else nn.Sequential(conv)


def nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(x, size, mode='nearest')`` for NCHW tensors:
    dst index d reads src floor(d * in/out)."""
    in_h, in_w = x.shape[2], x.shape[3]
    out_h, out_w = size
    if (in_h, in_w) == (out_h, out_w):
        return x
    if out_h % in_h == 0 and out_w % in_w == 0:
        return x.repeat_interleave(out_h // in_h, dim=2).repeat_interleave(out_w // in_w, dim=3)
    idx_h = torch.floor(torch.arange(out_h, dtype=torch.float32, device=x.device)
                        * (in_h / out_h)).long()
    idx_w = torch.floor(torch.arange(out_w, dtype=torch.float32, device=x.device)
                        * (in_w / out_w)).long()
    return x[:, :, idx_h][:, :, :, idx_w]
