"""The operations and bytes of the port's wide float32 kernels: the shallow
conv from other input-channel counts than 64 (224 -> 64 for 224-band cubes,
and its (k, k, 224, 64) weight gradient). Their launches count under the
passes "wide_forward" and "wide_wgrad" with the shape (B, H, W, Cin, Cout)
(``ops/conv9.py``). Each input byte is read once and each output byte
written once, as in ``yardstick``; a pass's bound is ``yardstick.bound_s``
of this work."""

from __future__ import annotations

from typing import Tuple


def wide_conv_work(shape, esize: int, k: int = 9) -> Tuple[float, float, float]:
    """One k x k Cin -> Cout pass over (B, H, W, Cin, Cout): x and w read,
    y written."""
    b, h, w, ci, co = shape
    return (2.0 * b * h * w * k * k * ci * co,
            esize * (b * h * w * (ci + co) + k * k * ci * co), 0.0)


def wide_wgrad_work(shape, esize: int, k: int = 9) -> Tuple[float, float, float]:
    """The weight gradient over (B, H, W, Cin, Cout): x and dy read, the
    float32 dW written once."""
    b, h, w, ci, co = shape
    return (2.0 * b * h * w * k * k * ci * co,
            esize * b * h * w * (ci + co) + 4.0 * k * k * ci * co, 0.0)
