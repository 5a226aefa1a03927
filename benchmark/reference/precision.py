"""Operand rounding for the controls: the reference computed one precision
below the one a configuration states.

``None`` leaves float32 alone. ``"tf32"`` rounds to TF32 (10 mantissa bits,
to nearest), what a float32 product with TF32 on reads. ``"fp8"`` rounds
to float8 e4m3 (3 mantissa bits), the step below bfloat16. ``"bf16"`` (7
mantissa bits) is no control: it shows what bfloat16 operands alone do to
the numbers compared. The rounding is
straight-through: the backward passes the gradient unchanged, as a product
in a lower precision that accumulates in float32 gives it.
"""

from __future__ import annotations

from typing import Optional

import torch

ROUNDINGS = (None, "tf32", "bf16", "fp8")
_FP8_MAX = 448.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """To nearest, ties away from zero, as PTX ``cvt.rna.tf32.f32`` (finite x)."""
    bits = x.detach().contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    return (((mag + 0x1000) & -0x2000) | (bits & -0x80000000)).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)


def rounded(x: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """``x`` with its values rounded to ``mode``, straight-through."""
    if mode is None:
        return x
    if mode == "tf32":
        r = _round_tf32(x)
    elif mode == "bf16":
        r = x.detach().to(torch.bfloat16).to(torch.float32)
    elif mode == "fp8":
        r = _round_fp8(x)
    else:
        raise ValueError(f"unknown rounding {mode!r}; one of {ROUNDINGS}")
    return x + (r - x).detach()
