"""Hand-written CUDA kernels and the plain PyTorch code around them."""

import torch


def at_least_float32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or kept in float64: the casts at the places where the
    JAX package computes in float32 whatever the compute type (a bfloat16 run
    rises to float32; a float64 reference stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))
