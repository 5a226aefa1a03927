"""The height split over the ranks of a mesh axis: the collectives that JAX
gets from GSPMD (``sshslie_tpu/parallel/mesh.py::batch_space_sharding``,
``sshslie_tpu/evaluate.py::ShardedInferencer``), written out.

A :class:`Shard` is this rank's share of an axis: its process group, its
index and the axis's size. Rank i of n holds rows ``[i*H/n, (i+1)*H/n)`` of
every activation, so every share is even. The layers that read rows beyond
the share (``models/layers.py``, ``models/illum_adjust.py``) go through
three ``torch.autograd.Function``s, each of which runs the same collectives
in the same order on every rank of the group:

* :func:`halo_rows` ``(x, up, down)``: the previous rank's last ``up`` rows
  above x and the next rank's first ``down`` rows below it (one
  ``all_gather`` of every rank's boundary rows); the edge ranks take zeros,
  which is SAME's padding. Backward: each halo row's gradient goes back to
  the rank that owns the row and is added there (one ``all_gather``).
* :func:`gather_rows`: the whole height on every rank, for a computation
  every rank repeats and then keeps its own rows of (the attention).
  Backward: the sum over the ranks of each one's gradient of this rank's
  rows (``all_reduce``, then the rank's slice).
* :func:`gather_rows_replicated`: the whole height, for a computation every
  rank repeats whole and keeps whole (the training loss). Backward: the
  rank's slice, since every rank holds the same gradient.
* :func:`space_mean`: the mean over the ranks of a per-rank mean (the
  squeeze of ``SEBlock``); ``all_reduce`` both ways.

A shard of size 1 runs no collective. The stride-2 pyramid stays aligned
only where the height is a multiple of 8·n (:func:`check_rows`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from sshslie_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's share of a mesh axis: rows ``[index*H/size, (index+1)*H/size)``
    of every height it splits. ``group`` None is the default group."""

    group: Any
    index: int
    size: int

    def rows(self, h: int) -> slice:
        """This rank's rows of a height ``h`` (a multiple of ``size``)."""
        if h % self.size:
            raise ValueError(f"height {h} does not split over {self.size} ranks")
        per = h // self.size
        return slice(self.index * per, (self.index + 1) * per)


def check_rows(h: int, shard: Shard, what: str = "the height") -> None:
    """The port splits heights that are multiples of 8·n, which keep every
    rank's share even at H/2, H/4 and H/8; JAX's GSPMD splits any height
    that n divides, unevenly below."""
    if h % (8 * shard.size):
        raise NotImplementedError(
            f"{what} {h} is not a multiple of 8 x {shard.size} (the space axis's size): the "
            "port's halo exchanges need an even share of every level of the stride-2 pyramid "
            "(a documented difference from JAX, ROADMAP.md)")


def take_rows(x: torch.Tensor, shard: Shard, dim: int) -> torch.Tensor:
    """This rank's rows of ``x`` along ``dim`` (no collective)."""
    rows = shard.rows(x.shape[dim])
    return x.narrow(dim, rows.start, rows.stop - rows.start)


def _all_reduce(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``t`` summed over the group, in float32 at least, in t's dtype."""
    wide = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
    buf = t.to(dtype=wide, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(buf, group=shard.group)
    return buf.to(t.dtype)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: Shard, up: int, down: int, dim: int):
        h = x.shape[dim]
        if up > h or down > h:
            raise ValueError(f"a halo of {up} and {down} rows needs a share of at least that "
                             f"many, have {h}")
        ctx.shard, ctx.up, ctx.down, ctx.dim, ctx.h = shard, up, down, dim, h
        i, n = shard.index, shard.size
        shape = list(x.shape)
        if n == 1:
            top = bottom = None
        else:
            # One gather of every rank's (first `down` | last `up`) rows.
            parts = distributed.all_gather(
                torch.cat([x.narrow(dim, 0, down), x.narrow(dim, h - up, up)], dim), shard.group)
            top = parts[i - 1].narrow(dim, down, up) if i > 0 else None
            bottom = parts[i + 1].narrow(dim, 0, down) if i < n - 1 else None
        if top is None:
            top = x.new_zeros(shape[:dim] + [up] + shape[dim + 1:])
        if bottom is None:
            bottom = x.new_zeros(shape[:dim] + [down] + shape[dim + 1:])
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        shard, up, down, dim, h = ctx.shard, ctx.up, ctx.down, ctx.dim, ctx.h
        dx = g.narrow(dim, up, h).clone()
        i, n = shard.index, shard.size
        if n > 1:
            # One gather of every rank's (top halo | bottom halo) gradients:
            # the next rank's top halo is this rank's last `up` rows, the
            # previous rank's bottom halo its first `down` rows.
            parts = distributed.all_gather(
                torch.cat([g.narrow(dim, 0, up), g.narrow(dim, up + h, down)], dim), shard.group)
            if i < n - 1:
                dx.narrow(dim, h - up, up).add_(parts[i + 1].narrow(dim, 0, up))
            if i > 0:
                dx.narrow(dim, 0, down).add_(parts[i - 1].narrow(dim, up, down))
        return dx, None, None, None, None


def halo_rows(x: torch.Tensor, shard: Shard, up: int, down: int, dim: int = 2) -> torch.Tensor:
    """x with ``up`` rows of the previous rank above it and ``down`` rows of
    the next below it along ``dim`` (zeros beyond the edge ranks)."""
    return _HaloRows.apply(x, shard, up, down, dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: Shard, dim: int, summed: bool):
        ctx.shard, ctx.dim, ctx.summed, ctx.h = shard, dim, summed, x.shape[dim]
        if shard.size == 1:
            return x.clone()
        return torch.cat(distributed.all_gather(x, shard.group), dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        shard, dim, h = ctx.shard, ctx.dim, ctx.h
        if ctx.summed and shard.size > 1:
            g = _all_reduce(g, shard)
        return g.narrow(dim, shard.index * h, h).clone(), None, None, None


def gather_rows(x: torch.Tensor, shard: Shard, dim: int = 2) -> torch.Tensor:
    """Every rank's rows of x along ``dim``, for a computation each rank
    repeats and keeps its own rows of; the backward sums the ranks'
    gradients of this rank's rows."""
    return _GatherRows.apply(x, shard, dim, True)


def gather_rows_replicated(tensors: Sequence[torch.Tensor], shard: Shard,
                           dim: int) -> Tuple[torch.Tensor, ...]:
    """Every rank's rows of each tensor along ``dim`` (one gather of them
    concatenated on the last axis), for a computation each rank repeats and
    keeps whole; the backward is this rank's slice of the gradient."""
    sizes = [t.shape[-1] for t in tensors]
    whole = _GatherRows.apply(torch.cat(list(tensors), dim=-1), shard, dim, False)
    return tuple(whole.split(sizes, dim=-1))


class _SpaceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: Shard):
        ctx.shard = shard
        return _all_reduce(x, shard) / shard.size

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        return _all_reduce(g, ctx.shard) / ctx.shard.size, None


def space_mean(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The mean over the group of every rank's ``x`` (each rank's mean over
    an equal share: the mean over the whole height)."""
    if shard.size == 1:
        return x
    return _SpaceMean.apply(x, shard)
