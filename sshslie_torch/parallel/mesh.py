"""The mesh of the port, as ``sshslie_tpu/parallel/mesh.py``.

JAX's ``Mesh`` is an array of devices; the port's :class:`Mesh` describes a
``torch.distributed`` process group: one process per GPU (rank r on
``cuda:LOCAL_RANK``). The choice of the JAX package stands: the model is
small, so the weights and Adam's state are replicated on every rank and the
global batch is split across the ranks of the ``data`` axis
(``shard_batch_size``); each step reduces the gradients over the ranks with
one ``all_reduce`` (``train.py``, ``parallel/distributed.py``).

A 2-D ``mesh_shape`` "DxS" has the axes ``(data, space)``, JAX's dp×sp:
rank r sits at (r // S, r % S), the row-major reshape of JAX's device list.
Each axis has its process group, the ranks that share this rank's other
coordinate (``dist.new_group``, every group made on every rank in one
order), and :meth:`Mesh.shard` describes this rank's share of an axis for
``parallel/spatial.py``. With ``space_axis`` the patch height is split over
the space ranks (``Trainer``); without it the space ranks compute replicas,
as JAX does with an axis that nothing is sharded on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from sshslie_torch.parallel import distributed
from sshslie_torch.parallel.spatial import Shard


def parse_mesh_shape(spec: str) -> Tuple[int, ...]:
    """'8' -> (8,); '4x2' -> (4, 2); '' -> the world size on a 1-D mesh."""
    if not spec:
        return (distributed.world_size(),)
    return tuple(int(part) for part in spec.lower().split("x"))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group as a mesh: its axes' names and sizes, this process's
    rank and the group's backend ('' for a 1-process mesh without a group),
    and one process group an axis (None: the default group, or no group)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    backend: str
    groups: Tuple[Any, ...] = dataclasses.field(default=(), compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as JAX ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's index on each axis (row-major over the ranks)."""
        out, r = [], self.rank
        for s in reversed(self.sizes):
            out.append(r % s)
            r //= s
        return tuple(reversed(out))

    @property
    def data_size(self) -> int:
        """The size of the data axis (the first)."""
        return self.sizes[0]

    @property
    def data_index(self) -> int:
        """This rank's index on the data axis."""
        return self.coords[0]

    def shard(self, axis: str) -> Shard:
        """This rank's share of ``axis``: its group, index and size."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no {axis!r} axis (axes {self.axis_names})")
        i = self.axis_names.index(axis)
        group = self.groups[i] if self.groups else None
        return Shard(group, self.coords[i], self.sizes[i])

    def __str__(self) -> str:
        axes = ", ".join(f"{n!r}: {s}" for n, s in zip(self.axis_names, self.sizes))
        return f"Mesh({axes}; rank {self.rank}, backend {self.backend or 'none'})"


def make_mesh(mesh_shape: str = "", axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """The mesh of the current process group; default 1-D ('data',) over
    every rank. The shape must use every rank, one process per GPU: launch N
    processes (``torchrun --nproc_per_node N``) for ``mesh_shape: "N"``."""
    world = distributed.world_size()
    shape = parse_mesh_shape(mesh_shape) if mesh_shape else (world,)
    if axis_names is None:
        if len(shape) > 2:
            raise ValueError(
                f"mesh_shape {mesh_shape!r} has {len(shape)} axes; the "
                "framework shards batch ('data') and height ('space') only — "
                "use a 1-D or 2-D shape, or pass axis_names explicitly"
            )
        axis_names = ("data",) if len(shape) == 1 else ("data", "space")
    elif len(axis_names) != len(shape):
        raise ValueError(
            f"axis_names {tuple(axis_names)} does not match mesh shape {shape}"
        )
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world} "
                         f"(one process per GPU: launch {n} with torchrun)")
    rank = distributed.rank()
    groups = (None,) if len(shape) == 1 else _axis_groups(shape, rank)
    return Mesh(tuple(axis_names), shape, rank, distributed.backend(), groups)


def _axis_groups(shape: Tuple[int, ...], rank: int) -> Tuple[Any, Any]:
    """(data group, space group) of ``rank`` on a (D, S) mesh: the ranks of
    its space index, and those of its data index. Every rank makes every
    group, in one order (``dist.new_group``'s rule)."""
    if not distributed.active():
        return (None, None)
    d_size, s_size = shape
    data_group = space_group = None
    for d in range(d_size):
        g = dist.new_group([d * s_size + s for s in range(s_size)])
        if d == rank // s_size:
            space_group = g
    for s in range(s_size):
        g = dist.new_group([d * s_size + s for d in range(d_size)])
        if s == rank % s_size:
            data_group = g
    return (data_group, space_group)


def shard_batch_size(global_batch: int, mesh: Mesh, data_axis: str = "data") -> int:
    """Validate the global batch divides the data axis; return per-device size."""
    n = mesh.shape[data_axis]
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-parallel size {n}"
        )
    return global_batch // n
