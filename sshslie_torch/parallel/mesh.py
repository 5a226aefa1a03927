"""The data-parallel mesh of the port, as ``sshslie_tpu/parallel/mesh.py``.

JAX's ``Mesh`` is an array of devices; the port's :class:`Mesh` describes a
``torch.distributed`` process group: one process per GPU (rank r on
``cuda:LOCAL_RANK``), the ``data`` axis as long as the world size. The
choice of the JAX package stands: the model is small, so the weights and
Adam's state are replicated on every rank and the global batch is split
across ranks (``shard_batch_size``); each step averages the gradients over
the ranks with one ``all_reduce`` (``train.py``, ``parallel/distributed.py``).

A 2-D ``mesh_shape`` (data × space, JAX's dp×sp) is not ported yet
(ROADMAP.md queue 1, item 7) and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from sshslie_torch.parallel import distributed


def parse_mesh_shape(spec: str) -> Tuple[int, ...]:
    """'8' -> (8,); '4x2' -> (4, 2); '' -> the world size on a 1-D mesh."""
    if not spec:
        return (distributed.world_size(),)
    return tuple(int(part) for part in spec.lower().split("x"))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group as a mesh: its axes' names and sizes, this process's
    rank and the group's backend ('' for a 1-process mesh without a group)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    backend: str

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
    if len(shape) != 1:
        raise NotImplementedError(
            f"mesh_shape {mesh_shape!r}: a 2-D mesh (data x space, dp x sp) is not ported yet "
            "(ROADMAP.md queue 1, item 7)")
    if shape[0] != world:
        raise ValueError(f"mesh shape {shape} needs {shape[0]} devices, have {world} "
                         f"(one process per GPU: launch {shape[0]} with torchrun)")
    return Mesh(tuple(axis_names), shape, distributed.rank(), distributed.backend())


def shard_batch_size(global_batch: int, mesh: Mesh, data_axis: str = "data") -> int:
    """Validate the global batch divides the data axis; return per-device size."""
    n = mesh.shape[data_axis]
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-parallel size {n}"
        )
    return global_batch // n
