"""The process group and its collectives, as ``sshslie_tpu/parallel/distributed.py``.

* :func:`initialize_distributed` joins the ``torch.distributed`` group that a
  launcher describes (torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``) or that the caller names. Without either
  it is a single process and makes no group. The backend is NCCL on the
  card and gloo on the CPU unless the caller names one. Where a launcher's
  environment is present a failed init raises (JAX's rule): a rank that
  carried on alone would disagree with the others on the world size and
  hang them in their first collective.
* :func:`process_batch_slice` is this rank's sample range of a global batch:
  by its index on a mesh's data axis, else by its rank.
* The collectives the port runs, each a no-op without a group (a 1-process
  mesh): :func:`all_mean_` (every tensor replaced by its sum over the ranks
  divided by the world size or by its own divisor, one ``all_reduce`` over
  one flat buffer: a step's gradients and terms), :func:`all_sum_`,
  :func:`all_max`, :func:`broadcast_` and :func:`broadcast_object` (from
  rank 0), :func:`all_gather` and :func:`all_gather_cat`, :func:`barrier`.
  ``all_mean_``, ``all_sum_`` and the gathers take a ``group`` (a
  ``dist.new_group`` of a mesh axis; None, the default group). They use only
  ``all_reduce``, ``broadcast`` and ``all_gather``, which NCCL and gloo both
  run on CUDA tensors. A failed collective raises. :func:`broadcast_tensor`
  is rank 0's tensor on every rank, the others giving its shape.
* :class:`Commands` carries rank 0's commands to the other ranks through the
  group's store, on the host: a rank that waits for the next command sits in
  no collective, so an idle wait meets no group timeout (the mesh service,
  ``serve.py``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def active() -> bool:
    """Is there a process group?"""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def backend() -> str:
    return str(dist.get_backend()) if active() else ""


def local_rank() -> int:
    """This process's card index on its host: torchrun's ``LOCAL_RANK``, else
    the group rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           device: str = "", timeout: Optional[float] = None) -> bool:
    """Join the process group → whether there is one (False: a single process
    without a launcher). A group that exists already is kept as it is.

    ``backend`` None means NCCL, or gloo when ``device`` is 'cpu'; NCCL runs
    on the card of ``LOCAL_RANK``. ``init_method`` (e.g.
    'tcp://127.0.0.1:29500'), ``world_size`` and ``rank`` override the
    launcher's environment. ``timeout`` (seconds) is the group's collective
    timeout (torch's default when None)."""
    if active():
        return True
    launcher = [k for k in _LAUNCHER_ENV if os.environ.get(k)]
    if init_method is None and world_size is None and not launcher:
        return False
    if backend is None:
        backend = "gloo" if str(device).startswith("cpu") else "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA card; the port runs a group on "
                               "the CPU only when asked for (config `device: cpu`: gloo)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    kwargs = {"init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    try:
        dist.init_process_group(backend, **kwargs)
    except Exception as e:
        where = (f"a launcher's environment is present ({', '.join(launcher)} set)" if launcher
                 else f"init_method {init_method!r}")
        raise RuntimeError(f"torch.distributed.init_process_group({backend!r}) failed; "
                           f"{where}") from e
    return True


def leave() -> None:
    """Leave the process group (destroy it in this process)."""
    if active():
        dist.destroy_process_group()


def process_batch_slice(global_batch: int, mesh=None) -> slice:
    """The [start, stop) sample range this process should load/crop: its
    share by its index on ``mesh``'s data axis (the ranks of a space group
    share one), or by its rank without a mesh."""
    n, i = (world_size(), rank()) if mesh is None else (mesh.data_size, mesh.data_index)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def all_mean_(tensors: Sequence[torch.Tensor], divisors: Optional[Sequence[float]] = None,
              group=None) -> None:
    """Replace each tensor (all on one device) by its sum over the ranks of
    ``group`` divided by its divisor (default: the group's size, the mean):
    one ``all_reduce`` over one flat float32 buffer."""
    if not active() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if divisors is None:
        flat.div_(dist.get_world_size(group))
    offset = 0
    for i, t in enumerate(tensors):
        n = t.numel()
        part = flat[offset:offset + n]
        t.copy_((part if divisors is None else part / divisors[i]).view_as(t))
        offset += n


def all_sum_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` summed over the ranks of ``group``, in place."""
    if active():
        dist.all_reduce(tensor, group=group)
    return tensor


def all_max(value: float, device) -> float:
    """The largest of the ranks' values."""
    if not active():
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values of the tensors (all on one device) on every rank, in
    place: one ``broadcast`` of one flat buffer."""
    if not active() or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.broadcast(flat, src=0)
    offset = 0
    for t in tensors:
        n = t.numel()
        with torch.no_grad():
            t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def broadcast_tensor(tensor: Optional[torch.Tensor], shape: Sequence[int], dtype: torch.dtype,
                     device) -> torch.Tensor:
    """Rank 0's ``tensor`` on every rank, on ``device``: rank 0 passes it (on
    any device), the others None, receiving into a new tensor of ``shape``
    and ``dtype`` that a header read first gave them. One ``broadcast``."""
    if rank() == 0:
        out = tensor.to(device=device, dtype=dtype).contiguous()
    else:
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if active():
        dist.broadcast(out, src=0)
    return out


def broadcast_object(obj, device):
    """Rank 0's ``obj`` (picklable; the port's own values only) on every
    rank: its length, then its bytes, broadcast as tensors on ``device``."""
    if not active():
        return obj
    data = pickle.dumps(obj) if rank() == 0 else b""
    n = torch.tensor([len(data)], dtype=torch.int64, device=device)
    dist.broadcast(n, src=0)
    buf = torch.zeros(int(n), dtype=torch.uint8, device=device)
    if rank() == 0:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    return obj if rank() == 0 else pickle.loads(buf.cpu().numpy().tobytes())


def all_gather(tensor: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (one shape on every rank of ``group``), in the
    group's rank order, on every rank. 16-bit floats travel as their bit
    patterns, which every backend gathers."""
    if not active():
        return [tensor]
    t = tensor.contiguous()
    bits = t.dtype in (torch.bfloat16, torch.float16)
    if bits:
        t = t.view(torch.int16)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return [p.view(tensor.dtype) for p in parts] if bits else parts


def all_gather_cat(tensor: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``tensor`` (one shape on every rank of ``group``)
    concatenated along ``dim`` in rank order, on every rank."""
    if not active():
        return tensor
    return torch.cat(all_gather(tensor, group), dim=dim)


def barrier(device) -> None:
    """Wait, on the host, for every rank: an ``all_reduce`` of one element on
    ``device``, then its value read back. NCCL returns from the call once
    the reduce is queued on the card; the read makes the host wait for it,
    so files a rank wrote before its barrier are there when the others pass
    theirs."""
    if active():
        t = torch.zeros(1, device=device)
        dist.all_reduce(t)
        t.item()


# How long one store wait of a follower lasts before it looks at its stop
# flag and waits again. A store wait is no collective, so the group's timeout
# does not bound it; c10d logs a line for each wait that times out.
_COMMAND_WAIT = datetime.timedelta(minutes=5)


class Commands:
    """Rank 0's commands to the other ranks, through the group's store (the
    rendezvous store of ``init_process_group``): on the host and in no
    collective, so that a rank waiting for the next command meets no group
    timeout however long it waits (NCCL's watchdog aborts a rank that idles
    in a ``broadcast`` after 10 minutes, gloo raises after 30).

    Rank 0 ``post``s a picklable header under the next sequence number; the
    other ranks take the headers in that order (:meth:`next`) and then enter
    the command's collectives. Rank 0 drops a command's key (:meth:`done`)
    once those collectives have completed, which needs every rank to have
    read it. A rank that stops following says so (:meth:`leave`), and rank 0
    waits for all of them (:meth:`wait_left`), so that the store outlives
    their last read. Every rank of the group makes the channel at once: rank
    0 numbers it, so two channels of one group keep their keys apart."""

    def __init__(self, device):
        self._store = dist.distributed_c10d._get_default_store()
        n = self._store.add("sshslie/channels", 1) if rank() == 0 else 0
        self._prefix = f"sshslie/{broadcast_object(n, device)}/"
        self._seq = 0

    def _key(self, seq: int) -> str:
        return f"{self._prefix}{seq}"

    def post(self, header) -> None:
        self._seq += 1
        self._store.set(self._key(self._seq), pickle.dumps(header))

    def done(self) -> None:
        self._store.delete_key(self._key(self._seq))

    def next(self, stopped: Callable[[], bool]):
        """The next header, waited for on the host; None once ``stopped()``."""
        key = self._key(self._seq + 1)
        while not stopped():
            try:
                self._store.wait([key], _COMMAND_WAIT)
            except dist.DistStoreError:      # the wait's own timeout
                continue
            self._seq += 1
            return pickle.loads(self._store.get(key))
        return None

    def leave(self) -> None:
        self._store.add(self._prefix + "left", 1)

    def wait_left(self, timeout: float) -> bool:
        """Wait up to ``timeout`` seconds for every other rank to leave."""
        deadline = time.monotonic() + timeout
        while self._store.add(self._prefix + "left", 0) < world_size() - 1:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True
