"""Where the port runs (the CUDA card, or the CPU only when asked for), and
the card's float32 product precision."""

from __future__ import annotations

from typing import Optional, Union

import torch

from sshslie_torch.config import Config, matmul_tf32
from sshslie_torch.parallel import distributed


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """The device an entry point runs on.

    '' / None / 'cuda' / 'gpu' mean the first CUDA card and raise when there is
    none; 'cpu' (or a CPU ``torch.device``) is the only way onto the CPU.
    Under a process group (``parallel/distributed.py``) they mean the card of
    this rank, ``cuda:LOCAL_RANK``, made the current card; a rank without a
    card of its own raises. An explicit 'cuda:N' is taken as it is.
    """
    if isinstance(device, torch.device):
        dev = device
    elif device in (None, "", "gpu", "cuda"):
        dev = torch.device("cuda")
        if distributed.active():
            dev = torch.device("cuda", distributed.local_rank())
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the CPU only when asked "
            "for (config `device: cpu`, or device=torch.device('cpu'))"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is not None and distributed.active():
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {distributed.rank()} has no card of its own: {dev} asked for, "
                f"{torch.cuda.device_count()} card(s) visible (one process per GPU)")
        torch.cuda.set_device(dev)
    return dev


def set_matmul_precision(cfg: Config) -> bool:
    """Set ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` from ``cfg.matmul_precision``
    (``config.matmul_tf32``) and return what was set: True runs cuDNN's and
    cuBLAS's float32 convolutions and products in TF32 on the card. The
    only place in the package that writes the two switches; they act on the
    card only (the CPU stays float32)."""
    tf32 = matmul_tf32(cfg.matmul_precision)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return tf32
