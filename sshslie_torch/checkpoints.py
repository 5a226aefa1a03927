"""Checkpoint files of a run directory, as ``sshslie_tpu/checkpoints.py``
(``epoch_path``, ``latest_path``, ``copy_checkpoint``,
``prune_checkpoints``), for the reference ``.pth`` files (format and I/O in
``interop.py``)."""

from __future__ import annotations

import os
import re

CKPT_SUFFIX = ".pth"


def latest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "model_epoch_latest" + CKPT_SUFFIX)


def epoch_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"model_epoch_{epoch}" + CKPT_SUFFIX)


def copy_checkpoint(src: str, dst: str) -> str:
    """Atomic byte-copy of a checkpoint (temporary file, fsync, rename): the
    rolling ``model_epoch_latest`` without a second serialisation."""
    with open(src, "rb") as fh:
        blob = fh.read()
    tmp = dst + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, dst)
    return dst


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete the oldest ``model_epoch_{N}`` files, keeping the newest ``keep``
    (``model_epoch_latest`` is never pruned)."""
    entries = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"model_epoch_(\d+)" + re.escape(CKPT_SUFFIX), name)
        if m:
            entries.append((int(m.group(1)), name))
    entries.sort()
    for _, name in entries[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, name))
