"""Checkpoint files of a run directory, as ``sshslie_tpu/checkpoints.py``
(``epoch_path``, ``latest_path``, ``best_path``, ``copy_checkpoint``,
``prune_checkpoints``, the background ``AsyncWriter``), for the reference
``.pth`` files (format and I/O in ``interop.py``)."""

from __future__ import annotations

import os
import re

CKPT_SUFFIX = ".pth"


def latest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "model_epoch_latest" + CKPT_SUFFIX)


def best_path(ckpt_dir: str) -> str:
    """Rolling best-eval-PSNR checkpoint (``checkpoint_best: true``): a copy of
    the winning ``model_epoch_{N}`` file, never pruned (the prune pattern
    matches numeric epochs only)."""
    return os.path.join(ckpt_dir, "model_epoch_best" + CKPT_SUFFIX)


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


class AsyncWriter:
    """Ordered single-worker background writer for checkpoint I/O
    (``checkpoint_async: true``): serialisation, fsync, the latest-copy and
    the prune of an epoch checkpoint run off the training thread. The caller
    hands it host copies of the state, taken synchronously.

    * ordering: one worker, FIFO, so a queued best-copy sees the epoch file
      the save before it wrote;
    * fail-fast: the first failed write raises at the next ``submit``,
      ``drain`` or ``close``.
    """

    def __init__(self):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending: "deque" = deque()

    def submit(self, fn, *args) -> None:
        while self._pending and self._pending[0].done():
            self._pending.popleft().result()
        self._pending.append(self._pool.submit(fn, *args))

    def drain(self) -> None:
        while self._pending:
            self._pending.popleft().result()

    def close(self) -> None:
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)
