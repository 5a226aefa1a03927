"""The kernel wrappers' launch counts across a CUDA graph.

``conv9_fwd``, ``conv9_wgrad`` and ``flash_attention`` count each launch as
the host issues it. A launch captured into a CUDA graph runs at each replay
of the graph and not at its capture, so while :func:`capturing` is open a
launch issued on a stream that is capturing is recorded instead of counted
(:func:`recorded`), and :func:`replayed` counts the recorded launches once
for each replay: the counts stay the number of times the kernels ran. A
launch of another thread on a stream that is not capturing (the async
eval's) is counted as it is issued. The backward of a captured step runs on
autograd's device thread, on the capturing stream, so the record is the
process's and not a thread's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Optional, Tuple

import torch

# The launches of the capture underway, as (count, args): None when none is.
_RECORD: Optional[List[Tuple[Callable, tuple]]] = None


def recorded(count: Callable, *args) -> bool:
    """True, with ``count(*args)`` recorded for the replays, when the launch
    it would count was issued on a capturing stream while :func:`capturing`
    is open; else False, and the caller counts the launch."""
    record = _RECORD
    if record is None or not torch.cuda.is_current_stream_capturing():
        return False
    record.append((count, args))      # one append: atomic across threads
    return True


@contextlib.contextmanager
def capturing() -> Iterator[List[Tuple[Callable, tuple]]]:
    """The launches captured inside the block, counted nowhere: the list to
    pass to :func:`replayed` at each replay of the graph."""
    global _RECORD
    launches: List[Tuple[Callable, tuple]] = []
    _RECORD = launches
    try:
        yield launches
    finally:
        _RECORD = None


def replayed(launches: List[Tuple[Callable, tuple]]) -> None:
    """Count one replay's launches, each under its wrapper's own lock."""
    for count, args in launches:
        count(*args)
