"""What the program's own spans say: the tracer of
``sshslie_torch.observability`` (``TRACER``), which records while a profiler
records, so its aggregate is the traced stretch's, and keeps the first
instance of each span of the process (set-up's). Each reading is None where
the program has no tracer (a checkout that predates it) or no such span."""

from __future__ import annotations

from typing import Optional


def _tracer():
    from sshslie_torch import observability

    return getattr(observability, "TRACER", None)


def total_s(name: str) -> Optional[float]:
    """Seconds in every recorded ``name`` span, or None."""
    tracer = _tracer()
    row = None if tracer is None else tracer.summary().get(name)
    return None if row is None else row["total_s"]


def first_s(name: str) -> Optional[float]:
    """Seconds of the process's first ``name`` span, or None."""
    tracer = _tracer()
    rec = None if tracer is None else tracer.cold().get(name)
    return None if rec is None else rec.seconds


def per_item_ms(w, kind: str, name: str) -> Optional[float]:
    """Milliseconds of ``name`` spans a step or request of the traced
    stretch, in a cell of ``kind``; else None."""
    if w.kind != kind or w.trace is None or w.traced_items == 0:
        return None
    s = total_s(name)
    return None if s is None else 1e3 * s / w.traced_items
