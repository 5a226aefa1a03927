"""What a run hands its per-layer metric readers about its window.

A traced run (``--trace 1``) runs the same untraced window as any run, then
a traced stretch of the same traffic: the profiler costs the host a few
microseconds an operation, so rates and host-paced shares come from the
untraced window, and what the card did from the traced stretch."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from benchmark.harness.trace import TraceSummary


@dataclass
class Window:
    kind: str                 # "train" or "serve"
    precision: str            # the configuration's: "float32" or "bfloat16"
    seconds: float            # the untraced window's length
    items: int                # steps or requests completed in it
    item_flops: float         # model operations of one step or request (yardstick)
    service: dict = field(default_factory=dict)    # serve: {"requests", "seconds"} of its region
    latencies: List[float] = field(default_factory=list)   # serve: each request's seconds
    trace: Optional[TraceSummary] = None           # the traced stretch
    traced_items: int = 0                          # steps or requests completed in it
    launches: dict = field(default_factory=dict)   # the traced stretch's, program.launches()

    def busy_per_item(self) -> Optional[float]:
        """Seconds the card was busy a step or request, in the traced stretch."""
        if self.trace is None or self.traced_items == 0:
            return None
        return self.trace.busy_s / self.traced_items
