"""The traced window: ``torch.profiler`` over the window, its Chrome trace
written under TMPDIR, read back and deleted, and reduced to what the
per-layer metrics and the breakdown read.

* ``span(name)`` marks what the benchmark's host is doing (a
  ``record_function`` range named ``bench.<name>``); ``bench.window``
  bounds the traced window.
* busy: the union of the card's kernels, copies and sets inside the window;
  the idle gaps are the rest, each named by the innermost benchmark span on
  the host at its middle and the innermost host operation under it.
* kernel time by name, and by class (``KERNEL_CLASSES``, by name patterns).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."
REACH = 64                    # host operations looked back through for a gap's innermost
NAME_CHARS = 160

# Kernel classes by name: the first pattern found in the name wins.
KERNEL_CLASSES = (
    ("hand kernels (conv9, conv9_wgrad, flash)", ("conv_c64", "wgrad_c64", "wgrad_reduce", "flash_")),
    ("FFT (cuFFT)", ("fft", "FFT")),
    ("Adam (foreach)", ("multi_tensor_apply", "foreach")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "index", "Memcpy", "Memset")),
    ("convolutions (cuDNN)", ("cudnn", "xmma_fprop", "xmma_dgrad", "xmma_wgrad", "implicit_gemm",
                              "wgrad_alg", "dgrad_", "conv")),
    ("matrix products (cuBLAS)", ("gemm", "cublas", "Kernel2")),
)


def kernel_class(name: str) -> str:
    return next((c for c, pats in KERNEL_CLASSES if any(p in name for p in pats)), "other")


def note(what: str, since: float) -> None:
    """One line of set-up timing on standard error."""
    print(f"set-up: {what} done at {time.perf_counter() - since:.3f} s", file=sys.stderr,
          flush=True)


def span(name: str):
    """A host span of the benchmark (a no-op when no profiler records)."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)   # name -> (s, count)
    idle: List[Tuple[str, float]] = field(default_factory=list)           # label -> s, longest first

    def seconds_matching(self, patterns) -> float:
        return sum(s for n, (s, _) in self.kernels.items() if any(p in n for p in patterns))

    def class_seconds(self, cls: str) -> float:
        return sum(s for n, (s, _) in self.kernels.items() if kernel_class(n) == cls)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, (s, _) in ops],
                "idle_gaps": [[n, s] for n, s in self.idle[:top]]}


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a list that holds the window's TraceSummary once the block ends
    (stays empty when ``enabled`` is False). The block must end with the
    card synchronised."""
    out: List[TraceSummary] = []
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with span("window"):
                yield out
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        out.append(summarise(events))
    finally:
        os.remove(path)


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of (start, end) rows."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    intervals = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(intervals[:, 1])
    new = np.ones(len(intervals), dtype=bool)
    new[1:] = intervals[1:, 0] > ends[:-1]
    starts = intervals[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(intervals) - 1]
    return np.stack([starts, ends[last]], axis=1)


def summarise(events: List[dict]) -> TraceSummary:
    """Reduce a Chrome trace's events (times in microseconds)."""
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == SPAN_PREFIX + "window"
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels: Dict[str, Tuple[float, int]] = {}
    for e in device:
        s, n = kernels.get(e["name"], (0.0, 0))
        kernels[e["name"]] = (s + float(e.get("dur", 0)) * 1e-6, n + 1)
    iv = np.array([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in device],
                  dtype=np.float64).reshape(-1, 2)
    iv = np.clip(iv, w0, w1)
    busy = _merge(iv[iv[:, 1] > iv[:, 0]])
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return TraceSummary((w1 - w0) * 1e-6, busy_us * 1e-6, kernels, _label_gaps(events, gaps))


def _innermost(starts: np.ndarray, ends: np.ndarray, t: float, reach: int) -> int:
    """Index of the latest-starting of the ``reach`` events that started last
    before ``t`` and still cover it (events sorted by start; a nested event
    starts after the one it is inside), or -1."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - reach, -1), -1):
        if ends[j] >= t:
            return j
    return -1


def _label_gaps(events: List[dict], gaps: np.ndarray) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was doing at each gap's middle: the
    innermost benchmark span, then the innermost host operation."""
    host = [e for e in events if e.get("ph") == "X" and "dur" in e
            and (e.get("cat") in HOST_CATS
                 or (e.get("cat") == "user_annotation" and e["name"] != SPAN_PREFIX + "window"))]
    host.sort(key=lambda e: float(e["ts"]))
    groups = {}
    for mine in (True, False):
        rows = [e for e in host if e["name"].startswith(SPAN_PREFIX) == mine]
        starts = np.array([float(e["ts"]) for e in rows], dtype=np.float64)
        ends = starts + np.array([float(e["dur"]) for e in rows], dtype=np.float64)
        groups[mine] = ([e["name"] for e in rows], starts, ends)
    totals: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        names, starts, ends = groups[True]
        j = _innermost(starts, ends, mid, len(names))
        label = names[j][len(SPAN_PREFIX):] if j >= 0 else "no benchmark span"
        names, starts, ends = groups[False]
        j = _innermost(starts, ends, mid, REACH)
        if j >= 0:
            label += " / " + names[j][:NAME_CHARS]
        totals[label] = totals.get(label, 0.0) + (g1 - g0) * 1e-6
    return sorted(totals.items(), key=lambda kv: -kv[1])
