#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``sshslie_torch`` on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix,
the driver of the mix's kind and its per-layer metrics are found by name
from ``BENCHMARK.json`` (``harness/spec.py``). Set-up makes the inputs from the seed on the card and
warms the cell's shapes; the window runs the traffic for ``--seconds``
(traced, ``--trace 1``, for at most the drivers' TRACE_SECONDS); then the
program's state is freed and the plain reference (``reference/``) checks
what the window's entries produced (``harness/compare.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers are the last lines of standard error. Without a CUDA card,
or with JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "sshslie_tpu")


def forbidden_loaded() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def quantity(metric: str) -> str:
    """The driver's quantity an end-to-end metric reports: its name up to the
    first dot (``train_mpbs.bf16`` is ``train_mpbs`` in the cells it lists,
    under a bound of its own)."""
    return metric.split(".")[0]


def execute(cell, seed: int, seconds: float, trace: bool, device, started: float,
            limits: dict) -> dict:
    """Set-up, window and check of ``cell`` -> the result's fields."""
    import torch

    from benchmark.harness import compare, spec

    driver = spec.driver(cell.traffic["kind"])
    state = driver.setup(cell, seed, device)
    setup_s = time.perf_counter() - started
    win, attempted, failed = driver.window(state, seconds, trace)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release(state)
    checks = compare.judge(driver.check(state), limits)
    if trace:
        metrics = spec.read_metrics(cell.per_layer, win)
    else:
        e2e = {"setup_s": setup_s, **driver.end_to_end(state, win)}
        metrics = {m.name: {"value": e2e[quantity(m.name)], "unit": m.unit}
                   for m in cell.end_to_end if quantity(m.name) in e2e}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": compare.passed(checks) and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"], dev["window_s"] = win.trace.busy_s, win.trace.window_s
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = checks
    return result


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import compare, spec

    cell = spec.load_cell(ROOT, args.workload)
    limits = compare.load_limits(cell.name)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {count}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     STARTED, limits)
    found = forbidden_loaded()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
