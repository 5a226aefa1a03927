#!/usr/bin/env python3
"""Sets of runs of one cell, one process a run, and the spread of each
metric, as a bound is set from them:

    python3 benchmark/spread.py --workload <cell> --seeds 11 12 13 14 15 16 \
        [--sets 2] [--seconds 10] [--trace 0] [--out runs.jsonl]

Each set runs every seed once, in order; the sets use the same seeds. For
each metric and set: the median, and the spread, the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a share
of the median. ``setup_s`` of a set's first run (which may build the
kernels) is left out of its spread. Every run's last line goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - start
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        result = {"error": proc.stderr[-2000:]}
    result.update(seed=seed, rc=proc.returncode, wall_s=wall)
    return result


def spread(values) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    for k in range(args.sets):
        runs = []
        for seed in args.seeds:
            r = one_run(args.workload, seed, args.seconds, args.trace)
            r["set"] = k
            runs.append(r)
            print(json.dumps(r), flush=True)
            if out:
                out.write(json.dumps(r) + "\n")
                out.flush()
        ok = [r for r in runs if r.get("metrics")]
        names = sorted({n for r in ok for n in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            if name == "setup_s" and k == 0:
                vals = vals[1:]
            row = {"set": k, "metric": name, "n": len(vals),
                   "median": statistics.median(vals) if vals else None,
                   "spread": spread(vals) if len(vals) >= 2 else None, "values": vals}
            print(json.dumps(row), flush=True)
        print(json.dumps({"set": k, "correct": [r.get("correct") for r in runs],
                          "checks": [r.get("checks") for r in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
