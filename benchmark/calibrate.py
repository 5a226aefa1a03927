#!/usr/bin/env python3
"""The readings the limits of ``limits/<cell>.json`` are set from, at the
cell's own size, many seeds in one process (the benchmark's runs never run
this):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--faults] [--window 2]

* program: each seed's set-up (and for a serving cell a short window at the
  cell's load) and its check, as a run makes them;
* control: the reference computed in the rounding the configuration names
  (``control_rounding``: TF32 for float32, float8 for bfloat16) in the
  program's place;
* faults (training): half of each batch left out, and a step that leaves the
  weights and Adam unchanged; for a bfloat16 cell also the witness, the
  reference with its operands rounded to bfloat16 in the program's place.

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def train_readings(cell, args, device) -> None:
    import torch

    from benchmark.harness import spec
    from benchmark.reference import train as rt

    td = spec.driver(cell.traffic["kind"])
    rounding = cell.config["control_rounding"]
    witness = ["witness"] if cell.config["precision"] == "bfloat16" else []
    plan = ([(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
            + [(s, f) for s in (args.control_seeds if args.faults else [])
               for f in ["half_batch", "unchanged"] + witness])
    for seed, what in plan:
        t = time.perf_counter()
        s = td.setup(cell, seed, device)
        td.release(s)

        def ref_run(coeffs, lr, **kw):
            terms, g1, p3 = rt.train(s.params0, s.cubes, s.cfg.channels, seed, s.cfg.batch_size,
                                     s.cfg.patch_size, coeffs, lr, td.CHECKED_STEPS, **kw)
            return terms, g1, p3

        numbers_of = {
            "program": None,
            "control": lambda c, lr: ref_run(c, lr, rnd=rounding),
            "half_batch": lambda c, lr: ref_run(c, lr, half_batch=True),
            "witness": lambda c, lr: ref_run(c, lr, rnd="bf16"),
            "unchanged": lambda c, lr: (ref_run(c, 0.0)[0],
                                        {k: torch.zeros_like(v) for k, v in s.params0.items()},
                                        s.params0),
        }[what]
        emit(workload=cell.name, seed=seed, reading=what, **td.check(s, numbers_of, detail=True),
             seconds=time.perf_counter() - t)
        del s
        torch.cuda.empty_cache()


def serve_readings(cell, args, device) -> None:
    import torch

    from benchmark.harness import spec

    sd = spec.driver(cell.traffic["kind"])
    rounding = cell.config["control_rounding"]
    for seed in args.seeds + args.control_seeds:
        control = seed in args.control_seeds
        s = sd.setup(cell, seed, device)
        win, attempted, failed = sd.window(s, args.window, False)
        sd.release(s)
        row = sd.check(s, rounding if control else None)
        emit(workload=cell.name, seed=seed, reading="control" if control else "program", **row,
             kept=len(s.kept), requests=win.items, failed=failed)
        del s
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--window", type=float, default=2.0, help="serving: seconds of load a seed")
    p.add_argument("--device", default="cuda")
    p.add_argument("--traffic-dir", default=None, help="a directory of traffic/ to rehearse with")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import spec

    cell = spec.load_cell(ROOT, args.workload, bench_dir=args.traffic_dir or spec.BENCH_DIR)
    device = torch.device(args.device)
    if spec.driver(cell.traffic["kind"]).WORK == "train":
        train_readings(cell, args, device)
    else:
        serve_readings(cell, args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
