"""The numbers that decide ``correct``, and their limits.

Training (the program's first three steps, taken in set-up by the window's
own call, against the reference's three steps from the same weights and
crops):

* ``loss_gap``: the largest |L - L_ref| / |L_ref| over the three steps'
  total losses;
* ``grad_gap``: the first gradient as Adam holds it after step 1
  (exp_avg / (1 - beta1)), by the worst leaf: the gap between the two
  norms of a leaf over the larger of the reference's norm of that leaf and
  of the median leaf;
* ``change_gap``: the same measure of each leaf's change over the three
  steps. Leaves whose reference gradient is under a thousandth of the
  median leaf's (the key bias under softmax) move by round-off alone and
  are left out.
* ``loss1_gap``, ``rec1_gap``: the first step's loss gap and its
  reconstruction term's (mean |R I - x|, which reads the batch's samples and
  no finite difference): steadier numbers, for a cell whose other numbers its
  own precision swings (``limits/<cell>.json`` says which numbers a cell
  compares).

Serving: ``s_gap``, the largest |S - S_ref| over the span of S_ref, in
counts, over the answers a run keeps (drawn from the seed).

Each cell's limits are ``limits/<cell>.json``: {number: {"limit": ...}}
with the readings they were set from.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterable, List, Optional

import torch

from benchmark.harness.spec import BENCH_DIR, check_name

STILL_SHARE = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tree.items()}


def _median(values: Iterable[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    return 0.5 * (vs[(n - 1) // 2] + vs[n // 2])


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), median norm(ref))}."""
    pn, rn = _norms(prog), _norms(ref)
    med = _median(rn.values())
    names = list(rn) if keep is None else list(keep)
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in names}


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    rn = _norms(ref_grads)
    med = _median(rn.values())
    return [k for k, v in rn.items() if v >= STILL_SHARE * med]


def _gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def train_numbers(prog_terms, prog_grad1, prog_p0, prog_p3,
                  ref_terms, ref_grad1, ref_p3, detail: bool = False) -> Dict[str, float]:
    """The numbers a training cell may compare (its limits file names
    which), from each step's terms ({name: value}), the first gradients and
    the weights; with ``detail`` also each step's loss gap, each term's gap
    at step 1 and the worst leaves."""
    steps = [_gap(a["total_loss"], b["total_loss"]) for a, b in zip(prog_terms, ref_terms)]
    keep = moving_leaves(ref_grad1)
    change = {k: prog_p3[k] - prog_p0[k] for k in prog_p0}
    ref_change = {k: ref_p3[k] - prog_p0[k] for k in prog_p0}
    grads, changes = leaf_gaps(prog_grad1, ref_grad1), leaf_gaps(change, ref_change, keep)
    out = {"loss_gap": max(steps), "loss1_gap": steps[0],
           "rec1_gap": _gap(prog_terms[0]["L_reconstruction"], ref_terms[0]["L_reconstruction"]),
           "grad_gap": max(grads.values()), "change_gap": max(changes.values())}
    if detail:
        out.update(step_loss_gaps=steps,
                   terms1={k: _gap(prog_terms[0][k], v) for k, v in ref_terms[0].items()},
                   grad_worst=max(grads, key=grads.get),
                   change_worst=max(changes, key=changes.get),
                   still=sorted(set(prog_p0) - set(keep)))
    return out


def s_gap(prog_counts: torch.Tensor, ref_counts: torch.Tensor) -> float:
    span = float(ref_counts.max() - ref_counts.min())
    return float((prog_counts.float() - ref_counts).abs().max()) / span


def load_limits(cell: str, bench_dir: str = BENCH_DIR) -> Dict[str, float]:
    with open(os.path.join(bench_dir, "limits", check_name(cell, "cell") + ".json")) as fh:
        return {k: float(v["limit"]) for k, v in json.load(fh).items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {"value", "limit"}} for each number the cell's limits name,
    in their order (a value that is not finite reads as the string "nan" or
    "inf", and fails)."""
    return {k: {"value": numbers[k] if math.isfinite(numbers[k]) else str(numbers[k]),
                "limit": v} for k, v in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(isinstance(c["value"], float) and c["value"] <= c["limit"]
                                for c in checks.values())
