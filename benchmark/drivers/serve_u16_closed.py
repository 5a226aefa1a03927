"""Traffic of kind "serve_u16_closed": one closed-loop client, as a lab's
batch job that sends its cubes one after another and waits for each answer.
A request is one cube of 12-bit counts sent through
``EnhanceService.enhance_encoded(q, "u16", wire="u16_wire")`` (the path the
HTTP server takes for a u16 body, without the transport), the answer S's
u16 codes. The card and the copies pace it, so the requests a second are
the service's capacity for one client.

Set-up makes the weights and a pool of cubes from the seed, builds the
service (no micro-batcher: one client never has two requests to batch),
warms its bucket and sends one request through the encoded path. In the
window the client sends the next request as soon as it holds the last
answer, until ``--seconds`` have passed and the first ``checked_from``
requests are sent; a request is timed from the call until the codes are
held. Cubes come from the pool in an order drawn from
the seed; the answers of ``checked`` requests (drawn from the seed among the
first ``checked_from``) are kept for the check.

The traffic file gives ``pool``, ``cube_hw``, ``checked`` and
``checked_from``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import compare, inputs, program, yardstick
from benchmark.harness.trace import note, profiled, span
from benchmark.harness.window import Window
from benchmark.reference import train as ref_train

WORK = "serve"
TRACE_SECONDS = 4.0


@dataclass
class ServeSetup:
    cfg: object
    service: object
    pool: List[np.ndarray]              # (H, W, C) uint16 counts
    params0: Dict[str, torch.Tensor]
    cell_config: dict
    traffic: dict
    seed: int
    next_request: int = 0
    kept: List[tuple] = field(default_factory=list)   # (pool index, codes, scale, offset)


def _request(s: ServeSetup, j: int):
    """One request of pool cube ``j`` -> its S_wire answer, or None."""
    try:
        with span("request"):
            out = s.service.enhance_encoded(s.pool[j], "u16", scale=1.0, offset=0.0,
                                            wire="u16_wire")["S_wire"]
    except Exception:
        return None
    return out if out["q"].shape == s.pool[j].shape else None


def setup(cell, seed: int, device: torch.device) -> ServeSetup:
    from sshslie_torch.device import set_matmul_precision
    from sshslie_torch.serve import EnhanceService

    t = cell.traffic
    cfg = program.config(cell.config, device=str(device), seed_value=seed, serve_max_batch=1)
    set_matmul_precision(cfg)
    bands = cfg.channels
    h, w = t["cube_hw"]
    started = time.perf_counter()
    params0 = inputs.weights(seed, bands, device)
    pool = [c.to(torch.int32).cpu().numpy().astype(np.uint16)
            for c in inputs.counts(seed, 3, t["pool"], h, w, bands, device)]
    note("inputs", started)
    s = ServeSetup(cfg, EnhanceService(cfg, bands, state_dict=params0), pool, params0,
                   cell.config, t, seed)
    s.service.warmup([(h, w)])
    if _request(s, 0) is None:
        raise RuntimeError(f"{cell.name}: the warm-up request failed")
    note("service, warmup and one request", started)
    return s


def _requests(s: ServeSetup, seconds: float):
    """The closed loop for ``seconds`` (and at least until the first
    ``checked_from`` requests are sent), the last request answered ->
    (latencies, attempted, failed, seconds)."""
    t = s.traffic
    checked = set(np.random.default_rng([s.seed, 7]).choice(
        t["checked_from"], t["checked"], replace=False).tolist())
    order = np.random.default_rng([s.seed, 8, s.next_request])
    latencies: List[float] = []
    attempted = failed = 0
    begin = time.perf_counter()
    while time.perf_counter() - begin < seconds or s.next_request < t["checked_from"]:
        j = int(order.integers(len(s.pool)))
        sent = time.perf_counter()
        out = _request(s, j)
        done = time.perf_counter()
        attempted += 1
        if out is None:
            failed += 1
        else:
            latencies.append(done - sent)
            if s.next_request in checked:
                s.kept.append((j, out["q"], out["scale"], out["offset"]))
        s.next_request += 1
    return latencies, attempted, failed, time.perf_counter() - begin


def window(s: ServeSetup, seconds: float, trace: bool):
    """``seconds`` of requests, then with ``trace`` a traced stretch of
    TRACE_SECONDS -> (Window, attempted, failed)."""
    bands = s.cfg.channels
    h, w = s.traffic["cube_hw"]
    stats0 = s.service.stats()
    latencies, attempted, failed, elapsed = _requests(s, seconds)
    stats1 = s.service.stats()
    region = {"requests": stats1["requests"] - stats0["requests"],
              "seconds": (stats1["requests"] * stats1["avg_seconds"]
                          - stats0["requests"] * stats0["avg_seconds"])}
    win = Window(WORK, s.cfg.precision, elapsed, len(latencies),
                 yardstick.request_flops(bands, h, w), region, latencies)
    if trace:
        program.reset_launches()
        with profiled(True) as traced:
            more, more_attempted, more_failed, _ = _requests(s, TRACE_SECONDS)
        win.trace, win.traced_items, win.launches = traced[0], len(more), program.launches()
        attempted += more_attempted
        failed += more_failed
    return win, attempted, failed


def end_to_end(s: ServeSetup, win: Window) -> dict:
    """serve_rps: requests answered a second over the untraced window."""
    return {"serve_rps": win.items / win.seconds} if win.items else {}


def release(s: ServeSetup) -> None:
    s.service.close()
    s.service = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(s: ServeSetup, rnd=None) -> Dict[str, float]:
    """The reference's S of each kept answer's cube (one forward a cube),
    against the answer -> {"s_gap": ...}. With ``rnd`` the reference in a
    lower precision stands in for the program's answers (the control)."""
    cc = s.cell_config
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = next(iter(s.params0.values())).device
    gmin, gmax, bands = float(cc["global_min"]), float(cc["global_max"]), int(cc["channels"])
    refs, gap = {}, 0.0
    for j, q, scale, offset in s.kept:
        if j not in refs:
            counts = torch.from_numpy(s.pool[j].astype(np.float32)).to(dev)
            ref = ref_train.enhance(s.params0, counts, bands, gmin, gmax)
            low = None if rnd is None else ref_train.enhance(s.params0, counts, bands, gmin,
                                                             gmax, rnd)
            refs[j] = (ref, low)
        ref, low = refs[j]
        got = (low if rnd is not None else
               torch.from_numpy(q.astype(np.float32)).to(dev) * float(scale) + float(offset))
        gap = max(gap, compare.s_gap(got, ref))
    return {"s_gap": gap if s.kept else float("inf")}
