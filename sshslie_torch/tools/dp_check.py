"""Data parallelism over the cards of one host, held against one card.

    python -m sshslie_torch.tools.dp_check [--nproc 4] [--size 512] [--device cpu]

Run from the repository's root (it takes ``chip_smoke.py``'s stock training
values and launch counters). On a synthetic dataset from a numpy seed (N
training cubes of (size/2)^2 x 64, two test cubes of size^2 x 64 with their
ground truth) it runs the CLI's ``train_and_test`` twice, each process
through ``runner.main(parse_args(argv))``: once as one process without a
mesh, and once under ``torchrun --standalone --nproc_per_node N`` with
``--mesh_shape N`` (NCCL, one card a rank; gloo with ``--device cpu``).
Both take the stock values at a global batch of N, 128^2 patches (size/4
when smaller), 2 epochs of one step with an eval each, and ``eval_sharded: true`` with
``eval_shard_mode: band`` (the mesh run's evals and test phase split the
bands across the ranks; the one-process run ignores the key, as JAX does
without a mesh). Every process writes its epoch terms, its launches by
shape, its test output directory and seconds. Then one process runs the
test phase on the mesh run's checkpoint without a mesh, and N ranks run it
with ``eval_sharded`` in the default mode (the height split over the N
ranks, ``ShardedInferencer``). Last, the space axis (N = 2 or 4): one step
at the stock global batch 2 (two training cubes, one epoch of ``phase:
train`` with the height-sharded eval) on one process and under ``torchrun``
with ``--mesh_shape (N/2)x2 --space_axis space`` (dp x sp: the patch height
split over two ranks). Then the mesh service: ``phase: serve`` on the mesh
run's checkpoint, once in one process and once on N ranks (``--mesh_shape
N``: rank 0 answers HTTP on 127.0.0.1, the other ranks follow), each
answering the two test cubes and five warm requests of the first (its
X-Inference-Seconds), and on N ranks the broadcast of one test cube's
float32 bytes from rank 0 timed alone beside it (median of 5).

Checks: the ranks' epoch terms are equal; epoch 1, the first step from the
same weights, within 2e-5 of each term of the one-process run's (PERF.md's
float32 step gate; epoch 2 is reported, not gated: Adam turns the first
step's rounding into a drift that says nothing of the reduction); on a card
each rank launched exactly its share (conv9 (1, p, p, 64) forward 2, dgrad 1
and conv9_wgrad 2 a step at N = global batch; conv9 (1, size, size, 64) and
flash once a cube evaluated or tested); rank 0's band-sharded test S within
1e-5 of the span of the one-process test phase's S on the same checkpoint,
and so is the height-sharded test S (its s/cube reported beside one
process's); the dp x sp step: the ranks' terms equal, each term within 2e-5
of the one-process step's, launches exact a rank (conv9 (1, p/2 + 8, p, 64)
forward 2 and dgrad 1 and conv9_wgrad 2 at b = 1 a data rank, conv9 (1,
size/2 + 8, size, 64) and flash once a cube evaluated); the mesh service's
S of each test cube within 1e-5 of the span of the one-process test
phase's, as is the one-process service's, launches exact a rank (conv9 (1,
size/N + 8, size, 64) and flash once a forward: the warmup and 7 requests).
Prints one JSON line with every number and the failed checks, then the card
line; exits 1 when a check failed. No part of the port imports it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2024


def _serve_client(out: str, cfg, report: dict) -> None:
    """In place of rank 0's accept loop (the one process's without a mesh):
    serve on a thread, post each test cube (its S to ``out``) and five warm
    requests of the first (their X-Inference-Seconds), then return, which
    stops the service (and its followers)."""
    from chip_smoke import _http
    from sshslie_torch import serve

    def client(server):
        server.start()
        files = sorted(f for f in os.listdir(cfg.test_data) if f.endswith(".mat"))
        bodies = []
        for i, name in enumerate(files):
            with open(os.path.join(cfg.test_data, name), "rb") as fh:
                bodies.append(fh.read())
            status, rh, data = _http(server, "POST", "/enhance", bodies[-1])
            if status != 200:
                raise RuntimeError(f"POST {name}: HTTP {status}: {data[:300]!r}")
            np.save(f"{out}.S{i}.npy", serve.decode_cube_response(data, rh))
        cube = serve.decode_cube_response(bodies[0], {})
        body, headers = serve.encode_cube(np.ascontiguousarray(cube), "f32")
        report["x_seconds"] = [float(_http(server, "POST", "/enhance?encoding=f32", body,
                                           headers)[1]["X-Inference-Seconds"]) for _ in range(5)]

    follow = serve.EnhanceServer.serve_forever
    serve.EnhanceServer.serve_forever = lambda server: (
        follow(server) if server.httpd is None else client(server))


def _broadcast_ms(shape, device) -> list:
    """ms of five broadcasts of a float32 tensor of ``shape`` from rank 0,
    each ending in a synchronize (rank 0's host clock)."""
    import torch

    from sshslie_torch.parallel import distributed

    x = torch.zeros(shape, device=device)
    times = []
    for _ in range(6):
        distributed.barrier(device)
        t = time.perf_counter()
        distributed.broadcast_tensor(x, shape, torch.float32, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t) * 1e3)
    return times[1:]


def _worker(out: str, argv: list) -> int:
    """One process of a run: the CLI's main, then its report to ``out``."""
    import torch

    from chip_smoke import counts_to_json, shape_counts, zero_counts
    from sshslie_torch import runner
    from sshslie_torch.config import parse_args
    from sshslie_torch.device import resolve_device
    from sshslie_torch.ops import attention, conv9
    from sshslie_torch.parallel import distributed

    zero_counts(conv9, attention)
    cfg = parse_args(argv)
    report = {}
    serving = cfg.phase == "serve"
    if serving:
        _serve_client(out, cfg, report)
        # Joined here, so that the group outlives runner.main for the timing.
        distributed.initialize_distributed(device=cfg.device)
    result = runner.main(cfg)
    trainer = result.get("trainer")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    rank = int(os.environ.get("RANK", "0"))
    report.update({"rank": rank, "timestamp": cfg.timestamp,
                   "test_result_dir": cfg.test_result_dir, "seconds": result.get("seconds"),
                   "counts": counts_to_json(shape_counts(conv9, attention))})
    if serving and distributed.active():
        from sshslie_torch.serve import parse_warmup

        h, w = parse_warmup(cfg.serve_warmup)[0]
        report["broadcast_ms"] = _broadcast_ms((h, w, cfg.channels), resolve_device(cfg.device))
        distributed.leave()
    if trainer is not None:
        report.update(losses=trainer.all_epoch_losses, mesh=str(trainer.mesh),
                      device=str(trainer.device))
    with open(f"{out}.rank{rank}.json", "w") as fh:
        json.dump(report, fh)
    return 0


def _write_data(root: str, n_train: int, size: int, bands: int, lo: float, hi: float) -> None:
    import scipy.io as sio

    rng = np.random.default_rng(SEED)
    for sub, n, side in (("train", n_train, size // 2), ("test", 2, size), ("label", 2, size),
                         ("train_b2", 2, size // 2)):
        os.makedirs(os.path.join(root, sub))
        for i in range(n):
            cube = lo + (hi - lo) * rng.random((side, side, bands), dtype=np.float32)
            sio.savemat(os.path.join(root, sub, f"c{i}.mat"), {"data": cube * 0.4})


def _run(cmd: list, cwd: str, env: dict, timeout: float) -> float:
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:8])} ... exited {proc.returncode}:\n"
                           f"{(proc.stdout + proc.stderr)[-6000:]}")
    return time.perf_counter() - t


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return _worker(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="", choices=("", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import BANDS, GLOBAL_MAX, GLOBAL_MIN, STOCK_TRAIN, card_line, counts_from_json
    from sshslie_torch.utils.io_hsi import load_hsi

    card = args.device != "cpu"
    if card and torch.cuda.device_count() < args.nproc:
        print(f"dp_check: {args.nproc} processes need {args.nproc} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    n, size = args.nproc, args.size
    patch = min(128, size // 4)
    work = tempfile.mkdtemp(prefix="dp_check_")
    _write_data(work, n, size, BANDS, GLOBAL_MIN, GLOBAL_MAX)
    flags = {**STOCK_TRAIN, "channels": BANDS, "global_min": GLOBAL_MIN,
             "global_max": GLOBAL_MAX, "batch_size": n, "patch_size": patch,
             "phase": "train_and_test", "epoch": 2, "eval_every_epoch": 1,
             "train_data": "train", "eval_data": "test", "test_data": "test",
             "label_dir": "label", "eval_sharded": True, "eval_shard_mode": "band",
             "use_mlflow": False, **({"device": "cpu"} if not card else {})}
    cli = ["--config", ""] + [a for k, v in flags.items() for a in (f"--{k}", str(v))]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    me = [sys.executable, "-m", "sshslie_torch.tools.dp_check", "--worker"]
    ranks_of = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(n), *me[1:]]
    seconds = {
        "one process": _run(me + [os.path.join(work, "ref"), *cli, "--model_name", "dp_ref"],
                            work, env, args.timeout),
        f"{n} ranks": _run(ranks_of + [os.path.join(work, "mesh"), *cli, "--model_name", "dp_mesh",
                                       "--mesh_shape", str(n)], work, env, args.timeout)}

    def report(name):
        with open(os.path.join(work, f"{name}.json")) as fh:
            return json.load(fh)

    ref = report("ref.rank0")
    ranks = [report(f"mesh.rank{r}") for r in range(n)]
    test_cli = [*cli, "--model_name", "dp_mesh", "--phase", "test",
                "--test_timestamp", ranks[0]["timestamp"]]
    seconds["one-process test"] = _run(me + [os.path.join(work, "test"), *test_cli],
                                       work, env, args.timeout)
    one = report("test.rank0")
    seconds[f"height-sharded test on {n} ranks"] = _run(
        ranks_of + [os.path.join(work, "sptest"), *test_cli, "--mesh_shape", str(n),
                    "--eval_shard_mode", "spatial"], work, env, args.timeout)
    sptest = [report(f"sptest.rank{r}") for r in range(n)]
    sp_shape = f"{n // 2}x2" if n in (2, 4) else None
    if sp_shape:
        # The space axis: one step at the stock batch 2, its patch height on 2 ranks.
        sp_cli = [*cli, "--phase", "train", "--batch_size", "2", "--epoch", "1",
                  "--train_data", "train_b2", "--eval_shard_mode", "spatial"]
        seconds["one process, b2"] = _run(me + [os.path.join(work, "ref_b2"), *sp_cli,
                                                "--model_name", "sp_ref"], work, env, args.timeout)
        seconds[f"{sp_shape} dp x sp"] = _run(
            ranks_of + [os.path.join(work, "sp"), *sp_cli, "--model_name", "sp_mesh",
                        "--mesh_shape", sp_shape, "--space_axis", "space"],
            work, env, args.timeout)
    # The mesh service on the mesh run's checkpoint, against one process.
    serve_cli = [*test_cli, "--phase", "serve", "--serve_port", "0", "--serve_pad_multiple", "64",
                 "--serve_warmup", f"{size}x{size}"]
    seconds["one-process service"] = _run(me + [os.path.join(work, "serve1"), *serve_cli],
                                          work, env, args.timeout)
    seconds[f"mesh service on {n} ranks"] = _run(
        ranks_of + [os.path.join(work, "serven"), *serve_cli, "--mesh_shape", str(n)],
        work, env, args.timeout)
    serve1 = report("serve1.rank0")
    serven = [report(f"serven.rank{r}") for r in range(n)]
    out = {"nproc": n, "meshes": [r["mesh"] for r in ranks], "devices": [r["device"] for r in ranks],
           "seconds": seconds}
    test_s = {"one process": one["seconds"], f"height-sharded, {n} ranks": sptest[0]["seconds"]}
    out["test_s_a_cube"] = {k: sum(v.values()) / len(v) for k, v in test_s.items()}
    failed = []
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        failed.append("the ranks' epoch terms differ")
    got, want = ranks[0]["losses"], ref["losses"]
    out["step1_rel"] = max(abs(got[k][0] - v[0]) / abs(v[0]) for k, v in want.items())
    if not out["step1_rel"] <= 2e-5:
        failed.append(f"epoch 1 terms {out['step1_rel']:.3e} from the one-process run's")
    out["epoch2_of_total"] = max(abs(got[k][1] - v[1]) / abs(want["total_loss"][1])
                                 for k, v in want.items())
    steps = 2                            # 2 epochs of one step
    expected = {}
    if card:
        p1, s1 = (1, patch, patch, BANDS), (1, size, size, BANDS)
        expected = {("conv9", "forward", "float32", p1): 2 * steps,
                    ("conv9", "dgrad", "float32", p1): steps,
                    ("conv9_wgrad", "wgrad", "float32", p1): 2 * steps,
                    ("conv9", "forward", "float32", s1): 6}
        if (size // 8) ** 2 > 2048:      # attention.DENSE_MAX_SEQ: flash above it
            expected[("flash_attention", "forward", "float32", (1, 4, (size // 8) ** 2, 16))] = 6
    for r in ranks:
        counts = counts_from_json(r["counts"])
        if counts != expected:
            failed.append(f"rank {r['rank']}: launches {counts}, expected {expected}")
    out["launches_a_rank"] = {" ".join(map(str, k)): v for k, v in expected.items()}
    if card:
        s1 = (1, size // n + 8, size, BANDS)
        want = {("conv9", "forward", "float32", s1): 2}
        if (size // 8) ** 2 > 2048:
            want[("flash_attention", "forward", "float32", (1, 4, (size // 8) ** 2, 16))] = 2
        for r in sptest:
            if counts_from_json(r["counts"]) != want:
                failed.append(f"height-sharded test rank {r['rank']}: launches "
                              f"{counts_from_json(r['counts'])}, expected {want}")
    for key, mesh_report in (("s", ranks[0]), ("sptest_s", sptest[0])):
        out[f"{key}_err"], out["s_span"] = [], []
        for i in range(2):
            s_mesh = load_hsi(os.path.join(work, mesh_report["test_result_dir"], f"c{i}.mat"),
                              mat_key="data")
            s_one = load_hsi(os.path.join(work, one["test_result_dir"], f"c{i}.mat"),
                             mat_key="data")
            out["s_span"].append(float(s_one.max() - s_one.min()))
            out[f"{key}_err"].append(float(np.abs(s_mesh.astype(np.float64) - s_one).max()))
            if not out[f"{key}_err"][-1] <= 1e-5 * out["s_span"][-1]:
                failed.append(f"{key} of c{i}: {out[f'{key}_err'][-1]:.3e} from the one-process "
                              f"test phase's, over 1e-5 of its span {out['s_span'][-1]:.1f}")
    if sp_shape:
        sp_ref = report("ref_b2.rank0")
        sp = [report(f"sp.rank{r}") for r in range(n)]
        out["sp_mesh"] = sp[0]["mesh"]
        if any(r["losses"] != sp[0]["losses"] for r in sp):
            failed.append("dp x sp: the ranks' epoch terms differ")
        got, want_l = sp[0]["losses"], sp_ref["losses"]
        out["sp_step1_rel"] = max(abs(got[k][0] - v[0]) / abs(v[0]) for k, v in want_l.items())
        if not out["sp_step1_rel"] <= 2e-5:
            failed.append(f"dp x sp: step 1 terms {out['sp_step1_rel']:.3e} from the one-process "
                          "b2 step's")
        if card:
            ps = (1, patch // 2 + 8, patch, BANDS)
            want = {("conv9", "forward", "float32", ps): 2, ("conv9", "dgrad", "float32", ps): 1,
                    ("conv9_wgrad", "wgrad", "float32", ps): 2,
                    ("conv9", "forward", "float32", (1, size // 2 + 8, size, BANDS)): 2}
            if (size // 8) ** 2 > 2048:
                want[("flash_attention", "forward", "float32", (1, 4, (size // 8) ** 2, 16))] = 2
            for r in sp:
                if counts_from_json(r["counts"]) != want:
                    failed.append(f"dp x sp rank {r['rank']}: launches "
                                  f"{counts_from_json(r['counts'])}, expected {want}")
            out["sp_launches_a_rank"] = {" ".join(map(str, k)): v for k, v in want.items()}
    # The mesh service: S, launches and X-Inference-Seconds against one process.
    forwards = 8                         # the warmup, 2 test cubes, 5 warm requests
    out["serve_x_seconds"] = {"one process": serve1["x_seconds"], f"{n} ranks": serven[0]["x_seconds"]}
    out["serve_x_median"] = {k: sorted(v)[2] for k, v in out["serve_x_seconds"].items()}
    out["serve_broadcast_ms"] = serven[0]["broadcast_ms"]
    out["serve_broadcast_share"] = (sorted(serven[0]["broadcast_ms"])[2] / 1e3
                                    / out["serve_x_median"][f"{n} ranks"])
    for key, prefix in (("serve1_s_err", "serve1"), ("serven_s_err", "serven")):
        out[key] = []
        for i in range(2):
            s_srv = np.load(os.path.join(work, f"{prefix}.S{i}.npy"))
            s_one = load_hsi(os.path.join(work, one["test_result_dir"], f"c{i}.mat"),
                             mat_key="data")
            out[key].append(float(np.abs(s_srv.astype(np.float64) - s_one).max()))
            if not out[key][-1] <= 1e-5 * out["s_span"][i]:
                failed.append(f"{key} of c{i}: {out[key][-1]:.3e} from the one-process test "
                              f"phase's, over 1e-5 of its span {out['s_span'][i]:.1f}")
    if card:
        flash = (size // 8) ** 2 > 2048
        for reports, rows in (([serve1], size), (serven, size // n + 8)):
            want = {("conv9", "forward", "float32", (1, rows, size, BANDS)): forwards}
            if flash:
                want[("flash_attention", "forward", "float32",
                      (1, 4, (size // 8) ** 2, 16))] = forwards
            for r in reports:
                if counts_from_json(r["counts"]) != want:
                    failed.append(f"service ({len(reports)} process(es)) rank {r['rank']}: "
                                  f"launches {counts_from_json(r['counts'])}, expected {want}")
    out["failed"] = failed
    out["ok"] = not failed
    print(json.dumps(out))
    if card:
        print(card_line())
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
