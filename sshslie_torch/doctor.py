"""Preflight check of the environment, a config and its dataset before a
run, as ``sshslie_tpu/doctor.py``: each check the run would otherwise fail
at minutes in, printed as a PASS/WARN/FAIL line with the fix.

* the device (the CUDA card, or the CPU when ``--device cpu`` asks for it):
  its name and count; ``nvcc``; the kernels built into the build directory
  (``ops/_build.py``, the port's counterpart of JAX's compile cache); the
  native sampler library;
* each dataset split through ``data/datasets.py::store_from_config`` (so
  ``lazy_loading`` and ENVI ``data_pattern`` stores too): it exists, matches
  ``data_pattern``, its cubes load with one channel count equal to the
  config's, ``patch_size`` fits, the value range fits
  global_min/global_max, eval/test ground truth pairs by basename;
* the checkpoints a resume, test or serve run needs.

``python -m sshslie_torch.doctor --config cfg.yml [--key val ...] [--device
cpu]``: exit code 0 when nothing failed, 1 otherwise.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np


class Report:
    def __init__(self) -> None:
        self.rows: List[Tuple[str, str, str]] = []  # (level, check, detail)

    def add(self, level: str, check: str, detail: str = "") -> None:
        self.rows.append((level, check, detail))

    def ok(self, check: str, detail: str = "") -> None:
        self.add("PASS", check, detail)

    def warn(self, check: str, detail: str = "") -> None:
        self.add("WARN", check, detail)

    def fail(self, check: str, detail: str = "") -> None:
        self.add("FAIL", check, detail)

    @property
    def failed(self) -> bool:
        return any(lvl == "FAIL" for lvl, _, _ in self.rows)

    def render(self) -> str:
        out = []
        for lvl, check, detail in self.rows:
            line = f"[{lvl}] {check}"
            if detail:
                line += f" — {detail}"
            out.append(line)
        n_fail = sum(lvl == "FAIL" for lvl, _, _ in self.rows)
        n_warn = sum(lvl == "WARN" for lvl, _, _ in self.rows)
        out.append(f"{len(self.rows)} checks: {len(self.rows) - n_fail - n_warn} pass, "
                   f"{n_warn} warn, {n_fail} fail")
        return "\n".join(out)


# The environment's rows, by check name; every other row is the JAX doctor's.
ENVIRONMENT_CHECKS = ("torch device", "nvcc", "kernel build", "native patch sampler")


def _check_environment(cfg, rep: Report) -> None:
    import torch

    from sshslie_torch.data.native_sampler import _LIB_PATH
    from sshslie_torch.device import resolve_device
    from sshslie_torch.ops import _build

    try:
        device = resolve_device(cfg.device)
    except (RuntimeError, ValueError) as e:
        rep.fail("torch device", str(e))
        device = None
    if device is not None and device.type == "cuda":
        rep.ok("torch device", f"cuda with {torch.cuda.device_count()} device(s): "
                               f"{torch.cuda.get_device_name(device)} (torch {torch.__version__}, "
                               f"CUDA {torch.version.cuda})")
    elif device is not None:
        rep.ok("torch device", f"cpu, as asked for (torch {torch.__version__})")
    on_card = device is not None and device.type == "cuda"
    try:
        rep.ok("nvcc", _build._nvcc())
        nvcc = True
    except RuntimeError as e:
        # The kernels are built only for the card.
        (rep.fail if on_card or device is None else rep.warn)("nvcc", str(e))
        nvcc = False
    if on_card and nvcc:
        t = time.perf_counter()
        try:
            libs = _build.build_all()
            rep.ok("kernel build", f"{', '.join(sorted(libs))} in {_build.BUILD_DIR} "
                                   f"({time.perf_counter() - t:.1f} s)")
        except RuntimeError as e:
            rep.fail("kernel build", str(e).splitlines()[0])
    elif not on_card:
        rep.ok("kernel build", "not needed on the CPU (the kernels' plain versions run)")
    if os.path.exists(_LIB_PATH):
        rep.ok("native patch sampler", _LIB_PATH)
    else:
        rep.warn("native patch sampler",
                 "native/libpatch_sampler.so not built (host sampler falls "
                 "back to numpy; run `sh native/build.sh`)")


def _load_split(cfg, path: str):
    from sshslie_torch.data.datasets import store_from_config

    return store_from_config(cfg, path)


def _check_split(cfg, rep: Report, name: str, path: str, require: bool) -> Optional[object]:
    if not os.path.isdir(path):
        (rep.fail if require else rep.warn)(f"{name} dir", f"{path} does not exist")
        return None
    try:
        store = _load_split(cfg, path)
    except Exception as e:  # noqa: BLE001 — any load error is the finding
        rep.fail(f"{name} load", f"{type(e).__name__}: {e}")
        return None
    if len(store) == 0:
        (rep.fail if require else rep.warn)(
            f"{name} files", f"no files matching {cfg.data_pattern!r} in {path}")
        return None
    shapes = store.shapes
    chans = {s[2] for s in shapes}
    if len(chans) > 1:
        rep.fail(f"{name} channels", f"mixed channel counts {sorted(chans)} across cubes")
    elif cfg.channels is not None and shapes[0][2] != cfg.channels:
        rep.fail(f"{name} channels",
                 f"cubes have {shapes[0][2]} bands but config channels={cfg.channels}")
    else:
        rep.ok(f"{name} files",
               f"{len(store)} cube(s), shapes {sorted({tuple(s) for s in shapes})}")
    return store


def _check_train_split(cfg, rep: Report, store) -> None:
    if store is None:
        return
    shapes = store.shapes
    min_h = min(s[0] for s in shapes)
    min_w = min(s[1] for s in shapes)
    if cfg.patch_size > min_h or cfg.patch_size > min_w:
        rep.fail("patch size", f"patch_size {cfg.patch_size} exceeds smallest cube "
                               f"{min_h}x{min_w}")
    else:
        rep.ok("patch size", f"{cfg.patch_size} fits {min_h}x{min_w}")
    if len(store) < cfg.batch_size:
        rep.fail("batch size",
                 f"batch_size {cfg.batch_size} > {len(store)} cubes: zero "
                 "steps per epoch — fit refuses this (PARITY #23); reduce "
                 "batch_size")
    # The value range against the normalisation's bounds, from one raw cube;
    # only global_normalization reads global_min/global_max.
    if cfg.normalization != "global_normalization":
        rep.ok("value range",
               f"check not applicable under normalization="
               f"{cfg.normalization!r} (no global_min/global_max in play)")
        return
    try:
        from sshslie_torch.utils.io_hsi import load_hsi

        raw = load_hsi(store.files[0], mat_key=cfg.mat_key, normalization=None,
                       rescale_by_max=False)
        lo, hi = float(np.min(raw)), float(np.max(raw))
        if cfg.global_max is None:
            rep.warn("value range", "normalization=global_normalization but global_max is "
                                    "unset")
        elif hi > cfg.global_max:
            rep.warn("value range",
                     f"{os.path.basename(store.files[0])} max {hi:.1f} "
                     f"exceeds global_max {cfg.global_max} (values clip "
                     "above 1 after normalization)")
        elif hi <= cfg.global_max * 0.01:
            rep.warn("value range",
                     f"max {hi:.3g} is <1% of global_max {cfg.global_max} "
                     "— wrong global_max or already-normalized data?")
        else:
            rep.ok("value range",
                   f"[{lo:.1f}, {hi:.1f}] within global [{cfg.global_min}, {cfg.global_max}]")
    except Exception as e:  # noqa: BLE001
        rep.warn("value range", f"could not sample a cube: {e}")


def _check_gt_pairing(cfg, rep: Report, pred_store, label_dir: str, what: str) -> None:
    if pred_store is None:
        return
    if not os.path.isdir(label_dir):
        rep.warn(f"{what} GT", f"label_dir {label_dir} does not exist — "
                               "metrics will be skipped")
        return
    gt = {os.path.splitext(f)[0] for f in os.listdir(label_dir)}
    missing = [b for b in pred_store.basenames() if os.path.splitext(b)[0] not in gt]
    if missing:
        rep.warn(f"{what} GT pairing", f"no GT for {missing} in {label_dir}")
    else:
        rep.ok(f"{what} GT pairing", f"all basenames present in {label_dir}")


def _check_checkpoints(cfg, rep: Report) -> None:
    from glob import glob

    from sshslie_torch import checkpoints

    need = cfg.resume or cfg.phase in ("test", "serve")
    if cfg.phase in ("test", "serve") and cfg.test_timestamp:
        # test and serve load one run's latest checkpoint: check that one.
        specific = checkpoints.latest_path(cfg.test_model_dir)
        if os.path.exists(specific):
            rep.ok("checkpoints", specific)
        else:
            rep.fail("checkpoints", f"phase={cfg.phase} with test_timestamp="
                                    f"{cfg.test_timestamp} needs {os.path.abspath(specific)}")
        return
    pattern = checkpoints.latest_path(os.path.join(cfg.model_ckpt_dir, "Decomposition_*"))
    found = glob(pattern)
    if found:
        rep.ok("checkpoints", f"{len(found)} resumable run(s) under {cfg.model_ckpt_dir}")
    elif need:
        rep.fail("checkpoints", f"phase/resume needs a checkpoint but none match "
                                f"{os.path.abspath(pattern)}")
    else:
        rep.ok("checkpoints", "fresh run (none required)")


def run_doctor(cfg) -> Report:
    rep = Report()
    _check_environment(cfg, rep)
    if cfg.phase in ("train", "train_and_test"):
        train = _check_split(cfg, rep, "train", cfg.train_data, require=True)
        _check_train_split(cfg, rep, train)
        ev = _check_split(cfg, rep, "eval", cfg.eval_data, require=False)
        _check_gt_pairing(cfg, rep, ev, cfg.label_dir, "eval")
    if cfg.phase in ("test", "train_and_test"):
        test = _check_split(cfg, rep, "test", cfg.test_data, require=cfg.phase == "test")
        _check_gt_pairing(cfg, rep, test, cfg.label_dir, "test")
    _check_checkpoints(cfg, rep)
    return rep


def main(argv: Optional[list] = None) -> int:
    """The config's flags as ``python -m sshslie_torch``'s; ``--device cpu``
    checks for a run on the CPU."""
    from sshslie_torch.config import parse_args

    rep = run_doctor(parse_args(argv))
    print(rep.render())
    return 1 if rep.failed else 0


if __name__ == "__main__":
    sys.exit(main())
