"""Run tracking, plots and profiling of the port, as ``sshslie_tpu/observability.py``.

* :class:`Logger` tees stdout to a log file (reference logger.py:3-24).
* :class:`MLflowShim` is the subset of the mlflow API the pipeline calls: real
  mlflow when it imports with every attribute, else :class:`LocalRunTracker`
  (``runs/<experiment>/params.json``, ``metrics.jsonl``, ``artifacts/``, the
  JAX package's files byte for byte); a failing backend degrades to the file
  tracker, then to no tracking. Training never depends on a tracking server.
* :func:`param_summary` counts ``named_parameters()`` under the reference's
  state-dict keys.
* :class:`RunObserver` writes the model summary and renders the 7-panel loss
  curves and the 3-panel eval curves on one worker thread; a failed plot is
  printed, never raised. matplotlib is imported only when a plot renders, so
  the package imports where it is missing.
* :class:`Profiler` records a ``torch.profiler`` trace (CPU activity, plus
  CUDA activity on a card) and exports it as a Chrome trace under its
  directory.
* :data:`TRACER` and :func:`span` time the program's own phases (a train
  step's sample, forward, loss, backward and Adam; a request's lock wait,
  upload, decode, forward, sync and fetch; the kernels' load) on the host,
  while a ``torch.profiler`` session records, as ranges of that session's
  trace; and the first instance of each, recording or not.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


class Logger:
    """Tee stdout to the terminal and a UTF-8 log file (reference logger.py:3-24)."""

    def __init__(self, filepath: str):
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(filepath, "w", encoding="utf-8")

    def write(self, message: str) -> None:
        self.terminal.write(message)
        self.log.write(message)
        self.flush()

    def flush(self) -> None:
        self.terminal.flush()
        self.log.flush()

    def close(self) -> None:
        self.log.close()


class _NoOpRun:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _SafeRun:
    """A backend run context whose failure at run end (a tracking server that
    died mid-run) is printed, so it cannot fail a finished run."""

    def __init__(self, run):
        self._run = run

    def __enter__(self):
        try:
            return self._run.__enter__()
        except AttributeError:
            return self._run

    def __exit__(self, *exc):
        try:
            return self._run.__exit__(*exc)
        except AttributeError:
            return False
        except Exception as e:  # noqa: BLE001
            print(f"tracking run close failed ({type(e).__name__}: {e}); "
                  "continuing")
            return False


class LocalRunTracker:
    """File-based experiment tracking: params.json, metrics.jsonl, artifact
    copies under ``runs/<experiment>/`` (the reference needs a reachable
    MLflow backend, main.py:225)."""

    def __init__(self, root: str = "runs"):
        self.root = root
        self.experiment = "default"
        self._dir: Optional[str] = None

    def _ensure_dir(self) -> str:
        if self._dir is None:
            self._dir = os.path.join(self.root, self.experiment)
            os.makedirs(os.path.join(self._dir, "artifacts"), exist_ok=True)
        return self._dir

    def set_experiment(self, name: str):
        self.experiment = name
        self._dir = None

    def start_run(self):
        self._ensure_dir()
        return _NoOpRun()

    def log_param(self, key: str, value: Any):
        self.log_params({key: value})

    def log_params(self, params: Dict[str, Any]):
        import json

        path = os.path.join(self._ensure_dir(), "params.json")
        existing = {}
        if os.path.exists(path):
            with open(path) as fh:
                existing = json.load(fh)
        existing.update({k: repr(v) if not isinstance(v, (int, float, str, bool, type(None))) else v
                         for k, v in params.items()})
        with open(path, "w") as fh:
            json.dump(existing, fh, indent=2)

    def log_metric(self, key: str, value: float, step: Optional[int] = None):
        self.log_metrics({key: value}, step=step)

    def log_metrics(self, values: Dict[str, float], step: Optional[int] = None):
        import json

        with open(os.path.join(self._ensure_dir(), "metrics.jsonl"), "a") as fh:
            fh.write(json.dumps({"step": step, **{k: float(v) for k, v in values.items()}}) + "\n")

    def log_artifact(self, path: str, artifact_path: Optional[str] = None):
        import shutil

        if os.path.exists(path):
            dest = os.path.join(self._ensure_dir(), "artifacts", artifact_path or "")
            os.makedirs(dest, exist_ok=True)
            shutil.copy(path, dest)


class MLflowShim:
    """set_experiment, start_run, log_param(s), log_metric(s), log_artifact
    (reference main.py:225-264, model.py:256-270,333-341) on real mlflow if
    it imports with those attributes, else on :class:`LocalRunTracker`;
    ``enabled=False`` tracks nothing."""

    def __init__(self, enabled: bool = True, local_root: str = "runs"):
        self._backend = None
        self._local_root = local_root
        if enabled:
            try:
                import mlflow  # type: ignore

                # A module that only imports as 'mlflow' (a name clash, a
                # broken install) would fail on its first missing attribute.
                if all(hasattr(mlflow, a) for a in (
                    "set_experiment", "start_run", "log_param", "log_metric",
                    "log_artifact",
                )):
                    self._backend = mlflow
                else:
                    self._backend = LocalRunTracker(local_root)
            except Exception as e:  # noqa: BLE001 — a broken install can raise
                # anything at import (TypeError from a protobuf clash, ...).
                if not isinstance(e, ImportError):
                    print(f"mlflow import failed ({type(e).__name__}: {e}); "
                          "using the file tracker")
                self._backend = LocalRunTracker(local_root)

    @property
    def active(self) -> bool:
        return self._backend is not None

    def _call(self, method: str, *args, **kwargs):
        """Call a backend method. A failing backend (unreachable server, auth,
        disk full) degrades to the file tracker, and a failing file tracker to
        no tracking, instead of ending the run."""
        if not self._backend:
            return None
        try:
            return getattr(self._backend, method)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            was_local = isinstance(self._backend, LocalRunTracker)
            print(f"tracking backend failed on {method} ({type(e).__name__}: "
                  f"{e}); " + ("disabling run tracking" if was_local else
                               f"falling back to file tracker under "
                               f"{self._local_root!r}"))
            if was_local:
                self._backend = None
                return None
            self._backend = LocalRunTracker(self._local_root)
            try:
                return getattr(self._backend, method)(*args, **kwargs)
            except Exception as e2:  # noqa: BLE001
                print(f"file tracker also failed ({type(e2).__name__}: "
                      f"{e2}); disabling run tracking")
                self._backend = None
                return None

    def set_experiment(self, name: str):
        self._call("set_experiment", name)

    def start_run(self):
        run = self._call("start_run") if self._backend else None
        return _SafeRun(run) if run is not None else _NoOpRun()

    def log_param(self, key: str, value: Any):
        self._call("log_param", key, value)

    def log_params(self, params: Dict[str, Any]):
        self._call("log_params", params)

    def log_metric(self, key: str, value: float, step: Optional[int] = None):
        self._call("log_metric", key, value, step=step)

    def log_metrics(self, values: Dict[str, float], step: Optional[int] = None):
        self._call("log_metrics", values, step=step)

    def log_artifact(self, path: str, artifact_path: Optional[str] = None):
        if self._backend and os.path.exists(path):
            self._call("log_artifact", path, artifact_path=artifact_path)


def param_summary(model: torch.nn.Module) -> str:
    """Parameter count by state-dict key (replaces torchinfo, model.py:267-270)."""
    lines = ["Layer (state-dict key)                                 Param #"]
    lines.append("=" * 62)
    total = 0
    for name, p in model.named_parameters():
        lines.append(f"{name:<50} {p.numel():>10,}")
        total += p.numel()
    lines.append("=" * 62)
    lines.append(f"Total params: {total:,}")
    return "\n".join(lines)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class RunObserver:
    """Model summary and loss/metric plots, wired into the Trainer.

    With ``async_plots`` (the default) plots render on one worker thread, so
    figure assembly and PNG encoding stay off the training thread and the Agg
    backend is never entered concurrently. The plot methods copy their inputs
    (the trainer appends to the loss lists every epoch). A failed plot is
    printed, never raised; :meth:`drain` waits for the queued plots
    (``Trainer.fit`` calls it when it ends)."""

    def __init__(self, async_plots: bool = True):
        self._pool = None
        self._pending: list = []
        if async_plots:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="plots")

    def _dispatch(self, fn, *args) -> None:
        if self._pool is None:
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001
                print(f"plot failed: {type(e).__name__}: {e}")
            return
        self._pending = [f for f in self._pending if not self._reap(f)]
        self._pending.append(self._pool.submit(fn, *args))

    @staticmethod
    def _reap(fut) -> bool:
        """True when the future is finished (printing any failure)."""
        if not fut.done():
            return False
        e = fut.exception()
        if e is not None:
            print(f"plot failed: {type(e).__name__}: {e}")
        return True

    def drain(self) -> None:
        """Wait for queued plots; report failures. Reusable afterwards."""
        for fut in self._pending:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001
                print(f"plot failed: {type(e).__name__}: {e}")
        self._pending = []

    def log_model_summary(self, model: torch.nn.Module, ckpt_dir: str,
                          mlflow: Optional[MLflowShim]) -> None:
        summary_path = os.path.join(ckpt_dir, "model_summary.txt")
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(summary_path, "w", encoding="utf-8") as fh:
            fh.write(param_summary(model))
        if mlflow:
            mlflow.log_artifact(summary_path)

    def plot_loss_curve(self, all_epoch_losses: Dict[str, list], save_path: str) -> None:
        """Seven-panel loss curves (reference model.py:649-717)."""
        self._dispatch(self._plot_loss_curve,
                       {k: list(v) for k, v in all_epoch_losses.items()}, save_path)

    @staticmethod
    def _plot_loss_curve(all_epoch_losses: Dict[str, list], save_path: str) -> None:
        plt = _pyplot()
        epochs = range(1, len(all_epoch_losses["total_loss"]) + 1)
        panels = [
            ("total_loss", "k-", "Total Loss"),
            ("L_reconstruction", "r-", "Reconstruction Loss"),
            ("L_R_fidelity", "b-", "Reflectance Fidelity Loss"),
            ("L_I_smooth_low", "y-", "Structure-aware Illumination Smoothness Loss (I_low)"),
            ("L_I_smooth_delta", "g-", "Structure-aware Illumination Smoothness Loss (I_delta)"),
            ("L_fourier", "m-", "Fourier Spectrum Loss"),
            ("L_spectral_cons", "c-", "Spectral Consistency Loss"),
        ]
        plt.figure(figsize=(20, 10))
        for i, (key, style, title) in enumerate(panels, start=1):
            plt.subplot(3, 3, i)
            plt.plot(epochs, all_epoch_losses[key], style, label=key)
            plt.title(title)
            plt.xlabel("Epoch")
            plt.ylabel("Loss")
            plt.grid(True)
            plt.legend()
        plt.tight_layout()
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path)
        plt.close()
        print(f"Loss curves saved to {save_path}")

    def plot_eval_metrics(self, eval_metrics: Dict[int, Dict[str, float]], save_path: str) -> None:
        """PSNR/SSIM/SAM curves over eval epochs (reference model.py:609-647)."""
        self._dispatch(self._plot_eval_metrics,
                       {e: dict(m) for e, m in eval_metrics.items()}, save_path)

    @staticmethod
    def _plot_eval_metrics(eval_metrics: Dict[int, Dict[str, float]], save_path: str) -> None:
        plt = _pyplot()
        epochs = sorted(eval_metrics.keys())
        series = [
            ("psnr", "k-", "Eval PSNR", "PSNR"),
            ("ssim", "r-", "Eval SSIM", "SSIM"),
            ("sam", "b-", "Eval SAM", "SAM"),
        ]
        plt.figure(figsize=(10, 10))
        for i, (key, style, title, ylabel) in enumerate(series, start=1):
            plt.subplot(3, 1, i)
            plt.plot(epochs, [eval_metrics[e][key] for e in epochs], style, label=f"avg_{key}")
            plt.title(title)
            plt.xlabel("Epoch")
            plt.ylabel(ylabel)
            plt.grid(True)
            plt.legend()
        plt.tight_layout()
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path)
        plt.close()
        print(f"Eval metrics saved to {save_path}")


class Profiler:
    """A ``torch.profiler`` trace of a region, exported as a Chrome trace
    (``trace_<pid>_<ms>.json``) under ``trace_dir``; '' traces nothing. CPU
    activity always, CUDA activity (kernels, copies) when ``device`` is a
    card. Use as a context manager, or :meth:`start` and :meth:`stop`."""

    def __init__(self, trace_dir: str = "", device: Optional[torch.device] = None):
        self.trace_dir = trace_dir
        self.device = device
        self.path: Optional[str] = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        if not self.trace_dir or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device is not None and torch.device(self.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()

    def stop(self) -> Optional[str]:
        """Stop and export; returns the trace's path (None when not tracing)."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(self.trace_dir,
                                 f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(self.path)
        return self.path

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


# -- spans ---------------------------------------------------------------------

_clock = time.perf_counter_ns


class SpanRecord(NamedTuple):
    """One completed span: times in ``perf_counter_ns``; ``parent`` the id of
    the enclosing recorded span of its thread (None for a root), ``root``
    the id of the outermost one (its own for a root), ``self_ns`` its
    duration less its child spans'."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    start_ns: int
    end_ns: int
    self_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "id", "parent", "root", "start_ns", "child_ns", "_up",
                 "_stack", "_range")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self.name = name

    def __enter__(self):
        stack = self._tracer._stack()
        up = stack[-1] if stack else None
        self.id = next(self._tracer._ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.child_ns = 0
        self._up, self._stack, self._range = up, stack, None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        self._stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._up is not None:
            self._up.child_ns += end - self.start_ns
        self._tracer._finish(self, end, self._range is not None)
        return False


class Tracer:
    """Host spans of the program, kept while a ``torch.profiler`` session
    records (the benchmark's traced stretch, ``Trainer``'s ``profile_dir``
    epoch), each then also a ``record_function`` range of the same name, so
    the session's trace holds it beside the card's kernels on one clock.

    * :meth:`span` (a context manager) records the name, its start and end
      (``time.perf_counter_ns``), the enclosing span of its thread and an
      id; spans opened under one root share its id as ``root``.
    * Recorded spans go to a buffer of ``capacity``; a running aggregate by
      name (count, total, self time) keeps every one, past the buffer too.
    * The first completed instance of each name in the process is kept
      whether a session records or not (:meth:`cold`): set-up's first step
      and first library calls, which no traced stretch sees.
    * With no session recording, a name already seen costs one flag test
      and one dict lookup: no clock, no profiler call, no allocation.
    * Host time only: no synchronize, event or ``.item()``.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._cold: Dict[str, SpanRecord] = {}
        self._spans: List[SpanRecord] = []
        self._totals: Dict[str, List[int]] = {}    # name -> [count, total ns, self ns]

    def span(self, name: str):
        if not _profiler._is_profiler_enabled and name in self._cold:
            return _NULL
        return _Span(self, name)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _finish(self, s: _Span, end: int, recorded: bool) -> None:
        dur = end - s.start_ns
        rec = SpanRecord(s.name, s.id, s.parent, s.root, threading.get_ident(), s.start_ns, end,
                         dur - s.child_ns)
        with self._lock:
            self._cold.setdefault(s.name, rec)
            if not recorded:
                return
            tot = self._totals.setdefault(s.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += dur
            tot[2] += rec.self_ns
            if len(self._spans) < self.capacity:
                self._spans.append(rec)
            else:
                self.dropped += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{name: {"count", "total_s", "self_s"}} of every recorded span
        since the last :meth:`reset`."""
        with self._lock:
            return {n: {"count": c, "total_s": t * 1e-9, "self_s": f * 1e-9}
                    for n, (c, t, f) in self._totals.items()}

    def spans(self) -> List[SpanRecord]:
        """The buffered spans in the order they ended (the first ``capacity``)."""
        with self._lock:
            return list(self._spans)

    def cold(self) -> Dict[str, SpanRecord]:
        """{name: the process's first completed span of that name}."""
        with self._lock:
            return dict(self._cold)

    def reset(self) -> None:
        """Empty the buffer and the aggregate (the first instances stay)."""
        with self._lock:
            self._spans.clear()
            self._totals.clear()
            self.dropped = 0


TRACER = Tracer()
span = TRACER.span
