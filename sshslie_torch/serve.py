"""Persistent inference serving of enhanced cubes, as ``sshslie_tpu/serve.py``.

A long-lived process keeps the weights on the card, so that a request pays
for its own forward only:

* **Shape buckets**: a cube is edge-padded on the host (``np.pad(mode=
  "edge")``, as in JAX) up to a multiple of ``serve_pad_multiple``, so the
  kernels see a few shapes; ``serve_warmup`` runs each bucket once at start
  (cuDNN's algorithm choice, the kernels' first launch). "Compiled" in the
  metrics' names means warmed here.
* **Device serialization**: every forward and every device-side reduction
  runs under one lock; the HTTP threads parse and serialize concurrently.
* **Spans** (``observability.span``, kept while a profiler records): a
  request is ``serve.request``, with ``serve.lock_wait`` (each wait for the
  device lock), ``serve.upload`` and ``serve.decode`` (an encoded body),
  ``serve.forward`` (the forward's enqueue), ``serve.sync`` (the host's wait
  for the card) and ``serve.fetch`` (S's crop, reduction and copy back).
* **Micro-batching** (``serve_max_batch`` > 1): same-bucket requests that
  arrive within ``serve_batch_window_ms`` run as one (B, H, W, C) forward,
  B rounded up to a power of two with zero cubes.
* **Weight-only quantization** (``serve_quantize``): the weights are
  quantized on the host (``ops/quant.py``) and live on the card at 8 or 4
  bits; each forward dequantizes them on the device, so conv9 and flash see
  float32 (or bfloat16) weights as in the float32 service.
* **Same math as the test phase**: the host normalisation of ``CubeStore``
  (``utils/io_hsi.py``), S denormalised as ``evaluate._save_outputs`` does.
* **A mesh** (``mesh``, ``runner.py``'s ``mesh_shape``): the forward is the
  height-sharded ``evaluate.ShardedInferencer`` over ``data_axis`` (the
  space ranks of a 2-D mesh compute replicas), as in JAX, without the
  micro-batcher, quantization or the card's decode of u16/bf16 bodies.

HTTP (stdlib only): ``GET /health`` (``"backend"`` is the torch device type,
``cuda`` or ``cpu``, and ``"device_name"`` the card's name: the JAX server
answers ``jax.default_backend()``), ``GET /stats``, ``GET /metrics``
(Prometheus text; the JAX package's series names), ``POST /enhance`` (a
``.mat`` body, or a binary cube with ``X-Cube-*`` headers; query ``key``,
``artifacts=1``, ``encoding=mat|f32|bf16|u16``, ``compress=zlib``) and
``POST /reload`` (``?checkpoint=<path>`` needs ``X-Reload-Token``).

Wire formats, both directions (:func:`encode_cube`,
:func:`decode_cube_response`): ``mat``, ``f32`` (raw little-endian), ``bf16``
(the upper 16 bits, rounded to nearest even, as ``ml_dtypes``; carried as
16-bit patterns, so no ``ml_dtypes`` is needed) and ``u16`` (affine to the
cube's own range, ``X-Cube-Scale``/``X-Cube-Offset``). u16 and bf16 request
bodies are uploaded as they are and decoded on the card
(:meth:`EnhanceService.enhance_encoded`); a u16 response is quantized on the
card and passed to the wire as it is (:func:`encode_cube_prequantized`).
Body, declared shape and deflate output are capped (``_MAX_BODY_BYTES``).

Serving on a mesh runs one process a GPU where JAX runs one process that
owns every device, so:

* **Rank 0 alone** binds HTTP; it parses, validates and normalises each
  request and answers it. Everything it can refuse (shape, channels, body
  caps, a checkpoint that does not load) is refused before any other rank
  hears of the request.
* **The other ranks follow** (:meth:`EnhanceService.follow`): rank 0 sends
  each forward, warmup and reload as a command through the group's store
  (``parallel/distributed.py::Commands``), then its payload by
  ``broadcast``, all under its device lock, so every rank runs the
  commands in rank 0's order. A follower waits for the next command on the
  host, so an idle server meets no group timeout.
* **The whole cube goes to every rank**: rank 0 broadcasts the normalised,
  bucket-padded cube (67 MB at 512^2 x 64 float32), and each rank keeps
  its rows. JAX's ``device_put`` sends each device its own rows.
* **Stopping**: ``EnhanceServer.shutdown()`` on rank 0 sends "stop" and
  waits for the followers to leave; under ``serve_from_config`` rank 0 takes
  SIGINT and SIGTERM as a shutdown and the followers finish their command
  and leave, every rank exiting cleanly.
* **A failure after a command went out** (out of memory on one rank in the
  forward, say) leaves the ranks out of step: rank 0 answers that request
  and every later one with an error, and a rank left waiting in a
  collective fails at the group's timeout and exits, which ends a torchrun
  job. Nothing retries.

CLI: ``python -m sshslie_torch.serve --config cfg.yml --test_timestamp TS``,
or ``python -m sshslie_torch --config cfg.yml --phase serve``; on a mesh,
``torchrun --nproc_per_node N -m sshslie_torch --phase serve --mesh_shape N``
(or ``DxS``).
"""

from __future__ import annotations

import bisect
import contextlib
import hmac
import io
import json
import math
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from sshslie_torch import checkpoints, interop
from sshslie_torch.config import Config
from sshslie_torch.device import resolve_device, set_matmul_precision
from sshslie_torch.observability import span
from sshslie_torch.parallel import distributed
from sshslie_torch.utils import io_hsi

WIRE_ENCODINGS = ("mat", "f32", "bf16", "u16")

# Upper bound on request bodies and on the cube a binary body declares
# (covers 1024^2 x 224 float64 cubes with headroom).
_MAX_BODY_BYTES = 4 << 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_up_pow2(x: int, cap: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return min(p, cap)


# -- wire formats --------------------------------------------------------------


def _bf16_bits(cube: np.ndarray) -> np.ndarray:
    """The bfloat16 bit patterns (uint16) of a cube: float32, then rounded to
    nearest even by torch's cast, as ``ml_dtypes`` rounds."""
    x = np.ascontiguousarray(cube, dtype=np.float32)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """float32 values of bfloat16 bit patterns (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _deflate(blob: bytes, compress: str, headers: Dict[str, str]) -> bytes:
    if compress == "zlib":
        import zlib

        # Level 1: this path exists to cut transport time; a slow high-ratio
        # compress would move the bottleneck to the host CPU.
        headers["Content-Encoding"] = "deflate"
        return zlib.compress(blob, 1)
    if compress:
        raise ValueError(f"unknown compress {compress!r} (choices: zlib)")
    return blob


def encode_cube(cube: np.ndarray, encoding: str = "mat", compress: str = "",
                mat_key: str = "data") -> Tuple[bytes, Dict[str, str]]:
    """Serialize an (H, W, C) float cube for the wire → (blob, headers).

    ``mat`` (a scipy .mat container), ``f32`` (raw little-endian float32),
    ``bf16`` (2 bytes a value), ``u16`` (affine to the cube's [min, max]:
    value = q * X-Cube-Scale + X-Cube-Offset). ``compress='zlib'`` deflates
    the blob. f32, bf16 and u16 blobs are byte for byte the JAX package's."""
    if encoding not in WIRE_ENCODINGS:
        raise ValueError(f"unknown encoding {encoding!r} (choices: {', '.join(WIRE_ENCODINGS)})")
    headers = {"X-Cube-Encoding": encoding,
               "X-Cube-Shape": "x".join(str(int(d)) for d in cube.shape)}
    if encoding == "mat":
        import scipy.io as sio

        buf = io.BytesIO()
        sio.savemat(buf, {mat_key: cube})
        blob = buf.getvalue()
    elif encoding == "f32":
        blob = np.ascontiguousarray(cube, dtype="<f4").tobytes()
    elif encoding == "bf16":
        blob = np.ascontiguousarray(_bf16_bits(cube), dtype="<u2").tobytes()
    else:  # u16
        lo = float(np.min(cube))
        hi = float(np.max(cube))
        scale = (hi - lo) / 65535.0 or 1.0
        # float32 arithmetic, the device quantizer's formula.
        q = np.round((cube.astype(np.float32, copy=False) - np.float32(lo)) / np.float32(scale))
        blob = np.ascontiguousarray(q, dtype="<u2").tobytes()
        headers["X-Cube-Scale"] = f"{scale:.9e}"
        headers["X-Cube-Offset"] = f"{lo:.9e}"
    return _deflate(blob, compress, headers), headers


def encode_cube_prequantized(q: np.ndarray, scale: float, offset: float,
                             compress: str = "") -> Tuple[bytes, Dict[str, str]]:
    """Wire-encode a cube already quantized to uint16 on the card (the u16
    response): the denormalisation is folded into the affine headers, and
    the buffer goes to the wire as it is. Decodes with
    :func:`decode_cube_response`."""
    headers = {"X-Cube-Encoding": "u16",
               "X-Cube-Shape": "x".join(str(int(d)) for d in q.shape),
               "X-Cube-Scale": f"{scale:.9e}",
               "X-Cube-Offset": f"{offset:.9e}"}
    blob = np.ascontiguousarray(q, dtype="<u2").tobytes()
    return _deflate(blob, compress, headers), headers


def decode_cube_response(blob: bytes, headers, mat_key: str = "data", raw: bool = False):
    """Inverse of :func:`encode_cube` → a float32 (H, W, C) cube.

    ``headers`` is any mapping with ``.get`` (an http.client response or an
    http.server request), so this decodes responses on a client and binary
    request bodies on the server. ``raw=True`` (u16 and bf16 only) returns
    ``(array, scale, offset)`` with the array still 2 bytes a value: uint16
    codes for u16, the uint16 bit patterns for bf16 (where the JAX package
    returns an ``ml_dtypes.bfloat16`` array of the same bits; scale and
    offset None). Every malformed payload raises ValueError.

    A deflated payload inflates under a hard bound: the declared cube's byte
    count (itself capped by ``_MAX_BODY_BYTES``), or the body cap for .mat."""
    encoding = headers.get("X-Cube-Encoding", "mat")
    if encoding not in WIRE_ENCODINGS:
        raise ValueError(f"unknown X-Cube-Encoding {encoding!r}")
    shape = None
    if encoding != "mat":
        shape_hdr = headers.get("X-Cube-Shape")
        if not shape_hdr:
            raise ValueError(f"binary cube payload (X-Cube-Encoding: {encoding}) is missing "
                             "the X-Cube-Shape header (e.g. '128x128x64')")
        try:
            shape = tuple(int(d) for d in shape_hdr.split("x"))
        except ValueError:
            raise ValueError(f"malformed X-Cube-Shape {shape_hdr!r} (expected e.g. '128x128x64')")
        if len(shape) != 3 or any(d <= 0 for d in shape):
            raise ValueError(f"X-Cube-Shape {shape_hdr!r} is not a positive HxWxC cube shape")
        # Dimension bomb: the declared size in Python integers, before numpy
        # sees a shape past ssize_t (an OverflowError would be a 5xx).
        declared = shape[0] * shape[1] * shape[2] * (4 if encoding == "f32" else 2)
        if declared > _MAX_BODY_BYTES:
            raise ValueError(f"X-Cube-Shape {shape_hdr!r} declares a {declared}-byte cube "
                             f"(> the {_MAX_BODY_BYTES >> 20} MiB body cap)")
    if headers.get("Content-Encoding", "") == "deflate":
        import zlib

        limit = declared if shape is not None else _MAX_BODY_BYTES
        d = zlib.decompressobj()
        try:
            blob = d.decompress(blob, limit + 1)
        except zlib.error as e:
            raise ValueError(f"deflate payload failed to decompress: {e}")
        if len(blob) > limit:
            raise ValueError(f"deflated payload decompresses past its {limit}-byte bound "
                             "(declared shape × itemsize for binary cubes, the body cap "
                             "for .mat)")
        if not d.eof:
            raise ValueError("deflate payload is truncated (incomplete stream)")
    if encoding == "mat":
        return io_hsi.load_hsi_bytes(blob, mat_key=mat_key)
    if encoding == "f32":
        return np.frombuffer(blob, dtype="<f4").reshape(shape).astype(np.float32)
    if encoding == "bf16":
        bits = np.frombuffer(blob, dtype="<u2").reshape(shape)
        return (bits, None, None) if raw else _bf16_to_f32(bits)
    scale_hdr = headers.get("X-Cube-Scale")
    offset_hdr = headers.get("X-Cube-Offset")
    if scale_hdr is None or offset_hdr is None:
        raise ValueError("u16 cube payload requires X-Cube-Scale and X-Cube-Offset headers")
    try:
        scale, offset = float(scale_hdr), float(offset_hdr)
    except ValueError:
        raise ValueError(f"malformed X-Cube-Scale/X-Cube-Offset ({scale_hdr!r}, {offset_hdr!r})")
    if not (math.isfinite(scale) and math.isfinite(offset)):
        raise ValueError(f"X-Cube-Scale/X-Cube-Offset must be finite ({scale_hdr!r}, "
                         f"{offset_hdr!r})")
    q = np.frombuffer(blob, dtype="<u2").reshape(shape)
    if raw:
        return q, scale, offset
    # float32 in place: the decode's peak stays ~2x the body.
    out = q.astype(np.float32)
    out *= np.float32(scale)
    out += np.float32(offset)
    return out


# -- micro-batching ------------------------------------------------------------


class _MicroBatcher:
    """Coalesces concurrent same-bucket requests into one batched forward.

    Requests that arrive within ``window_ms`` of the first pending one in a
    bucket are stacked (up to ``max_batch``) and run by ``run_batch`` on the
    batcher's own thread."""

    def __init__(self, run_batch: Callable, max_batch: int = 4, window_ms: float = 5.0):
        self._run_batch = run_batch          # (list[np.ndarray]) -> list[outputs]
        self.max_batch = max(int(max_batch), 1)
        self.window_s = window_ms / 1e3
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Dict[Tuple[int, int], list] = {}
        self._closed = False
        self.batched_runs = 0
        self.max_batch_seen = 0
        self._thread = threading.Thread(target=self._loop, name="micro-batcher", daemon=True)
        self._thread.start()

    def submit(self, bucket: Tuple[int, int], x: np.ndarray):
        """Enqueue one padded cube; returns a Future of its output tuple."""
        from concurrent.futures import Future

        fut: Future = Future()
        with self._cv:
            if self._closed:
                # The loop has exited or is draining: an entry would never run.
                fut.set_exception(RuntimeError("batcher is closed"))
                return fut
            self._pending.setdefault(bucket, []).append((x, time.monotonic(), fut))
            self._cv.notify()
        return fut

    def _take_ready(self):
        """Pop the first bucket whose window expired or whose batch is full."""
        now = time.monotonic()
        for bucket, entries in self._pending.items():
            if len(entries) >= self.max_batch or now - entries[0][1] >= self.window_s:
                del self._pending[bucket]
                return bucket, entries[: self.max_batch], entries[self.max_batch:]
        return None

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                ready = self._take_ready()
                if ready is None:
                    oldest = min(e[0][1] for e in self._pending.values())
                    self._cv.wait(timeout=max(self.window_s - (time.monotonic() - oldest), 1e-4))
                    continue
                bucket, batch, rest = ready
                if rest:
                    self._pending[bucket] = rest
            futs = [f for _, _, f in batch]
            try:
                outs = self._run_batch([x for x, _, _ in batch])
                with self._lock:
                    self.batched_runs += 1
                    self.max_batch_seen = max(self.max_batch_seen, len(batch))
                for f, o in zip(futs, outs):
                    f.set_result(o)
            except BaseException as e:  # handed to every waiting request
                for f in futs:
                    f.set_exception(e)

    def counters(self) -> tuple:
        """``(batched_runs, max_batch_seen)``, read together under the lock."""
        with self._lock:
            return self.batched_runs, self.max_batch_seen

    def close(self, timeout: float = 60.0) -> bool:
        """Stop the loop thread; True when it has drained."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            print(f"warning: micro-batcher still draining after {timeout:.0f}s (in-flight batch)")
            return False
        return True


# -- the service ---------------------------------------------------------------

# Histogram bounds (seconds) of the X-Inference-Seconds region.
_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 60.0)

# How long rank 0's shutdown waits for the other ranks to leave.
_LEAVE_TIMEOUT_S = 60.0
_STOPPED = "the mesh service has stopped"


class EnhanceService:
    """Checkpoint-backed enhancement with shape buckets.

    The model is built on the host: it holds the float32 weights
    (``_params_template``, what a reload re-quantizes) and gives the
    structure; every forward runs it through ``torch.func.functional_call``
    on ``params``, the weights on the device (a quantized state dict when
    ``serve_quantize`` is set). ``state_dict`` (a port state dict) takes the
    place of a checkpoint; without either, the weights are the seeded
    initialisation.

    With ``mesh`` every rank of the group builds the service at once, and
    the forward is ``evaluate.ShardedInferencer`` over ``cfg.data_axis``.
    Rank 0 alone reads the weights (a failure raises on every rank) and
    broadcasts them; it takes the requests and sends each forward, warmup
    and reload to the other ranks, which run them in :meth:`follow`."""

    # Normalisations whose reductions an edge pad leaves unchanged (it adds no
    # new extremum); per_channel_standardization's mean and std move.
    _PAD_SAFE_NORMS = (None, "", "self", "global_normalization", "per_channel_normalization")

    def __init__(self, cfg: Config, channels: int, checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, mesh=None):
        from sshslie_torch.evaluate import Inferencer, ShardedInferencer
        from sshslie_torch.ops.quant import QuantizedInferencer

        self.cfg = cfg
        self.channels = channels
        self.pad_multiple = int(cfg.serve_pad_multiple)
        self.quantize = cfg.serve_quantize
        # Before any weight is touched, as in JAX.
        if (mesh is not None or cfg.mesh_shape) and self.quantize:
            raise ValueError("serve_quantize is single-chip only")
        self.mesh = mesh
        self.leads = mesh is None or mesh.rank == 0
        self.device = resolve_device(cfg.device)
        self.model = self._new_model()
        self._load_weights(checkpoint_path, state_dict)
        self._params_template = {k: v.detach() for k, v in self.model.state_dict().items()}
        self.checkpoint_path = checkpoint_path
        self.reload_count = 0
        self.params = self._device_weights(self._params_template)
        # The mesh's command channel (None without a group), and why rank 0
        # takes no more commands once it does not.
        self._commands: Optional[distributed.Commands] = None
        self._refused: Optional[str] = None
        if mesh is not None:
            distributed.broadcast_(list(self.params.values()))
            self._infer = ShardedInferencer(self.model, mesh, cfg.data_axis, self.device)
            if distributed.active():
                self._commands = distributed.Commands(self.device)
        elif self.quantize:
            self._infer = QuantizedInferencer(self.model, self.params, 1, self.device)
        else:
            self._infer = Inferencer(self.model, 1, self.device)
        # Serializes all device work. Never held re-entrantly: a request
        # releases it after the forward, and _fetch_reduced takes it again.
        #
        # Streams: every thread here (the HTTP handlers, the batcher) queues
        # its work on the device's default stream, which no thread replaces,
        # so a handler's crop and quantization queue behind the forward that
        # made S, even when the batcher thread ran it. Every forward also
        # ends in a synchronize of that stream (the X-Inference-Seconds
        # region), so its outputs are complete before another thread sees
        # them.
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._buckets: set = set()
        self._encoded_fns: Dict[str, Callable] = {}
        self.requests = 0
        self.total_secs = 0.0
        self.max_secs = 0.0
        self.error_count = 0
        # Non-cumulative counts; the last slot is +Inf (metrics_text sums them).
        self._hist = [0] * (len(_LATENCY_BUCKETS) + 1)
        self.batcher: Optional[_MicroBatcher] = None
        if cfg.serve_max_batch > 1 and mesh is None:
            self.batcher = _MicroBatcher(self._run_batch, cfg.serve_max_batch,
                                         cfg.serve_batch_window_ms)

    def _new_model(self) -> torch.nn.Module:
        from sshslie_torch.models.enhance import build_model

        return build_model(self.cfg, self.channels, torch.device("cpu"),
                           generator=torch.Generator().manual_seed(self.cfg.seed_value))

    def _load_weights(self, checkpoint_path: Optional[str],
                      state_dict: Optional[Dict[str, torch.Tensor]]) -> None:
        """``state_dict``, or the checkpoint, into the host model: on rank 0
        alone under a mesh (the others take its weights by broadcast), whose
        failure every rank raises (one ``broadcast_object``)."""
        error = None
        if self.leads:
            try:
                if state_dict is not None:
                    self.model.load_state_dict(state_dict)
                elif checkpoint_path:
                    if not os.path.exists(checkpoint_path):
                        raise FileNotFoundError(f"no checkpoint at {checkpoint_path}; train "
                                                "first or set test_timestamp")
                    interop.load_checkpoint(checkpoint_path, self.model)
            except Exception as e:
                if self.mesh is None:
                    raise
                error = e
        if self.mesh is None:
            return
        said = distributed.broadcast_object(
            None if error is None else f"{type(error).__name__}: {error}", self.device)
        if error is not None:
            raise error
        if said is not None:
            raise RuntimeError(f"rank 0 could not load the serving weights: {said}")

    def _device_weights(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """The weights the forwards read: ``state_dict`` on the device, or its
        quantized form (quantized on the host, then uploaded)."""
        if not self.quantize:
            return {k: v.to(self.device, copy=True) for k, v in state_dict.items()}
        from sshslie_torch.ops.quant import output_axes, quantize_state_dict, to_device

        qsd, stats = quantize_state_dict(state_dict, self.quantize, axes=output_axes(self.model))
        print(f"Serving {self.quantize}-quantized weights: {stats['bytes_fp32']} → "
              f"{stats['bytes_quant']} bytes ({stats['tensors_quantized']} tensors)")
        return to_device(qsd, self.device)

    def _sync(self) -> None:
        with span("serve.sync"):
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

    @contextlib.contextmanager
    def _locked(self):
        """The device lock, the wait for it a ``serve.lock_wait`` span."""
        with span("serve.lock_wait"):
            self._device_lock.acquire()
        try:
            yield
        finally:
            self._device_lock.release()

    # -- the mesh's commands ---------------------------------------------------

    def _check_leads(self) -> None:
        if not self.leads:
            raise RuntimeError(f"rank {self.mesh.rank} follows rank 0's commands "
                               "(EnhanceService.follow); rank 0 takes the requests")

    def _lead(self, header: Dict[str, Any], payload=None):
        """Rank 0 of a mesh, under the device lock: send ``header`` to the
        other ranks, then run the command here with ``payload``. A failure
        once the command went out leaves the ranks out of step, so every
        later command is refused."""
        if self._refused:
            raise RuntimeError(self._refused)
        if self._commands is None:
            return self._execute(header, payload)
        self._commands.post(header)
        try:
            out = self._execute(header, payload)
        except BaseException as e:
            self._refused = (f"the mesh is out of step since a {header['op']} command failed "
                             f"({type(e).__name__}: {e}); restart the server")
            raise
        self._commands.done()
        return out

    def _execute(self, header: Dict[str, Any], payload=None):
        """One command on this rank, ending in a synchronize: 'enhance' (the
        normalised, bucket-padded cube, ``payload`` on rank 0; returns the
        outputs), 'warmup' (zeros of the bucket) or 'reload' (the new device
        weights, ``payload`` on rank 0, swapped in once every rank holds
        them)."""
        op, out = header["op"], None
        if op == "enhance":
            out = self._infer.from_rank0(self.params, payload, header["shape"])
        elif op == "warmup":
            self._infer(self.params, torch.zeros(header["shape"], device=self.device))
        elif op == "reload":
            weights = payload or {k: torch.empty(shape, dtype=getattr(torch, dtype),
                                                 device=self.device)
                                  for k, shape, dtype in header["weights"]}
            distributed.broadcast_(list(weights.values()))
            self.params = weights
            # Rank 0 acknowledges the reload only once every rank holds them.
            distributed.barrier(self.device)
        else:
            raise ValueError(f"unknown command {op!r}")
        self._sync()
        return out

    def follow(self) -> None:
        """The other ranks of a mesh service: run rank 0's commands in its
        order until it sends "stop". Waiting for the next one, a rank sits on
        the host, in no collective. SIGINT and SIGTERM (taken here when this
        is the main thread) end the loop between commands; rank 0 stops the
        other ranks on the same signals, since torchrun sends them to all."""
        if self.leads:
            raise RuntimeError("rank 0 takes the requests; the other ranks follow it")
        stop = threading.Event()
        previous = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                previous[sig] = signal.signal(sig, lambda *_: stop.set())
        try:
            while True:
                header = self._commands.next(stop.is_set)
                if header is None or header["op"] == "stop":
                    return
                with self._device_lock:
                    self._execute(header)
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
            self._commands.leave()

    def close(self) -> None:
        """Stop the micro-batcher; on rank 0 of a mesh, send "stop" and wait
        for the other ranks to leave. Later commands are refused."""
        if self.batcher is not None:
            self.batcher.close()
        if self._commands is None or not self.leads:
            return
        with self._device_lock:
            if self._refused == _STOPPED:
                return
            # Ranks out of step since a failed command do not read the stop.
            failed, self._refused = self._refused, _STOPPED
            self._commands.post({"op": "stop"})
            if failed is None and not self._commands.wait_left(_LEAVE_TIMEOUT_S):
                print(f"warning: not every rank left the mesh service within "
                      f"{_LEAVE_TIMEOUT_S:.0f} s of the stop")

    def _run_batch(self, xs):
        """Stack same-bucket cubes, zero-pad the batch to a power of two, run
        one forward (on the batcher's thread), split the results."""
        b = len(xs)
        bp = _round_up_pow2(b, self.batcher.max_batch)
        x = np.stack(xs)
        if bp != b:
            x = np.concatenate([x, np.zeros((bp - b,) + x.shape[1:], x.dtype)])
        with self._locked():
            with span("serve.forward"):
                R, I, Id, S = self._infer.batched(x, self.params)
            self._sync()
        return [(R[i], I[i], Id[i], S[i]) for i in range(b)]

    def _bucket(self, h: int, w: int) -> Tuple[int, int]:
        m = self.pad_multiple
        return _round_up(h, m), _round_up(w, m)

    def _fetch_reduced(self, S: torch.Tensor, wire: str, h: int, w: int, raw: bool = False):
        """S cropped to (h, w) on the device, then cast to bfloat16 or
        quantized to uint16 there, so the device-to-host copy moves 2 bytes
        a value. Returns a float32 host array or, with ``raw`` (u16 only),
        ``(uint16 array, scale, offset)``.

        The crop comes first, so the u16 range covers the real pixels only
        (the network's output over the edge pad must not widen it). The u16
        codes travel as int16 (the same bits): few ops take ``torch.uint16``."""
        with span("serve.fetch"):
            with self._locked():
                S = S[:h, :w, :]
                if wire == "bf16":
                    return S.to(torch.bfloat16).cpu().float().numpy()
                lo = torch.min(S)
                scale = torch.clamp_min((torch.max(S) - lo) / 65535.0, 1e-30)
                q = torch.round((S - lo) / scale).to(torch.int32)
                q = torch.where(q >= 32768, q - 65536, q).to(torch.int16)
                meta = torch.stack([lo, scale]).cpu()
            qa = q.cpu().numpy().view(np.uint16)
        if raw:
            return qa, float(meta[1]), float(meta[0])
        return qa.astype(np.float32) * float(meta[1]) + float(meta[0])

    @property
    def accepts_encoded_requests(self) -> bool:
        """Can u16/bf16 request bodies take the device-decode path? Not when
        micro-batched (the batcher stacks host float32 cubes), nor on a mesh
        (such bodies decode on the host and go through :meth:`enhance`), nor
        with a normalisation an edge pad changes."""
        return (self.batcher is None and self.mesh is None
                and self.cfg.normalization in self._PAD_SAFE_NORMS)

    def _encoded_fn(self, encoding: str) -> Callable:
        """(int16 tensor of the payload's bits, scale, offset) → the
        normalised float32 cube, on the device: u16 codes widened to int32
        (``& 0xFFFF``) and through the affine, bf16 bits reinterpreted; then
        ``normalize_like_load_torch``. One function an encoding."""
        fn = self._encoded_fns.get(encoding)
        if fn is not None:
            return fn
        cfg = self.cfg

        def decode(t: torch.Tensor, scale: float, offset: float) -> torch.Tensor:
            if encoding == "u16":
                x = (t.to(torch.int32) & 0xFFFF).to(torch.float32) * scale + offset
            else:
                x = t.view(torch.bfloat16).to(torch.float32)
            return io_hsi.normalize_like_load_torch(x, cfg.normalization, cfg.global_max,
                                                    cfg.global_min)

        self._encoded_fns[encoding] = decode
        return decode

    def enhance_encoded(self, q: np.ndarray, encoding: str, scale: Optional[float] = None,
                        offset: Optional[float] = None, artifacts: bool = False,
                        wire: str = "f32") -> Dict[str, Any]:
        """Enhance a compact u16/bf16 payload (``decode_cube_response(...,
        raw=True)``): edge-padded on the host at 2 bytes a value, uploaded as
        it is, decoded and normalised on the device, then as :meth:`enhance`."""
        with span("serve.request"):
            return self._enhance_encoded(q, encoding, scale, offset, artifacts, wire)

    def _enhance_encoded(self, q: np.ndarray, encoding: str, scale: Optional[float],
                         offset: Optional[float], artifacts: bool, wire: str) -> Dict[str, Any]:
        if not self.accepts_encoded_requests:
            raise ValueError("device-side encoded requests are unavailable on this service "
                             "(micro-batched, or pad-sensitive normalization) — decode on "
                             "host and call enhance()")
        if encoding not in ("u16", "bf16"):
            raise ValueError(f"enhance_encoded takes u16/bf16 payloads, got {encoding!r}")
        if q.ndim != 3 or q.shape[-1] != self.channels:
            raise ValueError(f"expected (H, W, {self.channels}) cube, got {q.shape}")
        h, w, _ = q.shape
        bh, bw = self._bucket(h, w)
        if (bh, bw) != (h, w):
            q = np.pad(q, ((0, bh - h), (0, bw - w), (0, 0)), mode="edge")
        bits = np.require(q, requirements=["C", "W"]).view(np.int16)
        decode = self._encoded_fn(encoding)
        # Python floats that float32 holds exactly: the affine in float32.
        s = float(np.float32(0.0 if scale is None else scale))
        o = float(np.float32(0.0 if offset is None else offset))
        start = time.perf_counter()
        with self._locked():
            with span("serve.upload"):
                t = torch.from_numpy(bits).to(self.device)
            with span("serve.decode"):
                x = decode(t, s, o)
            with span("serve.forward"):
                R, I, Id, S = self._infer(self.params, x)
            self._sync()
        secs = time.perf_counter() - start
        return self._finalize(R, I, Id, S, h, w, bh, bw, secs, wire, artifacts)

    def enhance(self, cube: np.ndarray, artifacts: bool = False,
                wire: str = "f32") -> Dict[str, Any]:
        """Enhance one raw (H, W, C) cube: normalise on the host, pad to its
        bucket, forward, denormalise S.

        Returns {'S', 'seconds'} and R_low/I_low/I_delta with ``artifacts``.
        ``seconds`` is the upload and the forward, ending in a synchronize
        (the X-Inference-Seconds region). ``wire`` ('f32' | 'bf16' | 'u16')
        sets how S leaves the device (:meth:`_fetch_reduced`); 'u16_wire'
        returns 'S_wire', the uint16 codes with the denormalisation folded
        into their affine, in place of 'S'. On a mesh (rank 0) the region
        also holds the command to the other ranks and the cube's broadcast."""
        with span("serve.request"):
            return self._enhance(cube, artifacts, wire)

    def _enhance(self, cube: np.ndarray, artifacts: bool, wire: str) -> Dict[str, Any]:
        cfg = self.cfg
        self._check_leads()
        if cube.ndim != 3 or cube.shape[-1] != self.channels:
            raise ValueError(f"expected (H, W, {self.channels}) cube, got {cube.shape}")
        # C order: scipy's loadmat gives Fortran-ordered cubes, and a strided
        # upload would run the convolutions in another memory format.
        x = io_hsi.normalize_like_load(cube.astype(np.float32, order="C"), cfg.normalization,
                                       cfg.global_max, cfg.global_min)
        h, w, _ = x.shape
        bh, bw = self._bucket(h, w)
        if (bh, bw) != (h, w):
            x = np.pad(x, ((0, bh - h), (0, bw - w), (0, 0)), mode="edge")
        start = time.perf_counter()
        if self.batcher is not None:
            R, I, Id, S = self.batcher.submit((bh, bw), x).result()
        elif self.mesh is not None:
            with self._locked(), span("serve.forward"):
                R, I, Id, S = self._lead({"op": "enhance", "shape": x.shape}, x)
        else:
            with self._locked():
                with span("serve.forward"):
                    R, I, Id, S = self._infer(self.params, x)
                self._sync()
        secs = time.perf_counter() - start
        return self._finalize(R, I, Id, S, h, w, bh, bw, secs, wire, artifacts)

    def _finalize(self, R, I, Id, S, h, w, bh, bw, secs, wire, artifacts):
        """The tail of both request paths: fetch S (reduced or float32),
        denormalise, fetch the artifacts, record the stats."""
        cfg = self.cfg
        denorm = cfg.global_min is not None and cfg.global_max is not None
        if wire == "u16_wire":
            q, scale, offset = self._fetch_reduced(S, "u16", h, w, raw=True)
            if denorm:
                width = cfg.global_max - cfg.global_min
                scale, offset = scale * width, offset * width + cfg.global_min
            self._record_stats(bh, bw, secs)
            return {"S_wire": {"q": q, "scale": scale, "offset": offset}, "seconds": secs}
        if wire in ("bf16", "u16"):
            S = self._fetch_reduced(S, wire, h, w)
        else:
            with span("serve.fetch"):
                S = S[:h, :w, :].cpu().numpy()
        if denorm:
            S = S * (cfg.global_max - cfg.global_min) + cfg.global_min
        out = {"S": S, "seconds": secs}
        if artifacts:
            out["R_low"] = R[:h, :w, :].cpu().numpy()
            out["I_low"] = I[:h, :w, :].cpu().numpy()
            out["I_delta"] = Id[:h, :w, :].cpu().numpy()
        self._record_stats(bh, bw, secs)
        return out

    def _record_stats(self, bh, bw, secs) -> None:
        with self._stats_lock:
            self.requests += 1
            self.total_secs += secs
            self.max_secs = max(self.max_secs, secs)
            self._buckets.add((bh, bw))
            self._hist[bisect.bisect_left(_LATENCY_BUCKETS, secs)] += 1

    def warmup(self, shapes: Sequence[Tuple[int, int]]) -> None:
        """Run each bucket of ``shapes`` once on zeros; micro-batched, every
        batch size a request can take (the powers of two under
        ``max_batch``, and ``max_batch``). On a mesh (rank 0) every rank runs
        each warmup."""
        self._check_leads()
        for h, w in shapes:
            bh, bw = self._bucket(h, w)
            if (bh, bw) in self._buckets:
                continue
            sizes = [None]
            if self.batcher is not None:
                sizes, b = [], 1
                while b < self.batcher.max_batch:
                    sizes.append(b)
                    b *= 2
                sizes.append(self.batcher.max_batch)
            for b in sizes:
                with self._device_lock:
                    if self.mesh is not None:
                        self._lead({"op": "warmup", "shape": (bh, bw, self.channels)})
                    elif b is None:
                        self._infer(self.params, torch.zeros((bh, bw, self.channels),
                                                             device=self.device))
                    else:
                        self._infer.batched(torch.zeros((b, bh, bw, self.channels),
                                                        device=self.device), self.params)
                    self._sync()
            with self._stats_lock:
                self._buckets.add((bh, bw))
            print(f"Warmed bucket ({bh}, {bw})")

    def reload(self, checkpoint_path: Optional[str] = None) -> Dict[str, Any]:
        """Swap in the weights of a checkpoint (``.pth``) without a restart.

        The checkpoint loads into a new host model (strict: a bad file
        changes nothing), is quantized again when the service is, and the new
        device weights replace the old under the device lock; the old ones
        are dropped, the inferencer's copy included. On a mesh rank 0 loads
        it and broadcasts the weights, and every rank swaps them at the same
        point in the request order."""
        self._check_leads()
        path = checkpoint_path or self.checkpoint_path
        if not path:
            raise ValueError("no checkpoint path configured for reload")
        model = self._new_model()
        epoch = interop.load_checkpoint(path, model)
        template = {k: v.detach() for k, v in model.state_dict().items()}
        weights = self._device_weights(template)
        with self._device_lock:
            if self.mesh is not None:
                self._lead({"op": "reload", "weights": [
                    (k, tuple(v.shape), str(v.dtype).rsplit(".", 1)[-1])
                    for k, v in weights.items()]}, weights)
            self.params = weights
            if self.quantize:
                self._infer.qparams = weights
        self._params_template = template
        self.checkpoint_path = path
        with self._stats_lock:
            self.reload_count += 1
        return {"reloaded": path, "epoch": epoch, "reloads": self.reload_count}

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            n = self.requests
            out = {"requests": n, "avg_seconds": self.total_secs / n if n else 0.0,
                   "max_seconds": self.max_secs, "buckets": sorted(self._buckets),
                   "pad_multiple": self.pad_multiple}
        if self.batcher is not None:
            out["batched_runs"], out["max_batch_seen"] = self.batcher.counters()
            out["max_batch"] = self.batcher.max_batch
        return out

    def record_error(self) -> None:
        """Count one HTTP error response (any 4xx/5xx) for /metrics."""
        with self._stats_lock:
            self.error_count += 1

    def metrics_text(self) -> str:
        """Prometheus text exposition (version 0.0.4), the JAX package's series.
        Latency is the X-Inference-Seconds region (transport excluded)."""
        with self._stats_lock:
            n, total, mx = self.requests, self.total_secs, self.max_secs
            errors, hist = self.error_count, list(self._hist)
            buckets, reloads = len(self._buckets), self.reload_count
        lines = [
            "# HELP sshslie_requests_total Enhancement requests completed.",
            "# TYPE sshslie_requests_total counter",
            f"sshslie_requests_total {n}",
            "# HELP sshslie_request_errors_total HTTP 4xx/5xx responses.",
            "# TYPE sshslie_request_errors_total counter",
            f"sshslie_request_errors_total {errors}",
            "# HELP sshslie_reloads_total Successful checkpoint hot-reloads.",
            "# TYPE sshslie_reloads_total counter",
            f"sshslie_reloads_total {reloads}",
            "# HELP sshslie_compiled_buckets Warmed or served shape buckets.",
            "# TYPE sshslie_compiled_buckets gauge",
            f"sshslie_compiled_buckets {buckets}",
            "# HELP sshslie_inference_seconds Device inference latency "
            "(compute only; transport excluded).",
            "# TYPE sshslie_inference_seconds histogram",
        ]
        cum = 0
        for bound, count in zip(_LATENCY_BUCKETS, hist):
            cum += count
            lines.append(f'sshslie_inference_seconds_bucket{{le="{bound}"}} {cum}')
        lines.append(f'sshslie_inference_seconds_bucket{{le="+Inf"}} {cum + hist[-1]}')
        lines.append(f"sshslie_inference_seconds_sum {total}")
        lines.append(f"sshslie_inference_seconds_count {n}")
        lines += [
            "# HELP sshslie_inference_seconds_max Worst request since start.",
            "# TYPE sshslie_inference_seconds_max gauge",
            f"sshslie_inference_seconds_max {mx}",
        ]
        if self.batcher is not None:
            runs, seen = self.batcher.counters()
            lines += [
                "# HELP sshslie_batched_runs_total Micro-batched device dispatches.",
                "# TYPE sshslie_batched_runs_total counter",
                f"sshslie_batched_runs_total {runs}",
                "# HELP sshslie_max_batch_seen Largest micro-batch coalesced so far.",
                "# TYPE sshslie_max_batch_seen gauge",
                f"sshslie_max_batch_seen {seen}",
            ]
        return "\n".join(lines) + "\n"


# -- HTTP ----------------------------------------------------------------------


def _make_handler(service: EnhanceService):
    cfg = service.cfg

    class Handler(BaseHTTPRequestHandler):
        # A stalled upload releases its thread (and its buffered body).
        timeout = 120

        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _json(self, code: int, payload: Dict[str, Any]) -> None:
            if code >= 400:
                # Every JSON error reply passes here.
                service.record_error()
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):  # noqa: N802
            path = urlparse(self.path).path
            if path == "/metrics":
                blob = service.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
            elif path == "/health":
                dev = service.device
                info = {"status": "ok", "backend": dev.type, "channels": service.channels}
                if dev.type == "cuda":
                    info["device_name"] = torch.cuda.get_device_name(dev)
                self._json(200, {**info, **service.stats()})
            elif path == "/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def _reload(self, query) -> None:
            target = query.get("checkpoint", [None])[0]
            if target is not None:
                # Loading an arbitrary path is a weight-swap primitive: it
                # needs the shared token. compare_digest on bytes: constant
                # time, and a non-ASCII header gets a 403, not a reset.
                token = cfg.serve_reload_token
                supplied = self.headers.get("X-Reload-Token", "")
                ok = token and hmac.compare_digest(
                    supplied.encode("utf-8", "surrogateescape"),
                    token.encode("utf-8", "surrogateescape"))
                if not ok:
                    self._json(403, {"error": "reload with an explicit checkpoint path requires "
                                              "a matching X-Reload-Token (config "
                                              "serve_reload_token)"})
                    return
            try:
                self._json(200, service.reload(target))
            except (ValueError, FileNotFoundError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the client gets an HTTP error
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):  # noqa: N802
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query)
            if parsed.path == "/reload":
                self._reload(query)
                return
            if parsed.path != "/enhance":
                self._json(404, {"error": f"unknown path {parsed.path}"})
                return
            key = query.get("key", [cfg.mat_key])[0]
            artifacts = query.get("artifacts", ["0"])[0] in ("1", "true")
            encoding = query.get("encoding", ["mat"])[0]
            compress = query.get("compress", [""])[0]
            if encoding not in WIRE_ENCODINGS:
                self._json(400, {"error": f"unknown encoding {encoding!r} "
                                          f"(choices: {', '.join(WIRE_ENCODINGS)})"})
                return
            if compress not in ("", "zlib"):
                self._json(400, {"error": f"unknown compress {compress!r} (choices: zlib)"})
                return
            if artifacts and encoding != "mat":
                self._json(400, {"error": "artifacts=1 requires encoding=mat (binary "
                                          "encodings carry only the enhanced cube)"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._json(400, {"error": "invalid Content-Length header"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body; POST a .mat file"})
                return
            if length > _MAX_BODY_BYTES:
                # Before reading: a huge Content-Length must not be buffered.
                self._json(413, {"error": f"body of {length} bytes exceeds the "
                                          f"{_MAX_BODY_BYTES >> 20} MiB limit"})
                return
            body = self.rfile.read(length)
            try:
                # bf16/u16 responses leave the device at 2 bytes a value; u16
                # is the passthrough of the card's own codes.
                wire = encoding if encoding in ("bf16", "u16") else "f32"
                if encoding == "u16" and not artifacts:
                    wire = "u16_wire"
                req_enc = self.headers.get("X-Cube-Encoding", "mat")
                if req_enc in ("u16", "bf16") and service.accepts_encoded_requests:
                    q, scale, offset = decode_cube_response(body, self.headers, mat_key=key,
                                                            raw=True)
                    result = service.enhance_encoded(q, req_enc, scale, offset,
                                                     artifacts=artifacts, wire=wire)
                else:
                    cube = decode_cube_response(body, self.headers, mat_key=key)
                    result = service.enhance(cube, artifacts=artifacts, wire=wire)
            except (KeyError, ValueError) as e:
                # A KeyError's str is the repr of its argument: send the message.
                msg = e.args[0] if isinstance(e, KeyError) and e.args else str(e)
                self._json(400, {"error": msg})
                return
            except Exception as e:  # noqa: BLE001 — the client gets an HTTP error
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if artifacts:
                import scipy.io as sio

                buf = io.BytesIO()
                sio.savemat(buf, {cfg.mat_key_prediction: result["S"], "R_low": result["R_low"],
                                  "I_low": result["I_low"], "I_delta": result["I_delta"]})
                extra: Dict[str, str] = {}
                blob = _deflate(buf.getvalue(), compress, extra)
            elif "S_wire" in result:
                sw = result["S_wire"]
                blob, extra = encode_cube_prequantized(sw["q"], sw["scale"], sw["offset"],
                                                       compress)
            else:
                blob, extra = encode_cube(result["S"], encoding, compress,
                                          mat_key=cfg.mat_key_prediction)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(blob)))
            self.send_header("X-Inference-Seconds", f"{result['seconds']:.6f}")
            for h, v in extra.items():
                self.send_header(h, v)
            self.end_headers()
            self.wfile.write(blob)

    return Handler


class EnhanceServer:
    """ThreadingHTTPServer around a service; ``port=0`` picks a free port. On
    a rank that follows rank 0 of a mesh service it binds nothing, and
    :meth:`serve_forever` follows rank 0's commands until it stops them."""

    def __init__(self, service: EnhanceService, host: str = "127.0.0.1", port: int = 8900):
        self.service = service
        self.httpd: Optional[ThreadingHTTPServer] = None
        self.host = self.port = None
        if service.leads:
            self.httpd = ThreadingHTTPServer((host, port), _make_handler(service))
            self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    def start(self) -> "EnhanceServer":
        """Serve on a daemon thread (rank 0 of a mesh); returns self."""
        self.service._check_leads()
        self._serving = True
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="http-server",
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        if self.httpd is None:
            print(f"Rank {self.service.mesh.rank} follows rank 0's commands")
            self.service.follow()
            return
        where = "" if self.service.mesh is None else f", rank 0 of {self.service.mesh}"
        print(f"Serving on http://{self.host}:{self.port} "
              f"(buckets of {self.service.pad_multiple}px{where})")
        self._serving = True
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving, then close the service (on rank 0 of a mesh: "stop"
        to the other ranks)."""
        if self.httpd is not None:
            # socketserver's shutdown() waits for serve_forever to return: on
            # a server that never served it would block forever.
            if self._serving:
                self.httpd.shutdown()
            self.httpd.server_close()
        self.service.close()
        if self._thread:
            self._thread.join(timeout=5)


def parse_warmup(spec: str) -> list:
    """'512x512,1024x768' → [(512, 512), (1024, 768)]."""
    shapes = []
    for part in spec.split(","):
        part = part.strip()
        if part:
            h, w = part.lower().split("x")
            shapes.append((int(h), int(w)))
    return shapes


def build_server_from_config(cfg: Config, mesh=None) -> EnhanceServer:
    """The construction half of ``--phase serve``: resolve the checkpoint
    (``model_epoch_latest.pth`` of ``test_timestamp``), build the service,
    warm its buckets, bind the server (not yet serving). The two TF32
    switches are set from ``matmul_precision``, as the runner sets them.
    With ``mesh`` every rank builds the service; rank 0 warms the buckets
    (the other ranks run those warmups once they follow) and binds the
    server, and the others' server binds nothing."""
    if cfg.channels is None:
        raise ValueError("phase=serve requires an explicit 'channels' config")
    ckpt = checkpoints.latest_path(cfg.test_model_dir)
    set_matmul_precision(cfg)
    service = EnhanceService(cfg, cfg.channels, checkpoint_path=ckpt, mesh=mesh)
    if cfg.serve_warmup and service.leads:
        service.warmup(parse_warmup(cfg.serve_warmup))
    return EnhanceServer(service, cfg.serve_host, cfg.serve_port)


def serve_from_config(cfg: Config, mesh=None) -> None:
    """``--phase serve``: load the test checkpoint and serve until stopped.
    On a mesh rank 0 serves and the other ranks follow; rank 0 takes SIGTERM
    as Ctrl-C, and either stops every rank, which then return."""
    server = build_server_from_config(cfg, mesh=mesh)
    try:
        if mesh is None:
            server.serve_forever()
        else:
            _serve_until_stopped(server)
    finally:
        server.shutdown()


def _serve_until_stopped(server: EnhanceServer) -> None:
    """``server.serve_forever()`` on a mesh, rank 0 ending on SIGINT or
    SIGTERM (taken when this is the main thread) without an error."""
    previous = None
    if server.httpd is not None and threading.current_thread() is threading.main_thread():
        def stop(*_):
            raise KeyboardInterrupt

        previous = signal.signal(signal.SIGTERM, stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("Stopping: rank 0 stops the other ranks")
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    from sshslie_torch.config import parse_args

    _cfg = parse_args()
    if _cfg.phase != "serve":
        # Re-derive the run names so that test_timestamp picks the checkpoint
        # directory (parse_args finalized with the YAML's phase).
        _cfg.phase = "serve"
        _cfg.timestamp = ""
        _cfg.finalize()
    serve_from_config(_cfg)
