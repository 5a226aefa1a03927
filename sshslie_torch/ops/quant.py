"""Weight-only quantization for inference (int8 / fp8 / int4), as
``sshslie_tpu/ops/quant.py``, on the port's state dicts.

Every weight with ndim >= 2 and at least ``min_size`` elements is quantized
per output channel with a symmetric scale, on the host in float32 (the
weights are under 1 MB). The quantized tensors and their scales are what
goes to the device; :func:`dequantize_state_dict` turns them back into
float32 weights inside each forward, so the weights stay 8- or 4-bit in
device memory and the forward (conv9 and flash included) sees float32.

Formats (JAX ``_FORMATS``):
  * ``int8``: q = round(w / s) in [-127, 127], s = amax / 127.
  * ``fp8``:  w / s cast to ``torch.float8_e4m3fn``, s = amax / 448.
  * ``int4``: q = round(w / s) in [-7, 7], s = amax / 7, two values a
    ``uint8`` byte (low nibble the even index) along the output axis; an odd
    output count pads one zero nibble.

Rounding is ``torch.round``, half to even, as ``jnp.round``.

**The output axis.** JAX takes the last axis of every kernel as the output
axis. The port's layouts (``interop.py``) put it elsewhere: axis 0 of a
Conv2d weight (OIHW) and of a Linear weight (out, in), axis 1 of a
ConvTranspose2d weight (IOHW). :func:`output_axes` reads it from the model;
scales keep the weight's rank with 1 on every other axis, and the int4
nibble pairs run along it. After the layout map (``interop.jax_layout``:
``q`` transposed as its weight, the scale as a vector) every byte equals the
JAX package's.

Calibration (it changes only the scales): ``absmax`` (s = amax / Qmax),
``mse`` (per output channel, the clip ratio of ``_MSE_GRID`` with the least
weight reconstruction error; fp8 falls back to absmax), ``auto`` (absmax),
and the output-aware :func:`calibrate_quantize_state_dict` (a greedy search
of per-tensor clip ratios on the error of the whole quantized forward
against float32 on calibration cubes).

JAX names: ``quantize_tree`` -> :func:`quantize_state_dict`,
``calibrate_quantize_tree`` -> :func:`calibrate_quantize_state_dict`,
``dequantize_tree`` -> :func:`dequantize_state_dict`; a quantized node is a
:class:`QuantizedTensor` instead of a ``{"__quantized__", "q", "scale"}``
dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sshslie_torch.evaluate import Inferencer

_FORMATS = {
    "int8": {"max": 127.0},
    "fp8": {"max": 448.0},
    "int4": {"max": 7.0},
}

# Clip ratios of the mse calibration (JAX ``_MSE_GRID``).
_MSE_GRID = np.linspace(0.30, 1.00, 36)
# Clip ratios of the output-aware calibration; 1.0 (absmax) first, so the
# search only keeps improvements over it.
_OUTPUT_GRID = (1.0, 0.95, 0.90, 0.85, 0.80, 0.70, 0.60)


@dataclasses.dataclass
class QuantizedTensor:
    """One quantized weight: ``q`` (int8, float8_e4m3fn, or uint8 nibble
    pairs for int4), its float32 ``scale`` (1 on every axis but ``axis``)
    and the output axis."""

    q: torch.Tensor
    scale: torch.Tensor
    axis: int

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device), self.axis)

    @property
    def nbytes(self) -> int:
        """Device bytes: the stored q (int4 two values a byte) and the scales."""
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4


def _reduce_dims(w: torch.Tensor, axis: int) -> Tuple[int, ...]:
    return tuple(d for d in range(w.ndim) if d != axis)


def _amax(w: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.amax(torch.abs(w), dim=_reduce_dims(w, axis), keepdim=True)


def _guard(scale: torch.Tensor) -> torch.Tensor:
    # Guard the scale, not amax: a tiny positive amax (~2e-38) passes amax > 0
    # while amax / Qmax underflows to 0, and w / 0 would make inf weights.
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def _mse_scale(w: torch.Tensor, amax: torch.Tensor, qmax: float, axis: int) -> torch.Tensor:
    """Per output channel, the scale r * amax / qmax over ``_MSE_GRID`` with
    the least sum((dq - w)^2); the first of equal errors wins."""
    dims = _reduce_dims(w, axis)
    best_err = best_scale = None
    for r in _MSE_GRID:
        scale = _guard(amax * (float(r) / qmax))
        q = torch.clamp(torch.round(w / scale), -qmax, qmax)
        err = torch.sum(torch.square(q * scale - w), dim=dims, keepdim=True)
        if best_err is None:
            best_err, best_scale = err, scale
        else:
            pick = err < best_err
            best_err = torch.where(pick, err, best_err)
            best_scale = torch.where(pick, scale, best_scale)
    return best_scale


def _resolve_calibration(fmt: str, calibration: str) -> str:
    if calibration not in ("auto", "absmax", "mse"):
        raise ValueError(
            f"unknown calibration {calibration!r} (use auto|absmax|mse; "
            "'output' needs data — see calibrate_quantize_state_dict)")
    if calibration == "auto":
        # Weight-MSE clipping hurts this model's output PSNR (the JAX
        # package's measurement); output-aware calibration needs cubes.
        return "absmax"
    if calibration == "mse" and fmt == "fp8":
        # fp8 is a saturating cast with a per-value step, not a uniform grid.
        return "absmax"
    return calibration


def _pack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """int4 values (int8 in [-7, 7]) two a ``uint8`` byte along ``axis``: the
    low nibble the even index, the high nibble the odd one."""
    qu = q.to(torch.int8).view(torch.uint8) & 0xF
    if qu.shape[axis] % 2:
        pad = list(qu.shape)
        pad[axis] = 1
        qu = torch.cat([qu, qu.new_zeros(pad)], dim=axis)
    n = qu.shape[axis]
    even = qu.index_select(axis, torch.arange(0, n, 2, device=qu.device))
    odd = qu.index_select(axis, torch.arange(1, n, 2, device=qu.device))
    return even | (odd << 4)


def _unpack_int4(p: torch.Tensor, cout: int, axis: int) -> torch.Tensor:
    """Inverse of :func:`_pack_int4` → int32 values, ``cout`` along ``axis``."""
    lo = (p & 0xF).to(torch.int32)
    hi = (p >> 4).to(torch.int32)
    q = torch.stack([(lo ^ 8) - 8, (hi ^ 8) - 8], dim=axis + 1).flatten(axis, axis + 1)
    return q.narrow(axis, 0, cout)


def _quantize_with_scale(w: torch.Tensor, fmt: str, scale: torch.Tensor,
                         axis: int) -> QuantizedTensor:
    qmax = _FORMATS[fmt]["max"]
    if fmt == "fp8":
        q = (w / scale).to(torch.float8_e4m3fn)
    else:
        q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
        if fmt == "int4":
            q = _pack_int4(q, axis)
    return QuantizedTensor(q, scale.float(), axis)


def quantize_array(w: torch.Tensor, fmt: str = "int8", calibration: str = "auto",
                   axis: int = 0) -> QuantizedTensor:
    """Per-output-channel symmetric quantization of one weight, ``axis`` its
    output axis."""
    spec = _FORMATS[fmt]
    calibration = _resolve_calibration(fmt, calibration)
    w = torch.as_tensor(w).detach().to("cpu", torch.float32)
    amax = _amax(w, axis)
    if calibration == "mse":
        scale = _mse_scale(w, amax, spec["max"], axis)
    else:
        scale = _guard(amax / spec["max"])
    return _quantize_with_scale(w, fmt, scale, axis)


def _ratio_quantize(w: torch.Tensor, fmt: str, ratio: float, axis: int) -> QuantizedTensor:
    """quantize_array with an explicit clip ratio: s = ratio * amax / Qmax."""
    w = torch.as_tensor(w).detach().to("cpu", torch.float32)
    scale = _guard(_amax(w, axis) * (float(ratio) / _FORMATS[fmt]["max"]))
    return _quantize_with_scale(w, fmt, scale, axis)


def dequantize_array(node: QuantizedTensor) -> torch.Tensor:
    """float32 weights of a quantized node, on its device."""
    q = node.q
    if q.dtype == torch.uint8:  # packed int4; the true count is the scale's
        q = _unpack_int4(q, node.scale.shape[node.axis], node.axis)
    return q.to(torch.float32) * node.scale


def output_axes(model: torch.nn.Module) -> Dict[str, int]:
    """The output axis of each parameter of the port's model: 1 for a
    ConvTranspose2d weight (IOHW), 0 for every other (OIHW, (out, in))."""
    from sshslie_torch.models.layers import ConvTranspose2d

    axes = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            axes[key] = 1 if isinstance(m, ConvTranspose2d) and pname == "weight" else 0
    return axes


def _quantizable(t: torch.Tensor, min_size: int) -> bool:
    return t.ndim >= 2 and t.numel() >= min_size


def quantize_state_dict(state_dict: Dict[str, torch.Tensor], fmt: str = "int8",
                        min_size: int = 64, calibration: str = "auto",
                        axes: Optional[Dict[str, int]] = None
                        ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Quantize every weight with ndim >= 2 and >= ``min_size`` elements, on
    the host; ``axes`` maps a key to its output axis (:func:`output_axes`;
    0 where it is missing). Returns (quantized state dict, stats): biases and
    small tensors stay float32 CPU tensors; stats count the bytes before and
    after and the tensors quantized."""
    if fmt not in _FORMATS:
        raise ValueError(f"unknown quantization format {fmt!r} (use {list(_FORMATS)})")
    _resolve_calibration(fmt, calibration)  # validate up front
    axes = axes or {}
    stats = {"bytes_fp32": 0, "bytes_quant": 0, "tensors_quantized": 0}
    out: Dict[str, Any] = {}
    for key, t in state_dict.items():
        t = t.detach().to("cpu", torch.float32)
        stats["bytes_fp32"] += t.numel() * 4
        if _quantizable(t, min_size):
            node = quantize_array(t, fmt, calibration, axes.get(key, 0))
            stats["bytes_quant"] += node.nbytes
            stats["tensors_quantized"] += 1
            out[key] = node
        else:
            stats["bytes_quant"] += t.numel() * 4
            out[key] = t
    return out, stats


def dequantize_state_dict(qsd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """float32 weights of a quantized state dict, each on its own device."""
    return {k: dequantize_array(v) if isinstance(v, QuantizedTensor) else v
            for k, v in qsd.items()}


def to_device(qsd: Dict[str, Any], device) -> Dict[str, Any]:
    """A quantized state dict with every tensor on ``device``."""
    return {k: v.to(device) for k, v in qsd.items()}


def _quantized_forward(model: torch.nn.Module, qsd: Dict[str, Any], x: torch.Tensor):
    return torch.func.functional_call(model, dequantize_state_dict(qsd), (x,))


class QuantizedInferencer(Inferencer):
    """Whole-cube forward over quantized weights (JAX ``QuantizedInferencer``):
    ``evaluate.Inferencer`` whose explicit weights are a quantized state dict
    on the device (None: the instance's own, ``qparams``), dequantized inside
    the forward. ``model`` gives the structure; its own weights are not read."""

    def __init__(self, model: torch.nn.Module, qsd: Dict[str, Any], pad_multiple: int = 1,
                 device: Optional[torch.device] = None):
        super().__init__(model, pad_multiple, device)
        self.qparams = to_device(qsd, self.device)

    def _fn(self, qsd: Optional[Dict[str, Any]]):
        qp = self.qparams if qsd is None else qsd
        return lambda x: _quantized_forward(self.model, qp, x)


def _forward_s(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return model(x)[3]


def calibrate_quantize_state_dict(model: torch.nn.Module, cubes: Sequence, fmt: str = "int4",
                                  min_size: int = 64, grid=_OUTPUT_GRID):
    """Output-aware clip calibration (JAX ``calibrate_quantize_tree``): per
    tensor, the clip ratio of ``grid`` that minimizes the summed MSE of the
    quantized forward's S against the float32 forward's on ``cubes``
    (normalised (H, W, C) cubes). (1) the best single ratio for all tensors,
    (2) one greedy pass over the tensors in key order (the JAX package's
    path order), keeping a ratio only where it improves the objective; both
    start from absmax (r = 1.0), so the result is never worse on ``cubes``.

    Returns (quantized state dict on the model's device, stats, {key: ratio})."""
    if fmt not in _FORMATS:
        raise ValueError(f"unknown quantization format {fmt!r} (use {list(_FORMATS)})")
    device = next(model.parameters()).device
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()}
    axes = output_axes(model)
    leaves = {k: t for k, t in sd.items() if _quantizable(t, min_size)}
    xs = [torch.as_tensor(np.asarray(c, np.float32))[None].to(device) for c in cubes]
    refs = [_forward_s(model, x).float() for x in xs]
    base, stats = quantize_state_dict(sd, fmt, min_size, "absmax", axes)
    base = to_device(base, device)

    def build(ratios: Dict[str, float]) -> Dict[str, Any]:
        qsd = dict(base)
        for key, r in ratios.items():
            if r != 1.0:
                qsd[key] = _ratio_quantize(leaves[key], fmt, r, axes.get(key, 0)).to(device)
        return qsd

    def objective(qsd: Dict[str, Any]) -> float:
        with torch.inference_mode():
            return float(sum(float(torch.mean(torch.square(
                _quantized_forward(model, qsd, x)[3].float() - ref))) for x, ref in zip(xs, refs)))

    ratios = {key: 1.0 for key in leaves}
    qsd = build(ratios)
    best_err = objective(qsd)
    for r in grid:
        if r == 1.0:
            continue
        cand = {key: r for key in ratios}
        err = objective(build(cand))
        if err < best_err:
            best_err, ratios = err, cand
    qsd = build(ratios)
    for key in sorted(leaves, key=lambda k: k.split(".")):
        start = ratios[key]
        for r in grid:
            if r == start:
                continue
            node = _ratio_quantize(leaves[key], fmt, r, axes.get(key, 0)).to(device)
            err = objective({**qsd, key: node})
            if err < best_err:
                best_err, ratios = err, {**ratios, key: r}
                qsd = {**qsd, key: node}
    return qsd, stats, ratios


def quantization_impact(model: torch.nn.Module, cubes: Sequence, fmt: str = "int8",
                        calibration: str = "auto", calib_cubes: Optional[Sequence] = None
                        ) -> Dict[str, Any]:
    """PSNR (data range 1) of the quantized model's S against the float32
    model's, per normalised cube, with the byte counts. ``calibration``
    'output' (and 'auto' for int4) runs :func:`calibrate_quantize_state_dict`
    on ``calib_cubes`` (default ``cubes``)."""
    from sshslie_torch import metrics as M

    resolved = "output" if calibration == "auto" and fmt == "int4" else calibration
    if resolved == "output":
        qsd, stats, _ = calibrate_quantize_state_dict(
            model, calib_cubes if calib_cubes is not None else cubes, fmt)
    else:
        resolved = _resolve_calibration(fmt, calibration)
        qsd, stats = quantize_state_dict(model.state_dict(), fmt, calibration=resolved,
                                         axes=output_axes(model))
    q_inf = QuantizedInferencer(model, qsd)
    psnrs = []
    for cube in cubes:
        x = torch.as_tensor(np.asarray(cube, np.float32))[None].to(q_inf.device)
        S_fp32 = _forward_s(model, x)[0]
        S_q = q_inf(None, x[0])[3]
        psnrs.append(float(M.psnr(S_q, S_fp32, data_range=1.0)))
    return {
        "fmt": fmt,
        "calibration": resolved,
        "psnr_vs_fp32": psnrs,
        "psnr_vs_fp32_avg": float(np.mean(psnrs)) if psnrs else float("nan"),
        "bytes_fp32": stats["bytes_fp32"],
        "bytes_quant": stats["bytes_quant"],
        "compression": stats["bytes_fp32"] / max(stats["bytes_quant"], 1),
        "tensors_quantized": stats["tensors_quantized"],
    }
