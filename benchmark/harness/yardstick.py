"""The yardstick: the card's published peaks, the model's operations counted
from its layer shapes, and the operations and bytes of each hand kernel.

Peaks (NVIDIA H100 SXM data sheet, dense): 67 TFLOP/s float32 outside the
tensor cores, 495 TF32, 989 bfloat16, exponentials 16 a clock per SM at
1.98 GHz, 3.35 TB/s of HBM3. A kernel's bound is the largest of its
operations, its exponentials and its bytes at those rates; each input byte
is read once and each output byte written once.

Model operations: a convolution counts 2·k²·Cin·Cout·Hout·Wout, the
transposed convolution counts on its input pixels, a linear 2·in·out a
token, attention 4·B·heads·S²·D. Elementwise work, the FFT and Adam count
nothing. A training step is three network applications of its batch (the
forward, the re-decomposition of S, and a backward of twice their cost); a
served request is one forward.
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_EXP = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"float32": 4, "tf32": 4, "bfloat16": 2}


def label(dtype) -> str:
    """The launch counters' label (a torch dtype, or "tf32") as a key here."""
    return str(dtype).replace("torch.", "")


def bound_s(work: Tuple[float, float, float], peak: float) -> float:
    flops, nbytes, exps = work
    return max(flops / peak, exps / PEAK_EXP, nbytes / PEAK_BYTES)


def conv9_work(shape, esize: int, k: int = 9) -> Tuple[float, float, float]:
    """One k x k 64 -> 64 pass over NHWC ``shape``: x and w read, y written."""
    b, h, w, c = shape
    return 2.0 * b * h * w * k * k * c * c, esize * (2.0 * b * h * w * c + k * k * c * c), 0.0


def wgrad_work(shape, esize: int, k: int = 9) -> Tuple[float, float, float]:
    """The weight gradient over NHWC ``shape``: x and dy read, dW (float32) written."""
    b, h, w, c = shape
    return 2.0 * b * h * w * k * k * c * c, 2.0 * esize * b * h * w * c + 4.0 * k * k * c * c, 0.0


def flash_work(shape, esize: int) -> Tuple[float, float, float]:
    """Attention over (B, heads, S, D): q, k, v read once, o written once."""
    b, h, s, d = shape
    return 4.0 * b * h * s * s * d, 4.0 * esize * b * h * s * d, float(b * h * s * s)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def forward_flops(bands: int, h: int, w: int, channel: int = 64, heads: int = 4,
                  head_dim: int = 16, ff_dim: int = 64) -> dict:
    """Operations of one forward of one (h, w, bands) cube ->
    {"decomposition": ..., "illumination": ...}."""
    ch = channel

    def conv(ci, co, k, scale):
        return 2.0 * k * k * ci * co * _ceil_div(h, scale) * _ceil_div(w, scale)

    decomposition = (conv(bands, ch // 2, 3, 1) + conv(bands, ch, 9, 1) + conv(ch, ch, 3, 1)
                     + conv(ch, 2 * ch, 3, 2) + conv(2 * ch, 2 * ch, 3, 2)
                     + conv(2 * ch, ch, 3, 2)                 # transposed: its input pixels
                     + conv(2 * ch, ch, 3, 1) + conv(ch + ch // 2, ch, 3, 1)
                     + conv(ch, bands + 1, 3, 1))
    tokens = _ceil_div(h, 8) * _ceil_div(w, 8)
    total = heads * head_dim
    attention = (2.0 * tokens * (3 * ch * total + total * ff_dim + ff_dim * ch)
                 + 4.0 * heads * tokens * tokens * head_dim)
    illumination = (conv(bands + 1, ch, 3, 1) + conv(ch, ch, 3, 2) + conv(ch, ch, 3, 4)
                    + conv(ch, ch, 3, 8) + attention + conv(ch, ch, 3, 4) + conv(ch, ch, 3, 2)
                    + conv(ch, ch, 3, 1) + conv(3 * ch, ch, 1, 1) + conv(ch, 1, 3, 1))
    return {"decomposition": decomposition, "illumination": illumination}


def train_step_flops(bands: int, batch: int, patch: int, **widths) -> float:
    f = forward_flops(bands, patch, patch, **widths)
    return 3.0 * batch * (2 * f["decomposition"] + f["illumination"])


def request_flops(bands: int, h: int, w: int, **widths) -> float:
    f = forward_flops(bands, h, w, **widths)
    return f["decomposition"] + f["illumination"]


def roofline_pct(launches: dict, seconds: float, work_fn, passes) -> "float | None":
    """100 x (sum of the bounds of the counted launches) / (their kernels'
    time); ``launches`` {(pass, label, shape): count}. None when nothing ran."""
    bound = sum(n * bound_s(work_fn(shape, ELEMENT_BYTES[label(lab)]), PEAK_FLOPS[label(lab)])
                for (p, lab, shape), n in launches.items() if p in passes)
    if bound <= 0.0 or seconds <= 0.0:
        return None
    return 100.0 * bound / seconds
