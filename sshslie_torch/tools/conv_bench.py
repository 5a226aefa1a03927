"""Time the TF32 conv9 kernel alone on the card, beside cuDNN's TF32 call.

    python -m sshslie_torch.tools.conv_bench [--shapes 1,512,512,64 2,128,128,64]
                                             [--k 9] [--reps 20]

Run from the repository's root: the timer, the peak rates and the bound are
``chip_smoke.py``'s. For each shape, on seeded normal x and weights (scale
0.05), the forward and the input gradient (the reversed, transposed
weights) through ``conv9_fwd(..., tf32=True)``: the kernel's time and the
time of cuDNN's TF32 call on the same operands (``F.conv2d`` and
``conv2d_input`` with ``cudnn.allow_tf32`` on, channels-last input; a
yardstick the port never calls), each with the host's dispatch as
``chip_smoke.py``'s kernels line times them and queued behind a sleep kernel
(the card's time alone); the bound; the kernel's max |error| against the TF32
plain version over its largest |output|, and its largest excess over the
float64 bound of ``tests/test_torch_kernels_cuda.py`` (<= 0 holds). One JSON
line a row, then the card's name and power limit. To A/B a variant, copy
``sshslie_torch/`` and ``chip_smoke.py`` into a directory under ``build/``,
edit it there and run this from that directory. Needs a CUDA card and nvcc;
no part of the port imports it.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from chip_smoke import PEAK_TF32_FLOPS, bound_ms, card_line, time_ms

TF32_U = 2.0 ** -11


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["1,512,512,64", "2,128,128,64"])
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_bench: no CUDA card")
        return 1
    from sshslie_torch.config import Config
    from sshslie_torch.device import set_matmul_precision
    from sshslie_torch.ops import conv9

    k = args.k
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(k, k, 64, 64, generator=g) * 0.05).cuda()
    for spec in args.shapes:
        shape = tuple(int(s) for s in spec.split(","))
        x = torch.randn(shape, generator=g).cuda()
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous()
        for what, ww, lib in (
                ("forward", w, lambda: F.conv2d(xc, wc, padding=k // 2)),
                ("dgrad", conv9.conv9_dgrad_weights(w),
                 lambda: torch.nn.grad.conv2d_input(xc.shape, wc, xc, padding=k // 2))):
            set_matmul_precision(Config())  # full float32: TF32 off for the checks
            got = conv9.conv9_fwd(x, ww, tf32=True)
            plain = conv9.conv9_plain(x, ww, tf32=True)
            want64 = conv9.conv9_plain(x.double(), ww.double())
            abs64 = conv9.conv9_plain(x.double().abs(), ww.double().abs())
            bound64 = (2 * TF32_U + TF32_U ** 2 + k * k * 64 * 2.0 ** -23) * abs64
            excess = float(((got.double() - want64).abs() - bound64).max())
            rel = float((got - plain).abs().max() / plain.abs().max())
            del want64, abs64, bound64, plain
            ms = time_ms(lambda: conv9.conv9_fwd(x, ww, tf32=True), args.reps)
            ms_q = time_ms(lambda: conv9.conv9_fwd(x, ww, tf32=True), args.reps, queued=True)
            set_matmul_precision(Config(matmul_precision="tensorfloat32"))
            try:
                lib_ms = time_ms(lib, args.reps)
                lib_q = time_ms(lib, args.reps, queued=True)
            finally:
                set_matmul_precision(Config())
            b, h, wd, c = shape
            work = (2.0 * b * h * wd * k * k * c * c, 4.0 * (2 * x.numel() + k * k * c * c), 0.0)
            bound, bound_by = bound_ms(work, PEAK_TF32_FLOPS)
            print(json.dumps({"shape": list(shape), "k": k, "pass": what, "ms": ms,
                              "ms_queued": ms_q, "library_ms": lib_ms, "library_ms_queued": lib_q,
                              "bound_ms": bound, "bound_by": bound_by,
                              "share_of_bound": bound / ms_q, "err_vs_plain_rel": rel,
                              "float64_bound_excess": excess}), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
