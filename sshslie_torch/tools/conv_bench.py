"""Time the TF32 conv9 and conv9_wgrad kernels alone on the card, beside cuDNN's TF32 calls.

    python -m sshslie_torch.tools.conv_bench [--shapes 1,512,512,64 2,128,128,64]
                                             [--k 9] [--reps 20]
                                             [--passes forward dgrad wgrad]

Run from the repository's root: the timer, the peak rates and the bound are
``chip_smoke.py``'s. For each shape, on seeded normal x, dY and weights
(scale 0.05): the forward and the input gradient (the reversed, transposed
weights) through ``conv9_fwd(..., tf32=True)``, and the weight gradient
through ``conv9_wgrad(..., tf32=True)``; for each, the kernel's time and the
time of cuDNN's TF32 call on the same operands (``F.conv2d``,
``conv2d_input`` and ``conv2d_weight`` with ``cudnn.allow_tf32`` on,
channels-last input; a yardstick the port never calls), each with the host's
dispatch as ``chip_smoke.py``'s kernels line times them and queued behind a
sleep kernel (the card's time alone); the bound; the kernel's max |error|
against the TF32 plain version over its largest |output|, and its largest
excess over the float64 bound of ``tests/test_torch_kernels_cuda.py`` (<= 0
holds). One JSON line a row, then the card's name and power limit. To A/B a
variant, copy ``sshslie_torch/`` and ``chip_smoke.py`` into a directory
under ``build/``, edit it there and run this from that directory. Needs a
CUDA card and nvcc; no part of the port imports it.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from chip_smoke import PEAK_TF32_FLOPS, bound_ms, card_line, time_ms

TF32_U = 2.0 ** -11
PASSES = ("forward", "dgrad", "wgrad")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["1,512,512,64", "2,128,128,64"])
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--passes", nargs="+", choices=PASSES, default=list(PASSES))
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
    wc = w.permute(3, 2, 0, 1).contiguous()
    for spec in args.shapes:
        shape = tuple(int(s) for s in spec.split(","))
        x = torch.randn(shape, generator=g).cuda()
        dy = torch.randn(shape, generator=g).cuda()
        xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        wd = conv9.conv9_dgrad_weights(w)
        # pass: (kernel, TF32 plain version, float64 version, float64 of the
        # magnitudes, products a sum, cuDNN's TF32 call)
        cases = {
            "forward": (lambda: conv9.conv9_fwd(x, w, tf32=True),
                        lambda: conv9.conv9_plain(x, w, tf32=True),
                        lambda: conv9.conv9_plain(x.double(), w.double()),
                        lambda: conv9.conv9_plain(x.double().abs(), w.double().abs()), k * k * 64,
                        lambda: F.conv2d(xc, wc, padding=k // 2)),
            "dgrad": (lambda: conv9.conv9_fwd(x, wd, tf32=True),
                      lambda: conv9.conv9_plain(x, wd, tf32=True),
                      lambda: conv9.conv9_plain(x.double(), wd.double()),
                      lambda: conv9.conv9_plain(x.double().abs(), wd.double().abs()), k * k * 64,
                      lambda: torch.nn.grad.conv2d_input(xc.shape, wc, xc, padding=k // 2)),
            "wgrad": (lambda: conv9.conv9_wgrad(x, dy, k, tf32=True),
                      lambda: conv9.conv9_wgrad_plain(x, dy, k, tf32=True),
                      lambda: conv9.conv9_wgrad_plain(x.double(), dy.double(), k),
                      lambda: conv9.conv9_wgrad_plain(x.double().abs(), dy.double().abs(), k),
                      x.numel() // 64,
                      lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, dyc, padding=k // 2)),
        }
        for what in args.passes:
            fn, plain_fn, f64, f64_abs, n, lib = cases[what]
            set_matmul_precision(Config())  # full float32: TF32 off for the checks
            got = fn()
            plain = plain_fn()
            bound64 = (2 * TF32_U + TF32_U ** 2 + n * 2.0 ** -23) * f64_abs()
            excess = float(((got.double() - f64()).abs() - bound64).max())
            rel = float((got - plain).abs().max() / plain.abs().max())
            repeats = bool(torch.equal(got, fn()))
            del bound64, plain
            ms = time_ms(fn, args.reps)
            ms_q = time_ms(fn, args.reps, queued=True)
            set_matmul_precision(Config(matmul_precision="tensorfloat32"))
            try:
                lib_ms = time_ms(lib, args.reps)
                lib_q = time_ms(lib, args.reps, queued=True)
            finally:
                set_matmul_precision(Config())
            b, h, wd_, c = shape
            # conv: x and w in, y out; wgrad: x and dY in, dW out.
            nbytes = 4.0 * (2 * x.numel() + k * k * c * c)
            work = (2.0 * b * h * wd_ * k * k * c * c, nbytes, 0.0)
            bound, bound_by = bound_ms(work, PEAK_TF32_FLOPS)
            print(json.dumps({"shape": list(shape), "k": k, "pass": what, "ms": ms,
                              "ms_queued": ms_q, "library_ms": lib_ms, "library_ms_queued": lib_q,
                              "bound_ms": bound, "bound_by": bound_by,
                              "share_of_bound": bound / ms_q, "err_vs_plain_rel": rel,
                              "float64_bound_excess": excess, "repeats_identical": repeats}),
                  flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
