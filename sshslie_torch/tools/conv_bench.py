"""Time the conv9 and conv9_wgrad kernels alone on the card, beside cuDNN's calls.

    python -m sshslie_torch.tools.conv_bench [--precision tf32|float32]
                                             [--shapes 1,512,512,64 2,128,128,64]
                                             [--k 9] [--reps 20]
                                             [--passes forward dgrad wgrad]
                                             [--parts 0 1 2 4]

Run from the repository's root: the timer, the peak rates and the bound are
``chip_smoke.py``'s. For each shape, on seeded normal x, dY and weights
(scale 0.05): the forward and the input gradient (the reversed, transposed
weights) through ``conv9_fwd``, and the weight gradient through
``conv9_wgrad``; for each, the kernel's time and the time of cuDNN's call on
the same operands (``F.conv2d``, ``conv2d_input`` and ``conv2d_weight``,
channels-last input; a yardstick the port never calls), each with the host's
dispatch as ``chip_smoke.py``'s kernels line times them and queued behind a
sleep kernel (the card's time alone); the bound; the kernel's max |error|
against its plain version over its largest |output|.

``--precision tf32`` (the default): the TF32 entries (``tf32=True``) against
cuDNN's TF32 calls (``cudnn.allow_tf32`` on), with the largest excess over
the float64 bound of ``tests/test_torch_kernels_cuda.py`` (<= 0 holds).
``--precision float32``: the float32 entries against cuDNN with TF32 off,
the bound at the CUDA cores' float32 rate; ``--parts`` forces the float32
conv's split of its units by output channel (``conv9_fwd(...,
parts=p)``; 0: the selector's choice, printed as ``parts``), and each
forced split's output is held bit for bit against the selector's. Repeats
are held bit-identical. One JSON line a row, then the card's name and
power limit. To A/B a variant or the parent
commit, copy ``sshslie_torch/`` and ``chip_smoke.py`` into a directory under
``build/`` (for the parent, ``git archive`` of it, with this file copied
in), edit it there and run this from that directory (a tree without the
``parts`` argument takes ``--parts 0`` only). Needs a CUDA card and nvcc;
no part of the port imports it.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from chip_smoke import PEAK_F32_FLOPS, PEAK_TF32_FLOPS, bound_ms, card_line, time_ms

TF32_U = 2.0 ** -11
PASSES = ("forward", "dgrad", "wgrad")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", choices=("tf32", "float32"), default="tf32")
    ap.add_argument("--shapes", nargs="+", default=["1,512,512,64", "2,128,128,64"])
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--passes", nargs="+", choices=PASSES, default=list(PASSES))
    ap.add_argument("--parts", nargs="+", type=int, default=[0])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_bench: no CUDA card")
        return 1
    from sshslie_torch.config import Config
    from sshslie_torch.device import set_matmul_precision
    from sshslie_torch.ops import conv9

    tf32 = args.precision == "tf32"
    lib_cfg = Config(matmul_precision="tensorfloat32") if tf32 else Config()
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
        b, h, wd_, c = shape

        def conv(xx, ww, parts):
            if parts:
                return lambda: conv9.conv9_fwd(xx, ww, parts=parts)
            return lambda: conv9.conv9_fwd(xx, ww, tf32=tf32)

        # pass: (operands, kernel for a split, plain version, float64 version,
        # float64 of the magnitudes, products a sum, cuDNN's call)
        cases = {
            "forward": ((x, w), lambda p: conv(x, w, p), lambda: conv9.conv9_plain(x, w, tf32=tf32),
                        lambda: conv9.conv9_plain(x.double(), w.double()),
                        lambda: conv9.conv9_plain(x.double().abs(), w.double().abs()), k * k * 64,
                        lambda: F.conv2d(xc, wc, padding=k // 2)),
            "dgrad": ((x, wd), lambda p: conv(x, wd, p), lambda: conv9.conv9_plain(x, wd, tf32=tf32),
                      lambda: conv9.conv9_plain(x.double(), wd.double()),
                      lambda: conv9.conv9_plain(x.double().abs(), wd.double().abs()), k * k * 64,
                      lambda: torch.nn.grad.conv2d_input(xc.shape, wc, xc, padding=k // 2)),
            "wgrad": ((x, dy), lambda p: (lambda: conv9.conv9_wgrad(x, dy, k, tf32=tf32)),
                      lambda: conv9.conv9_wgrad_plain(x, dy, k, tf32=tf32),
                      lambda: conv9.conv9_wgrad_plain(x.double(), dy.double(), k),
                      lambda: conv9.conv9_wgrad_plain(x.double().abs(), dy.double().abs(), k),
                      x.numel() // 64,
                      lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, dyc, padding=k // 2)),
        }
        for what in args.passes:
            _, make, plain_fn, f64, f64_abs, n, lib = cases[what]
            set_matmul_precision(Config())  # full float32: TF32 off for the checks
            plain = plain_fn()
            auto = make(0)()
            excess = None
            if tf32:
                bound64 = (2 * TF32_U + TF32_U ** 2 + n * 2.0 ** -23) * f64_abs()
                excess = float(((auto.double() - f64()).abs() - bound64).max())
                del bound64
            set_matmul_precision(lib_cfg)
            try:
                lib_ms = time_ms(lib, args.reps)
                lib_q = time_ms(lib, args.reps, queued=True)
            finally:
                set_matmul_precision(Config())
            # conv: x and w in, y out; wgrad: x and dY in, dW out.
            nbytes = 4.0 * (2 * x.numel() + k * k * c * c)
            work = (2.0 * b * h * wd_ * k * k * c * c, nbytes, 0.0)
            bound, bound_by = bound_ms(work, PEAK_TF32_FLOPS if tf32 else PEAK_F32_FLOPS)
            chosen = None
            if not tf32 and what != "wgrad" and hasattr(conv9, "conv9_f32_parts"):
                chosen = conv9.conv9_f32_parts(b, h, wd_, k, conv9.f32_resident(x.device, k))
            for parts in (args.parts if not tf32 and what != "wgrad" else [0]):
                fn = make(parts)
                got = fn()
                rel = float((got - plain).abs().max() / plain.abs().max())
                repeats = bool(torch.equal(got, fn()))
                ms = time_ms(fn, args.reps)
                ms_q = time_ms(fn, args.reps, queued=True)
                row = {"shape": list(shape), "k": k, "pass": what, "precision": args.precision,
                       "parts": parts or chosen, "forced": bool(parts), "ms": ms, "ms_queued": ms_q,
                       "library_ms": lib_ms, "library_ms_queued": lib_q, "bound_ms": bound,
                       "bound_by": bound_by, "share_of_bound": bound / ms_q,
                       "err_vs_plain_rel": rel, "repeats_identical": repeats}
                if parts:
                    row["same_bits_as_chosen"] = bool(torch.equal(got, auto))
                if excess is not None:
                    row["float64_bound_excess"] = excess
                print(json.dumps(row), flush=True)
            del plain, auto
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
