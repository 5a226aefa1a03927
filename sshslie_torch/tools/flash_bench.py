"""Time the flash-attention kernel alone on the card.

    python -m sshslie_torch.tools.flash_bench [--shapes 1,4,4096,16 1,4,16384,16]
                                              [--dtypes bfloat16 float32] [--reps 50]

Run from the repository's root: the timer, the peak rates and the bound are
``chip_smoke.py``'s. For each shape and dtype, on seeded normal q, k, v: the
kernel's time, the plain ``sdpa_chunked``'s and
``F.scaled_dot_product_attention``'s (a yardstick the port never calls), all
queued behind a sleep kernel so that the card's time and not the host's
dispatch is timed (``chip_smoke.py``'s kernels line times them with dispatch);
the bound; and the kernel's max |error| against ``sdpa_chunked`` on the
operands widened to float32 (the Pallas kernel's float32 p) and against the
plain version on the same operands. One JSON line a row, then the card's name
and power limit. Needs a CUDA card and nvcc; no part of the port imports it.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from chip_smoke import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound_ms, card_line, flash_work, time_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["1,4,4096,16", "1,4,16384,16"])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA card")
        return 1
    from sshslie_torch.config import Config
    from sshslie_torch.device import set_matmul_precision
    from sshslie_torch.ops import attention

    set_matmul_precision(Config())  # full float32: TF32 off
    g = torch.Generator().manual_seed(0)
    for spec in args.shapes:
        shape = tuple(int(x) for x in spec.split(","))
        qkv32 = [torch.randn(shape, generator=g).cuda() for _ in range(3)]
        for name in args.dtypes:
            dtype = getattr(torch, name)
            q, k, v = (t.to(dtype) for t in qkv32)
            got = attention.flash_attention(q, k, v).float()
            ref32 = attention.sdpa_chunked(q.float(), k.float(), v.float())
            plain = attention.sdpa_chunked(q, k, v).float()
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
            bound, bound_by = bound_ms(flash_work(shape, q.element_size()), peak)
            print(json.dumps({
                "shape": list(shape), "dtype": name,
                "ms": time_ms(lambda: attention.flash_attention(q, k, v), args.reps, queued=True),
                "plain_ms": time_ms(lambda: attention.sdpa_chunked(q, k, v), 3, queued=True),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v), args.reps,
                                      queued=True),
                "bound_ms": bound, "bound_by": bound_by,
                "err_vs_float32_p": float((got - ref32).abs().max()),
                "err_vs_plain": float((got - plain).abs().max()),
                "max_abs_o": float(ref32.abs().max()), "max_abs_v": float(v.float().abs().max())}),
                flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
