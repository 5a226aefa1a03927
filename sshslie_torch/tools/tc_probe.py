"""Probe of the H100's tensor-core forms behind the bfloat16 and TF32 conv kernels.

    python -m sshslie_torch.tools.tc_probe [--ffma]

Builds ``tc_probe.cu`` (with the port's ``csrc/mma.cuh``) into
``build/sshslie_torch_kernels/`` and prints:

* the wgmma layout checks: a K-major and an MN-major B (m64n64k16) read
  through a descriptor that starts at row s of a 128-byte swizzled tile,
  against a float32 product (max |err|); and the TF32 form of conv9.cu
  (m64n64k8 .tf32, A from registers, a K-major B of 32-float rows from row
  s), against a float64 product of the same TF32 values (max |err| over
  max |product|); and the TF32 form of conv9_wgrad.cu (A dY^T from [px][co]
  rows, rounded as loaded; B X^T K-major without swizzle, the phase copy
  and start of tap offsets 0..12), against float64 on the rounded operands;
* the throughput, TFLOP/s, of mma.sync m16n8k16 (bare, and with the
  ldmatrix loads of a 64 x 64 warp tile) and of wgmma with A from
  registers (bfloat16 k16, TF32 k8; TF32 also with 2 accumulator tiles a
  warpgroup instead of 4, and with B from an unaligned start row), two
  warpgroups (8 warps) a block, one and two blocks an SM; and, 2
  warpgroups a block, one block an SM, of a TF32 chain of 8 dependent k
  steps waited for each time (B swizzled and not) and of the TF32 wgrad
  kernel's tap loop (5 taps, running sums in registers);
* the FFMA rate of the CUDA cores, TFLOP/s (the float32 conv9 kernel's
  thread tiles: 16 x 4, 16 x 2 and 8 x 2 independent accumulators a
  thread, 4 warps a block, 1, 2 and 4 blocks an SM), against the 67
  TFLOP/s that the kernels line's float32 bound assumes; ``--ffma`` prints
  only these;
* the card's name, power limit and SM clock (read after the loops).

Needs a CUDA card and nvcc; no part of the port imports it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from sshslie_torch.ops import _build
from sshslie_torch.ops.conv9 import round_to_tf32

HERE = os.path.dirname(os.path.abspath(__file__))
# which: (name, N, k of one instruction, accumulator tiles a warpgroup)
LOOPS = {0: ("wgmma m64n64k16, A in registers", 64, 16, 4),
         1: ("wgmma m64n32k16, A in registers", 32, 16, 4),
         2: ("mma.sync m16n8k16", 64, 16, 4), 3: ("mma.sync m16n8k16 + ldmatrix", 64, 16, 4),
         4: ("wgmma m64n32k8 .tf32, A in registers, 4 accumulators", 32, 8, 4),
         5: ("wgmma m64n64k8 .tf32, A in registers, 4 accumulators", 64, 8, 4),
         6: ("wgmma m64n64k8 .tf32, A in registers, 2 accumulators", 64, 8, 2),
         7: ("wgmma m64n64k8 .tf32, A in registers, 4 accumulators, B from row 3", 64, 8, 4)}
# which: (name, wgmma a block and iteration): the TF32 wgrad kernel's chains
# of 8 dependent k steps, waited for each iteration, 2 warpgroups a block.
CHAINS = {8: ("a chain of 8 k steps a warpgroup", 16),
          9: ("a chain of 8 k steps a warpgroup, B K-major without swizzle", 16),
          10: ("the wgrad tap loop (5 taps, scale-d false, running sums +=)", 80)}


def _library() -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "tc_probe.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so,
           os.path.join(HERE, "tc_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(so)


# which: (name, accumulators a thread)
FFMA = {11: ("FFMA, 16 x 4 accumulators a thread", 64), 12: ("FFMA, 16 x 2 accumulators a thread", 32),
        13: ("FFMA, 8 x 2 accumulators a thread", 16)}


def timed_loop(lib, which: int, out: torch.Tensor, blocks: int, iters: int) -> tuple:
    """(launch code, ms) of one probe_loop launch after a short warm-up."""
    lib.probe_loop(which, ctypes.c_void_p(out.data_ptr()), blocks, 10)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    code = lib.probe_loop(which, ctypes.c_void_p(out.data_ptr()), blocks, iters)
    end.record()
    torch.cuda.synchronize()
    return code, start.elapsed_time(end)


def ffma(lib, dev) -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(4 * sms * 128, device=dev)
    iters = 20000
    for which, (name, nacc) in FFMA.items():
        for per_sm in (1, 2, 4):
            blocks = per_sm * sms
            code, ms = timed_loop(lib, which, out, blocks, iters)
            flop = 2.0 * blocks * 128 * iters * nacc
            print(f"{name}, {per_sm} block(s) an SM ({blocks} blocks): code {code}, {ms:.3f} ms, "
                  f"{flop / ms / 1e9:.1f} TFLOP/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ffma", action="store_true", help="only the FFMA rates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card")
        return 1
    lib = _library()
    dev = torch.device("cuda")
    if args.ffma:
        ffma(lib, dev)
        return _card()
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 64, generator=g).to(torch.bfloat16).to(dev)
    rows = 128
    x = torch.randn(rows, 64, generator=g).to(torch.bfloat16).to(dev)
    for mn_major in (0, 1):
        for s in (0, 1, 3, 8, 13, 37, 60):
            d = torch.zeros(64, 64, device=dev)
            code = lib.probe_layout(mn_major, ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(x.data_ptr()),
                                    ctypes.c_void_p(d.data_ptr()), rows, s)
            # K-major: B is 64 rows of n (64 k each) from row s; MN-major: 64 rows of k.
            xs = x[s:s + 64].float()
            want = a.float() @ (xs if mn_major else xs.T)
            print(f"layout {'MN' if mn_major else 'K'}-major B, start row {s}: code {code}, "
                  f"max|err| {float((d - want).abs().max()):.3e}")
    # TF32: D (64 x 64) = A (64 x 32) X[s .. s+63]^T from rows of 32 floats.
    at = round_to_tf32(torch.randn(64, 32, generator=g)).to(dev)
    xt = round_to_tf32(torch.randn(rows, 32, generator=g)).to(dev)
    for s in (0, 1, 3, 8, 13, 37, 60):
        d = torch.zeros(64, 64, device=dev)
        code = lib.probe_layout(2, ctypes.c_void_p(at.data_ptr()), ctypes.c_void_p(xt.data_ptr()),
                                ctypes.c_void_p(d.data_ptr()), rows, s)
        want = at.double() @ xt[s:s + 64].double().T
        err = float((d.double() - want).abs().max() / want.abs().max())
        print(f"layout TF32 K-major B (m64n64k8), start row {s}: code {code}, "
              f"max|err| / max|D| {err:.3e}")
    # The TF32 wgrad form: D (64 co x 64 ci) = DY^T X[s .. s+63], the kernel
    # rounding both as conv9_wgrad.cu does.
    xw = torch.randn(79, 64, generator=g).to(dev)
    dyw = torch.randn(64, 64, generator=g).to(dev)
    for s in range(13):
        d = torch.zeros(64, 64, device=dev)
        code = lib.probe_layout(3, ctypes.c_void_p(xw.data_ptr()), ctypes.c_void_p(dyw.data_ptr()),
                                ctypes.c_void_p(d.data_ptr()), 79, s)
        want = round_to_tf32(dyw).double().T @ round_to_tf32(xw[s:s + 64]).double()
        err = float((d.double() - want).abs().max() / want.abs().max())
        print(f"layout TF32 wgrad (A dY^T, B X^T phase copy {s % 4} from pixel {s // 4 * 4}): code {code}, "
              f"max|err| / max|D| {err:.3e}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(2 * sms * 256, device=dev)
    iters = 2000
    for which, (name, n, k, nacc) in LOOPS.items():
        for per_sm in (1, 2):
            blocks = per_sm * sms
            code, ms = timed_loop(lib, which, out, blocks, iters)
            # A block's iteration: 4 k steps x nacc tiles of 64 x n x k per warpgroup, 2 warpgroups.
            flop = 2.0 * blocks * iters * 4 * nacc * 2 * 64 * n * k
            print(f"{name}, {blocks} blocks: code {code}, {ms:.3f} ms, {flop / ms / 1e9:.1f} TFLOP/s")
    out = torch.zeros(sms * 256, device=dev)
    for which, (name, per_iter) in CHAINS.items():
        code, ms = timed_loop(lib, which, out, sms, iters)
        flop = 2.0 * sms * iters * per_iter * 64 * 64 * 8
        print(f"wgmma m64n64k8 .tf32, {name}, {sms} blocks: code {code}, {ms:.3f} ms, "
              f"{flop / ms / 1e9:.1f} TFLOP/s")
    ffma(lib, dev)
    return _card()


def _card() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
