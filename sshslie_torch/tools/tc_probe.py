"""Probe of the H100's tensor-core forms behind the bfloat16 conv kernels.

    python -m sshslie_torch.tools.tc_probe

Builds ``tc_probe.cu`` (with the port's ``csrc/mma.cuh``) into
``build/sshslie_torch_kernels/`` and prints:

* the wgmma layout checks: a K-major and an MN-major B (m64n64k16) read
  through a descriptor that starts at row s of a 128-byte swizzled tile,
  against a float32 product (max |err|);
* the throughput, TFLOP/s, of mma.sync m16n8k16 (bare, and with the
  ldmatrix loads of a 64 x 64 warp tile) and of wgmma with A from
  registers, two warpgroups (8 warps) a block, one and two blocks an SM;
* the card's name, power limit and SM clock.

Needs a CUDA card and nvcc; no part of the port imports it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from sshslie_torch.ops import _build

HERE = os.path.dirname(os.path.abspath(__file__))
LOOPS = {0: ("wgmma m64n64k16, A in registers", 64), 1: ("wgmma m64n32k16, A in registers", 32),
         2: ("mma.sync m16n8k16", 64), 3: ("mma.sync m16n8k16 + ldmatrix", 64)}


def _library() -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "tc_probe.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so,
           os.path.join(HERE, "tc_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(so)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card")
        return 1
    lib = _library()
    dev = torch.device("cuda")
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(2 * sms * 256, device=dev)
    iters = 2000
    for which, (name, n) in LOOPS.items():
        for per_sm in (1, 2):
            blocks = per_sm * sms
            lib.probe_loop(which, ctypes.c_void_p(out.data_ptr()), blocks, 10)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            code = lib.probe_loop(which, ctypes.c_void_p(out.data_ptr()), blocks, iters)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            # A block's iteration: 4 k steps x 4 tiles of 64 x n x 16 per warpgroup, 2 warpgroups.
            flop = 2.0 * blocks * iters * 4 * 4 * 2 * 64 * n * 16
            print(f"{name}, {blocks} blocks: code {code}, {ms:.3f} ms, {flop / ms / 1e9:.1f} TFLOP/s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
