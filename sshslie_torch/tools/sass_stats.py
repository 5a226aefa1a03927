"""Instruction mix of the float32 conv9 kernel's inner loop, read from the built library's SASS.

    python -m sshslie_torch.tools.sass_stats [--k 9]

Builds the kernels if they are not built (``ops/_build.py``), disassembles
the conv9 library with ``cuobjdump -sass`` and, for each float32 conv9
kernel at ``--k`` (one a split of the output channels), prints the loop that
holds its FFMAs (the smallest loop with at least nine tenths of them: one
kernel row's taps): its instructions by opcode, the FFMA share of its issue
slots, and the share of its FFMAs with an operand from the reuse cache.
Needs the CUDA toolkit (nvcc, cuobjdump); no part of the port imports it.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess

from sshslie_torch.ops import _build

_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def _cuobjdump() -> str:
    for path in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("cuobjdump not found (PATH or $CUDA_HOME/bin)")


def inner_loop(text: str) -> list:
    """The instructions of the smallest backward-branch loop that holds at
    least nine tenths of the function's FFMAs (``text``: one function's SASS)."""
    insns = [(int(m.group(1), 16), m.group(2)) for m in map(_INSN.match, text.splitlines()) if m]
    total = sum(1 for _, t in insns if t.split()[0] == "FFMA")
    best = insns
    for i, (addr, t) in enumerate(insns):
        m = re.search(r"\bBRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", t)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [x for x in insns[:i + 1] if x[0] >= int(m.group(1), 16)]
        if sum(1 for _, u in body if u.split()[0] == "FFMA") >= 0.9 * total and len(body) < len(best):
            best = body
    return [t for _, t in best]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=9)
    args = ap.parse_args(argv)
    lib = _build.build_all()["conv9"]
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        m = re.search(rf"conv_c64_f32_kernelINS_\d+F32TileILi{args.k}ELi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        body = inner_loop(func)
        ops = collections.Counter(t.split()[1] if t.startswith("@") else t.split()[0] for t in body)
        ffma = [t for t in body if t.startswith("FFMA")]
        reuse = sum(1 for t in ffma if ".reuse" in t)
        print(f"k {args.k}, {m.group(1)} pixels x {m.group(2)} channels a thread: loop of "
              f"{len(body)} instructions, "
              f"FFMA {len(ffma) / len(body):.3f} of them, reuse-cache hits on "
              f"{reuse / max(len(ffma), 1):.3f} of the FFMAs; "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
