"""Build the CUDA kernels of ``sshslie_torch/csrc`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface, which ``ctypes`` loads: no PyTorch headers, so a build takes
seconds rather than the minutes of ``torch.utils.cpp_extension``. The first
call to :func:`library` starts one ``nvcc`` per source, all at once, and waits
for them (with the loads, a ``kernels.load`` span); later calls reuse the
loaded libraries. The output file's name carries a hash of the sources, so an
edited kernel is rebuilt and a stale one is never loaded.

Libraries go to ``build/sshslie_torch_kernels/`` at the root of the checkout.
A build that fails raises with nvcc's output; nothing falls back.

``python -m sshslie_torch.ops._build`` prints ptxas's registers, shared
memory and spills of every kernel (``-Xptxas -v``, compile only).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

from sshslie_torch.observability import span

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "sshslie_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> list:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    for path in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels cannot be built")


def _target(name: str) -> str:
    digest = hashlib.sha256()
    for f in sorted(os.listdir(CSRC)):
        if f == f"{name}.cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                digest.update(f.encode() + fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{name: library path}``; raises RuntimeError naming each source
    that failed, with nvcc's output.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {name: _target(name) for name in kernel_names()}
    todo = {n: t for n, t in targets.items() if not os.path.exists(t)}
    if not todo:
        return targets
    nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with span("kernels.load"):
                for n, path in build_all().items():
                    if n not in _libs:
                        _libs[n] = _declare(ctypes.CDLL(path))
            lib = _libs[name]
        return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sshslie_error_string.argtypes = [ctypes.c_int]
    lib.sshslie_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if code != 0:
        msg = lib.sshslie_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptxas_report() -> str:
    """nvcc -Xptxas -v of every source, compiled to a throwaway object:
    registers, shared memory and spill bytes of each kernel instantiation."""
    nvcc = _nvcc()
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in kernel_names():
            cmd = [nvcc, *flags, "-Xptxas", "-v", "-c", "-I", CSRC, "-o",
                   os.path.join(tmp, f"{name}.o"), os.path.join(CSRC, f"{name}.cu")]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)
        out = []
        for name, proc in procs.items():
            text, _ = proc.communicate()
            out.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{text}")
    return "\n".join(out)


if __name__ == "__main__":
    print(ptxas_report())
