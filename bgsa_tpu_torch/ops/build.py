"""Build and load the port's CUDA kernels.

The sources under ``bgsa_tpu_torch/csrc/`` are compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library lands in ``build/bgsa_tpu_torch/`` at the repository root, named by
a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the cached library.

Importing this module builds nothing. ``load()`` builds on first use (the
first kernel launch on a CUDA tensor, or ``Engine.compile_for``), and a
failed build raises with the nvcc command and its stderr.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "bgsa_tpu_torch")
SOURCES = ("myers_semiglobal.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_kernels = None


@dataclasses.dataclass
class Kernels:
    """The loaded kernel library."""

    lib: ctypes.CDLL
    path: str
    log: str  # nvcc's stderr (ptxas register and spill report); "" when cached
    build_seconds: float  # 0.0 when the cached library was loaded
    reg_words: int  # largest W whose Myers state stays in registers

    def check(self, rc: int, name: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if rc != 0:
            msg = self.lib.bgsa_error_string(rc).decode()
            raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} ({msg})")


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return nvcc


def compile_library(sources, out_dir: str) -> tuple[str, str, float]:
    """Compile ``sources`` into ``out_dir``; returns (path, nvcc stderr, seconds).

    The file name carries a hash of the sources and flags; an existing file
    of that name is reused (stderr "", 0 seconds). Raises RuntimeError on a
    failed build.
    """
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    path = os.path.join(out_dir, f"libbgsa_kernels-{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, "", 0.0
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path, proc.stderr, seconds


def load() -> Kernels:
    """Build (on first use) and load the kernel library."""
    global _kernels
    with _lock:
        if _kernels is None:
            sources = [os.path.join(CSRC_DIR, s) for s in SOURCES]
            path, log, seconds = compile_library(sources, BUILD_DIR)
            lib = ctypes.CDLL(path)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.bgsa_myers_semiglobal.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 7 + [ptr]
            lib.bgsa_myers_semiglobal.restype = i32
            lib.bgsa_reg_words.argtypes = []
            lib.bgsa_reg_words.restype = i32
            lib.bgsa_error_string.argtypes = [i32]
            lib.bgsa_error_string.restype = ctypes.c_char_p
            _kernels = Kernels(lib, path, log, seconds, lib.bgsa_reg_words())
        return _kernels
