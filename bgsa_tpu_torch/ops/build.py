"""Build and load the port's CUDA kernels.

The sources under ``bgsa_tpu_torch/csrc/`` are compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``. Each
``.cu`` file is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one library. The library lands in
``build/bgsa_tpu_torch/`` at the repository root, named by a hash of the
flags and of every file in the sources' directories (headers included), so a
changed source or header rebuilds and an unchanged tree loads the cached
library.

The BitPAl kernels (``SCHEME_SOURCES``) are built apart, one library per
kernel and scoring scheme: ``load_scheme`` compiles the source with
``-DBGSA_M/-DBGSA_I/-DBGSA_G``, so the column network's shape is fixed at
compile time, into ``lib<kernel>-<digest>-M<M>_I<I>_G<G>.so`` beside the
main library, cached across runs the same way. Loaded libraries stay loaded
for the life of the process, one per (kernel, scheme) and never more: the
mode, word layout and shapes of a run are launch arguments, so they share
their scheme's library.

Importing this module builds nothing. ``load()`` and ``load_scheme()``
build on first use (the first kernel launch on a CUDA tensor, or
``compile_for`` of an engine), and a failed build raises with the nvcc
command and its stderr.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import re
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "bgsa_tpu_torch")
SOURCES = ("myers_semiglobal.cu", "myers_pallas.cu", "banded.cu", "banded_packed.cu",
           "int_peak.cu", "banded_pair.cu", "banded_packed_pair.cu", "kprint_probe.cu")
# built one library per scheme (load_scheme); each exports bgsa_<kernel>
SCHEME_SOURCES = ("bitpal.cu", "bitpal_packed.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_lock = threading.Lock()
_kernels = None
_scheme_kernels: dict = {}  # (kernel, M, I, G) -> Kernels
_scheme_locks: dict = {}


@dataclasses.dataclass
class Kernels:
    """The loaded kernel library."""

    lib: ctypes.CDLL
    path: str
    log: str  # nvcc's stderr (ptxas register and spill report), read back when cached
    build_seconds: float  # 0.0 when the cached library was loaded
    reg_words: int  # largest W whose kernel state stays in registers
    tile_columns: int = 0  # BitPAl: query columns a tile of the tiled kernel holds

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


def source_digest(sources) -> str:
    """Hash of the flags and of every file in the sources' directories, so a
    header that a source includes is part of the key."""
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for d in sorted({os.path.dirname(os.path.abspath(s)) for s in sources}):
        for name in sorted(os.listdir(d)):
            path = os.path.join(d, name)
            if os.path.isfile(path):
                digest.update(name.encode() + b"\0")
                with open(path, "rb") as f:
                    digest.update(f.read())
    return digest.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise on the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate()[1] for p in procs]
    for cmd, proc, err in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n{err}"
            )
    return "".join(outs)


def compile_library(sources, out_dir: str, *, stem: str = "bgsa_kernels", tag: str = "",
                    defines=()) -> tuple[str, str, float]:
    """Compile ``sources`` into ``out_dir``; returns (path, nvcc stderr, seconds).

    The file name is ``lib<stem>-<source_digest>[-<tag>].so``, ``tag``
    naming what the ``defines`` (``-D`` macros) select, and nvcc's stderr
    is written beside it as ``<name>.log``; an existing library with its log
    is reused (the saved stderr, 0 seconds). Raises RuntimeError on a failed
    build.
    """
    name = f"lib{stem}-{source_digest(sources)}{'-' + tag if tag else ''}.so"
    path = os.path.join(out_dir, name)
    if os.path.exists(path) and os.path.exists(path + ".log"):
        with open(path + ".log") as f:
            return path, f.read(), 0.0
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        macros = [f"-D{d}" for d in defines]
        log = _run_all([[nvcc, *COMPILE_FLAGS, *macros, "-c", "-o", obj, src]
                        for obj, src in zip(objs, sources)])
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", path + ".log")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        for f in (*objs, tmp, f"{tmp}.log"):
            if os.path.exists(f):
                os.unlink(f)
    return path, log, time.perf_counter() - t0


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# pointers..., ints..., stream
_SIGNATURES = {
    "bgsa_myers_semiglobal": [_ptr] * 4 + [_i32] * 8 + [_ptr],
    "bgsa_banded_stream": [_ptr] * 3 + [_i32] * 10 + [_ptr],
    "bgsa_banded_peq": [_ptr] * 5 + [_i32] * 9 + [_ptr],
    "bgsa_banded_packed": [_ptr] * 3 + [_i32] * 9 + [_ptr],
    "bgsa_myers_global": [_ptr] * 4 + [_i32] * 7 + [_ptr],
    "bgsa_myers_global_reg_words": [],
    "bgsa_int_peak": [_ptr] * 2 + [_i32] * 3 + [_ptr],
    "bgsa_int_peak_supports": [_i32],
    "bgsa_banded_stream_pair": [_ptr] * 3 + [_i32] * 9 + [_ptr],
    "bgsa_banded_probe": [_ptr] * 3 + [_i32] * 8 + [_ptr],
    "bgsa_banded_packed_pair": [_ptr] * 3 + [_i32] * 9 + [_ptr],
    "bgsa_banded_packed_probe": [_ptr] * 3 + [_i32] * 9 + [_ptr],
    "bgsa_kprint_probe": [_ptr] * 2 + [_i32] + [_ptr],
    "bgsa_copy_probe": [_ptr] * 2 + [_i32] + [_ptr],
    "bgsa_empty_probe": [_ptr],
}
# each scheme library's kernel: (eq, queries, out, scratch, Q, m, W, S,
# read_len, factor, semi_global, word_bits, stream)
_SCHEME_SIGNATURES = {
    "bitpal": [_ptr] * 4 + [_i32] * 8 + [_ptr],
    "bitpal_packed": [_ptr] * 4 + [_i32] * 8 + [_ptr],
}
_COMMON = {"bgsa_reg_words": [], "bgsa_error_string": [_i32]}


_FRAME = re.compile(r"Function properties for (\S+)\s+(\d+) bytes stack frame, "
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_frames(log: str) -> dict:
    """{function: (stack frame, spill store, spill load bytes)} of the
    ``-Xptxas -v`` report in a library's log."""
    return {m.group(1): tuple(int(m.group(i)) for i in (2, 3, 4)) for m in _FRAME.finditer(log)}


def _declare(lib, signatures) -> None:
    for name, argtypes in {**signatures, **_COMMON}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "bgsa_error_string" else _i32


def load() -> Kernels:
    """Build (on first use) and load the kernel library."""
    global _kernels
    with _lock:
        if _kernels is None:
            sources = [os.path.join(CSRC_DIR, s) for s in SOURCES]
            path, log, seconds = compile_library(sources, BUILD_DIR)
            lib = ctypes.CDLL(path)
            _declare(lib, _SIGNATURES)
            _kernels = Kernels(lib, path, log, seconds, lib.bgsa_reg_words())
        return _kernels


def scheme_tag(match: int, mismatch: int, gap: int) -> str:
    return f"M{match}_I{mismatch}_G{gap}"


def load_scheme(kernel: str, match: int, mismatch: int, gap: int) -> Kernels:
    """Build (on first use) and load BitPAl kernel ``kernel`` ("bitpal" or
    "bitpal_packed") for one scheme. Libraries of
    different schemes build concurrently; one scheme's builds and loads once,
    and stays loaded (the cache holds one library per kernel and scheme)."""
    if f"{kernel}.cu" not in SCHEME_SOURCES:
        raise ValueError(f"no per-scheme kernel {kernel!r}")
    key = (kernel, match, mismatch, gap)
    with _lock:
        lock = _scheme_locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _scheme_kernels:
            path, log, seconds = compile_library(
                [os.path.join(CSRC_DIR, f"{kernel}.cu")], BUILD_DIR, stem=f"bgsa_{kernel}",
                tag=scheme_tag(match, mismatch, gap),
                defines=(f"BGSA_M={match}", f"BGSA_I={mismatch}", f"BGSA_G={gap}"),
            )
            lib = ctypes.CDLL(path)
            _declare(lib, {f"bgsa_{kernel}": _SCHEME_SIGNATURES[kernel], "bgsa_tile_columns": []})
            _scheme_kernels[key] = Kernels(lib, path, log, seconds, lib.bgsa_reg_words(),
                                           lib.bgsa_tile_columns())
        return _scheme_kernels[key]


def load_all(schemes=()) -> tuple[Kernels, list[Kernels]]:
    """The main library and ``load_scheme(*spec)`` for each (kernel, M, I,
    G) in ``schemes``, every nvcc started together."""
    with concurrent.futures.ThreadPoolExecutor(len(schemes) + 1) as pool:
        main = pool.submit(load)
        libs = [pool.submit(load_scheme, *spec) for spec in schemes]
        return main.result(), [f.result() for f in libs]
