"""ctypes loader for the native host library (``csrc/bgsa_native.cpp``).

The port's own copy of ``bgsa_tpu.native``, same behaviour, with two
differences: it builds the port's copy of the source, which adds the
database reader's line encode (``encode_lines``) and its encode straight to
the 2-bit transport (``encode_transport``, ``list_n``); and the library is built
into the checkout's ``build/bgsa_tpu_torch/`` (gitignored), beside the CUDA
kernel libraries, named by a hash of the source and the flags, instead of a
cache under the home directory. It is built on first use (g++ -O3 -shared);
every caller has a pure-Python fallback, so a missing toolchain only costs
speed. These are the reader's encode, host packers and the result
converter, not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PACKAGE_DIR, "csrc", "bgsa_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "bgsa_tpu_torch")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _build(so_path: str) -> bool:
    # Compile to a process-private temp name, then atomically rename:
    # concurrent processes on one machine all build on first use, and a
    # peer must never CDLL a half-written .so.
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: -march=native code is built for them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> str:
    """Where the library for the current source, flags and CPU lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + _cpu_flags() + b"\0"
                                + f.read()).hexdigest()
    return os.path.join(BUILD_DIR, f"libbgsa_native-{digest[:16]}.so")


def get_lib():
    """The loaded native library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("BGSA_NO_NATIVE"):
            return None
        try:
            so_path = library_path()
            os.makedirs(BUILD_DIR, exist_ok=True)
            if not os.path.exists(so_path) and not _build(so_path):
                return None
            lib = ctypes.CDLL(so_path)
        except Exception:
            return None
        lib.bgsa_convert_result.restype = ctypes.c_int
        lib.bgsa_convert_result.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.bgsa_pack_banded.restype = None
        lib.bgsa_pack_eq.restype = None
        lib.bgsa_two_bit_pack.restype = None
        lib.bgsa_nibble_pack.restype = None
        lib.bgsa_count_n.restype = ctypes.c_int64
        lib.bgsa_encode_lines.restype = ctypes.c_int64
        lib.bgsa_encode_lines.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.bgsa_encode_transport.restype = ctypes.c_int64
        lib.bgsa_encode_transport.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.bgsa_list_n.restype = None
        lib.bgsa_list_n.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def convert_result(result_path: str, out_path: str, itemsize: int,
                   ref_bucket_count: int) -> bool:
    """Native blocked-result conversion; returns False if unavailable/failed."""
    lib = get_lib()
    if lib is None:
        return False
    rc = lib.bgsa_convert_result(
        result_path.encode(), (result_path + ".info").encode(), out_path.encode(),
        itemsize, ref_bucket_count,
    )
    return rc == 0


def pack_banded(codes: np.ndarray, k: int, query_len: int, threads: int = 1):
    """Native banded packing; returns None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    S, L = codes.shape
    n_inj = max(query_len - k, 1)
    W = -(-n_inj // 32)
    init_lo = np.empty((5, S), np.uint32)
    init_hi = np.empty((5, S), np.uint32)
    inj = np.empty((5, W, S), np.uint32)
    lib.bgsa_pack_banded(
        codes.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(S), ctypes.c_int64(L),
        ctypes.c_int32(k), ctypes.c_int32(query_len),
        init_lo.ctypes.data_as(ctypes.c_void_p), init_hi.ctypes.data_as(ctypes.c_void_p),
        inj.ctypes.data_as(ctypes.c_void_p), ctypes.c_int32(W),
        ctypes.c_int32(threads),
    )
    return init_lo, init_hi, inj


def transport_pack(codes: np.ndarray, two_bit: bool, threads: int = 1):
    """Native 2-bit / nibble transport packing; returns None if unavailable.

    ``threads`` fans the row loop out over std::threads (the reference's
    handle_reads runs under its -N-thread OpenMP region); ctypes releases
    the GIL for the call, so the pipeline's reader thread keeps running.
    """
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    S, L = codes.shape
    W = -(-L // 4) if two_bit else -(-L // 2)
    out = np.empty((S, W), np.uint8)
    fn = lib.bgsa_two_bit_pack if two_bit else lib.bgsa_nibble_pack
    fn(codes.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(S),
       ctypes.c_int64(L), out.ctypes.data_as(ctypes.c_void_p),
       ctypes.c_int32(threads))
    return out


def count_n(codes: np.ndarray):
    """Native count of N codes (> 3); returns None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    return int(lib.bgsa_count_n(codes.ctypes.data_as(ctypes.c_void_p),
                                ctypes.c_int64(codes.size)))


def pack_eq(codes: np.ndarray, word_bits: int):
    """Native Eq packing; returns None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    S, L = codes.shape
    W = -(-L // word_bits)
    eq = np.empty((5, W, S), np.uint32)
    lib.bgsa_pack_eq(
        codes.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(S), ctypes.c_int64(L),
        ctypes.c_int32(word_bits), eq.ctypes.data_as(ctypes.c_void_p), ctypes.c_int32(W),
    )
    return eq


def _line_buffer(raw: np.ndarray, rows: int, length: int, stride: int, pad_rows: int):
    """``raw`` as flat uint8, once its line geometry is checked."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    if min(rows, pad_rows) < 0 or length < 1 or stride <= length:
        raise ValueError(f"bad line geometry: rows {rows}, pad_rows {pad_rows}, "
                         f"length {length}, stride {stride}")
    if rows and raw.size < (rows - 1) * stride + length + 1:
        raise ValueError(f"{raw.size} bytes hold fewer than {rows} lines of {stride}")
    return raw


def encode_lines(raw: np.ndarray, rows: int, length: int, stride: int, pad_rows: int = 0):
    """Native encode of ``rows`` lines of ``length`` ASCII bytes, ``stride``
    bytes apart in the flat uint8 buffer ``raw``, to (rows + pad_rows,
    length) symbol codes (``pack.MAPPING``), the ``pad_rows`` last all 4
    ('N'). Returns (codes, the first row whose byte at column ``length`` is
    not a newline, or -1), or None if unavailable. One pass, run with the
    interpreter lock released."""
    lib = get_lib()
    if lib is None:
        return None
    raw = _line_buffer(raw, rows, length, stride, pad_rows)
    out = np.empty((rows + pad_rows, length), np.uint8)
    bad = lib.bgsa_encode_lines(raw.ctypes.data, rows, length, stride, out.ctypes.data, pad_rows)
    return out, bad


def encode_transport(raw: np.ndarray, rows: int, length: int, stride: int, pad_rows: int = 0,
                     threads: int = 1):
    """Native encode of the lines of ``encode_lines`` straight to the 2-bit
    transport: (packed, row_n, n_count, bad), or None if unavailable.
    ``packed`` is ``pack.two_bit_pack`` of the (rows + pad_rows, length)
    codes with 'N' read as 0 (the "2bit" payload where ``n_count`` is 0,
    the "2bitN" one's first leaf otherwise); ``row_n`` each line's 'N'
    count, for ``list_n``; ``n_count`` the 'N's, pad rows included; ``bad``
    as ``encode_lines``'s. One pass over the bytes, fanned out over
    ``threads`` threads with the interpreter lock released."""
    lib = get_lib()
    if lib is None:
        return None
    raw = _line_buffer(raw, rows, length, stride, pad_rows)
    packed = np.empty((rows + pad_rows, -(-length // 4)), np.uint8)
    row_n = np.empty(rows, np.int32)
    n_count = ctypes.c_int64(0)
    bad = lib.bgsa_encode_transport(raw.ctypes.data, rows, length, stride, packed.ctypes.data,
                                    row_n.ctypes.data, ctypes.addressof(n_count), pad_rows,
                                    threads)
    return packed, row_n, n_count.value, bad


def list_n(raw: np.ndarray, rows: int, length: int, stride: int, pad_rows: int,
           row_n: np.ndarray, size: int) -> np.ndarray:
    """The "2bitN" sidecar of the lines that ``encode_transport`` packed
    without a ragged one, from its ``row_n``: (size, 2) int32 (row, column)
    of their 'N's and the pad rows' in ``np.nonzero``'s order, then rows of
    rows + pad_rows (``pack.sidecar_pack``'s layout, one shard). Reads only
    the lines that hold an 'N'."""
    lib = get_lib()
    raw = _line_buffer(raw, rows, length, stride, pad_rows)
    row_n = np.ascontiguousarray(row_n, dtype=np.int32)
    n_count = int(row_n.sum(dtype=np.int64)) + pad_rows * length
    if row_n.shape != (rows,) or n_count > size:
        raise ValueError(f"{rows} lines with {n_count} 'N's do not fit a sidecar of {size}")
    pos = np.full((size, 2), rows + pad_rows, np.int32)
    lib.bgsa_list_n(raw.ctypes.data, rows, length, stride, row_n.ctypes.data, pad_rows,
                    pos.ctypes.data)
    return pos
