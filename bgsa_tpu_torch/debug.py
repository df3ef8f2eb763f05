"""Debug printers for the port's kernels: the counterpart of ``bgsa_tpu/debug.py``.

Host helpers format packed words for eyeballing (this module's own copies
of ``bgsa_tpu.debug``'s, same behaviour). The kernel-side printer is the
CUDA macro ``BGSA_KPRINT`` of ``csrc/debug.cuh``: a device ``printf`` from
one thread, with printf's ``%d`` where ``kprint`` takes ``{}``.

``kprint_probe`` is the fixture of ``tests/test_round2_fixes.py``'s
interpret-mode ``kprint`` test: a kernel (``csrc/kprint_probe.cu``) that
prints ``probe <x[0, 0]>`` and copies x to its output. Its plain version,
run for a CPU tensor, prints the same line from Python and returns a copy.

A device printf reaches the process's C stdout at the next synchronisation,
and on a pipe may come after lines Python printed later. Read it from a
child process::

    python -m bgsa_tpu_torch.debug [--device cpu]

runs the fixture on an (8, 128) int32 arange (the JAX test's input), checks
that the output equals it, times it (CUDA events, ``RUNS`` launches after
one warm-up) and the plain version (one call), and prints one JSON line with
the launch counts and times; every launch and the plain call each print one
``probe 0`` line. Without a GPU and without ``--device cpu`` it exits 1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from .benchutil import elapsed_ms, script_device

# Kernel launches made by ``kprint_probe`` (CUDA tensors only).
LAUNCHES = 0
# Timed kernel launches of ``main`` (GPU only).
RUNS = 20


def format_binary(word, bits: int = 32, lsb_first: bool = True) -> str:
    """One packed word as a bit string (reference print_binary, util.c:26-37).

    The reference prints MSB-first; subject positions grow LSB-first, so the
    default here puts bit 0 on the left — pass ``lsb_first=False`` for the
    reference's orientation.
    """
    w = int(np.uint64(word))
    s = "".join("1" if (w >> b) & 1 else "0" for b in range(bits))
    return s if lsb_first else s[::-1]


def format_words(words, bits: int = 32, sep: str = " | ") -> str:
    """A multi-word chain (e.g. ``eq[c, :, s]``) as joined bit strings."""
    return sep.join(format_binary(w, bits) for w in np.asarray(words).ravel())


def format_lanes(arr, max_lanes: int = 8) -> str:
    """First lanes of a (..., R, 128) tile row, one formatted word per lane
    (reference printf_mm512_i32, util.c:39-49)."""
    flat = np.asarray(arr).reshape(-1)
    shown = ", ".join(format_binary(v) for v in flat[:max_lanes])
    more = f", ... ({flat.size} lanes)" if flat.size > max_lanes else ""
    return f"[{shown}{more}]"


def kprint_probe_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: print ``probe <x[0, 0]>`` and return a copy of x."""
    print(f"probe {int(x.reshape(-1)[0])}", flush=True)
    return x.clone()


def kprint_probe(x: torch.Tensor) -> torch.Tensor:
    """(R, C) int32 -> a copy, after ``probe <x[0, 0]>`` is printed: from the
    kernel for a CUDA tensor (device printf, on C stdout at the next
    synchronisation), from Python for a CPU one."""
    global LAUNCHES
    if x.dim() != 2 or x.numel() == 0 or x.dtype != torch.int32:
        raise ValueError(f"x must be a non-empty (R, C) int32 tensor, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.device.type == "cpu":
        return kprint_probe_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kprint_probe for device {x.device}")
    from .ops import build

    kernels = build.load()
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = kernels.lib.bgsa_kprint_probe(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    kernels.check(rc, "kprint_probe")
    LAUNCHES += 1
    return out


def flush_device_prints() -> None:
    """Synchronise the current CUDA device, which moves its printf buffer to
    the C stdout buffer, and flush that to the file descriptor."""
    import ctypes

    torch.cuda.synchronize()
    ctypes.CDLL(None).fflush(None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m bgsa_tpu_torch.debug",
                                description="run the kernel-print fixture")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain version)")
    args = p.parse_args(argv)
    device = script_device(args.device)
    if device is None:
        return 1
    x = torch.arange(8 * 128, dtype=torch.int32, device=device).reshape(8, 128)
    out = kprint_probe(x)
    result = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "launches": LAUNCHES}
    if device.type == "cuda":
        flush_device_prints()
    result["out_equals_x"] = bool(torch.equal(out.cpu(), x.cpu()))
    prints = 1
    if device.type == "cuda":
        kprint_probe(x)  # warm-up
        times = [elapsed_ms(lambda: kprint_probe(x), device) for _ in range(RUNS)]
        result.update(ms=statistics.median(times), timed_launches=RUNS,
                      plain_ms=elapsed_ms(lambda: kprint_probe_ref(x), device))
        prints += 1 + RUNS + 1
        flush_device_prints()
    result["probe_lines"] = prints  # lines "probe <x[0, 0]>" this run prints
    print(json.dumps(result), flush=True)
    return 0 if result["out_equals_x"] else 1


if __name__ == "__main__":
    sys.exit(main())
