"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases; any failure exits non-zero, before the result line:

1. environment: a CUDA device, its name and power limit (nvidia-smi), and
   the kernel library built from the checkout's sources;
2. the Myers kernel against its plain torch version on the card, bit for
   bit (tolerance 0: integer scores), over subject lengths 1..1500 bp and
   the strip kernel's boundaries (1,025, 2,049, 5,000 and 10,000 bp at m
   <= 32: the plain version loops over m x W in Python; and at m = 97 and
   128, the wavefront; subjects mostly A, each with its own share of C, G
   and T, so that the carries between strips differ from pair to pair and
   column to column), ragged subject counts, both modes, factor -1 and +1,
   and N codes;
3. kernel and plain times by CUDA events, equal bit for bit, at the bench
   geometry (Q=40, m=500, S=32768, n=500, global) and at one bucket of the
   production run (Q=20, m=150, S=190,080, n=150, both modes), with the
   subjects taken through the device unpack and Eq packing; and the strip
   kernel in semi-global mode at the 5 kbp bucket (Q=20, m=1,000, S=5,632,
   n=5,000), with 256 sampled scores checked against the oracle;
4. the golden files through the port's ``run_alignment``, byte for byte;
5. production size: 20 x 150 bp queries against 1,000,000 x 150 bp subjects
   through ``bgsa_tpu_torch.cli.align_main`` (the main path; its kernel
   launches are counted), with 4,096 sampled scores checked against the
   numpy oracle, and the same in semi-global mode on a 100,000-subject
   slice; then long subjects from ``scripts/make_testdata.py``'s generator
   (seed 1): 20 x 5,000 bp queries against 20,000 x 5,000 bp subjects (four
   buckets, every launch the strip kernel's on one warp a group) and 10 x
   10,000 bp against 5,632 x 10,000 bp (two buckets of few pairs, every
   launch the wavefront's), launches counted, every score of each result
   file held to the kernel's on the whole input (many pairs: the strips on
   one warp a group), and 256 and 64 sampled scores to the oracle;
6. the four banded kernels against their plain torch versions on the card,
   bit for bit (tolerance 0), over a geometry grid that hits every route and
   edge (packed n_sub 2, 3 and 6, the stream kernel's hi word and
   band_down == 63, the dual kernel with 2k >= 32, the Peq-carry corner, a
   single-checkpoint query, and the stream kernels' window edges: q_len 32,
   64 and 96, band_down 31 and 32, the dual head ending inside a window, on
   its first column and at q_len; the Peq-carry route's longest query, 63
   vs 31 bp, and band_down 40), each on all-garbage, all-near and
   read-filter mix inputs at ragged subject counts; the device packers
   against the host ``pack.pack_banded_host``; and the Peq-carry kernel on
   random initial windows and injection words (``PEQ_WORDS``), with one
   injection word (the word index clamped) and with one past what q_len - k
   needs;
7. banded kernel and plain times by CUDA events at the JAX bench's banded
   line (Q=8, S=65,280, 150 bp, k=8, filter mix) and at one production
   bucket (Q=20, S=190,080), each of the four kernels on the same data,
   and each kernel's device time (a CUDA graph of 20 launches, replayed:
   the kernels line's ``device_ms``; its ``ms`` stays the CUDA-event time);
   at both shapes also the stream, dual and Peq-carry kernels at their
   routes' own geometries (``ROUTE_GEOMETRIES``), held to their plain
   versions and timed; then the Peq-carry kernel at one bucket of its route
   (``PEQ_BUCKET``: Q=20, 55 bp queries against 1,367,296 x 20 bp
   subjects, k=40), held to its plain version, timed and bound;
8. the banded filter at production size through ``bgsa_tpu_torch.cli``:
   ``-k 8`` with 20 x 150 bp queries against 1,000,000 x 150 bp filter-mix
   subjects (the packed kernel), ``-k 16`` on a 100,000-subject slice (the
   stream kernel), ``-k 8`` against 148 bp subjects (the dual kernel) and
   ``-k 40`` with 55 bp queries against 20 bp subjects (the Peq-carry
   kernel); each run's launches are counted, the run's kernel is held
   against its plain version on the run's whole input (tolerance 0), every
   score of the result file against the kernel's, and 4,096 sampled scores
   against ``banded_ref``.

9. the two BitPAl kernels (general integer scoring) against their plain
   torch versions on the card, bit for bit (tolerance 0), over schemes
   (2,-3,-5), (1,-1,-1), (0,-2,-3), the unpacked-only (5,-1,-2) and the
   wide (5,-4,-11) and (5,-4,-10), subject lengths 1..1100 bp (1100 bp
   takes the tiled kernel of every scheme, over two tiles of query columns;
   at 500 bp a tiled kernel is also held to the word-major plain model),
   both word layouts (31 and 32 bits) in turn global and semi-global (each
   scheme and layout in both modes over the grid) and ragged subject
   counts;
10. BitPAl kernel and plain times by CUDA events at the JAX bench's BitPAl
    line (Q=40, m=500, S=32768, n=500, (2,-3,-5), global; packed with
    31-bit words, and the non-packed kernel with 32-bit words on the same
    data: its tiled kernel), at one production bucket (Q=20, S=190,080,
    150 bp, both kernels, both modes: the register paths) and at 1,100 bp
    (S=8192: both tiled, held to each other, the plain versions taking
    minutes there);
11. the 500 bp BitPAl golden (2,-3,-5) through ``run_alignment``, packed
    and non-packed, byte for byte;
12. general scoring at production size through ``bgsa_tpu_torch.cli``:
    ``-M 2 -I -3 -G -5`` with phase 5's 20 x 150 bp queries and 1,000,000
    x 150 bp subjects (the packed kernel), then ``--no-packed``,
    ``--semi-global`` and the unpacked-only ``-M 5 -I -1 -G -2`` on the
    100,000-subject slice; each run's launches are counted, the run's
    kernel is held against its plain version on the run's whole input
    (tolerance 0), every score of the result file against the kernel's,
    and 4,096 sampled scores against ``oracle``.

13. the 31-bit reference-layout Myers kernel against its plain version
    and against the full-word kernel's global scores on the same subjects
    (tolerance 0), n = 1..1500 bp across every word boundary near 31, 62
    and 93 and the register/strip switch (992/993 bp), and phase 2's strip
    boundaries and subjects, ragged subject counts, factor -1 and +1 (one
    plain run a geometry, times the factor), N codes;
14. both Myers kernels and their plain versions timed by CUDA events on the
    same subjects at the bench geometry and at one production bucket; then
    both strip kernels (no plain run but one at the 5 kbp bucket) at
    ``MYERS_LONG``: Q=20, m=1,000 against one bucket of 5, 10, 20 and 40
    kbp subjects and the card-filling Q=40, m=500, S=32,768, 5 kbp, the two
    kernels' scores equal and 256 samples checked against the oracle at
    each (phase 2's skewed subjects, so that the scores spread; the 20 and
    40 kbp buckets take the wavefront), and the strip kernels at
    ``STRIP_ROW`` and their wavefronts at ``WAVE_ROW`` (a bucket of each
    long CLI run, fewer query columns) against their plain versions (the
    kernels line's rows);
15. the device mesh and ``--shards`` on one card: ``myers_global_sharded``
    over a (2, 2) mesh of ``cuda:0`` at the production bucket, the
    card-filling shape (the strip kernel on one warp a group) and the 40
    kbp bucket (the wavefront), merge both ways (its launches counted),
    every engine and route on two shards of
    ``cuda:0`` (2-bit and 2bit+N payloads) against one device,
    ``bgsa-torch-align --shards 0`` byte-equal to the unsharded run, and
    ``--shards`` past the visible devices refused with ``bgsa-align``'s text;
16. the int32 issue peak: its rate at 8, 16 and 32 chains and at twice the
    iterations, each chain count's kernel against its plain version at 35
    iterations (both of the kernel's loops) and the fastest run's output
    against its plain version on the same inputs (timed), and each pipe's
    rate (cuobjdump: the SASS per chain step) held to 105 % of SMs x 64 x
    ``clocks.max.sm``.

17. the paired-query kernels (the stream pair, the packed pair), the three
    stream probes and the three packed-column probes against their plain
    versions on the card, and each pair against the shipping kernel it
    pairs (tolerance 0: integer scores), over a geometry grid (several
    batches and a tail, the stream band in the high word and at band_down
    == 63, packed n_sub 2, 3, 5 and 6, a single-checkpoint query, a packed
    q_len < k corner) x garbage, near and mix inputs x ragged subject
    counts;
18. the two experiments (``bgsa_tpu_torch.scripts.exp_banded_pair`` and
    ``exp_banded_packed_pair``, ``mix`` and ``garbage``, with the packed
    probes) at their own shapes: each gate, then every variant's rate from
    chains of 24 launches timed by CUDA events, and each variant's kernel
    alone (its device time in one more chain, from the profiler: the
    kernels line's times; the path whose launches the kernels line counts);
19. the kprint fixture in a child process (``python -m
    bgsa_tpu_torch.debug``): the kernel's device printf reaches the child's
    C stdout at a synchronisation, after lines Python printed later, so the
    script reads the child's output instead of launching it: one ``probe 0``
    line a launch and the plain call, and the output equal to its input;
20. ``bgsa_tpu_torch.scripts.gpu_parity`` returns 0: every kernel family
    against the oracles at unaligned shapes, packed n_sub 5 and 6 included.

The oracle samples of phases 3, 5 and 14 run in a pool of worker
processes (the numpy oracle's O(m n) sweeps over the host's cores) that
each of those phases starts and stops for its own.

Kernel inputs are packed by ``BandedEngine.kernel_args``, as the engine
packs them for its route. Every kernel library (the main one and one per
BitPAl kernel and scheme) is built in phase 1, all nvcc processes started
together, and phase 1 fails on a spill or a stack frame in any function of
any library's ptxas report (kept beside a cached library), except the
stack frame of a kernel that calls device printf: its argument buffer.
The script imports ``bgsa_tpu_torch``, torch, numpy and the standard
library, and loads ``scripts/make_testdata.py`` by path; it fails if jax
or any ``bgsa_tpu`` module was loaded.

The second-to-last line is a JSON object describing each kernel of the
paths, with its bound: the kernel's own instructions per column (its SASS,
``roofline.column_instructions``) for the columns the timed inputs need, at
the slowest pipe's published rate at ``clocks.max.sm``, or the bytes over
3.35 TB/s, whichever is larger (for BitPAl's tiled kernel and the Myers
strip kernels, the SASS per column of the largest register instance over
its words, for every word-column: the network's cost, not the design's).
The strip kernels have rows of their own, ``myers_semiglobal strips`` (its
launches: the 5 kbp CLI run's) and ``myers_global strips`` (the mesh's at
the card-filling shape), timed at ``STRIP_ROW``, and so have their wavefronts,
``myers_semiglobal strips wave`` (the 10 kbp CLI run's) and ``myers_global
strips wave`` (the mesh's at the 40 kbp bucket), timed at ``WAVE_ROW``;
their other shapes print their bounds after the line's rows. A bound above 105 % of the
kernel's measured time fails the run: a floor cannot be slower than the
kernel. Each row also gives what its design adds, beside the bound and
never in it: ``state_bytes``, the bytes it moves through device memory
(BitPAl's planes between tiles, the strip kernels' carry words between
strips, each written and read once), and ``design_sass``, the tiled or
strip kernel's own SASS per word-column (null elsewhere); and
``device_ms``, each banded kernel's device time from a CUDA graph (null
elsewhere). The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import importlib.util
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
KERNEL_SOURCE = "bgsa_tpu_torch/csrc/myers_semiglobal.cu"
KERNEL_REPLACES = "bgsa_tpu/ops/myers_semiglobal.py:152"
N_SAMPLES = 4096
# banded kernels: name -> (source, the TPU kernel it replaces)
BANDED_KERNELS = {
    "banded_stream_packed": ("bgsa_tpu_torch/csrc/banded_packed.cu",
                             "bgsa_tpu/ops/banded_packed.py:198"),
    "banded_stream": ("bgsa_tpu_torch/csrc/banded.cu", "bgsa_tpu/ops/banded.py:332"),
    "banded_stream_dual": ("bgsa_tpu_torch/csrc/banded.cu", "bgsa_tpu/ops/banded.py:332"),
    "banded": ("bgsa_tpu_torch/csrc/banded.cu", "bgsa_tpu/ops/banded.py:175"),
}


# the paired-query experiments' kernels and the kprint fixture: name ->
# (source, the TPU kernel it replaces)
PAIR_KERNELS = {
    "banded_stream_pair": ("bgsa_tpu_torch/csrc/banded_pair.cu", "scripts/exp_banded_pair.py:40"),
    "banded_probe_full": ("bgsa_tpu_torch/csrc/banded_pair.cu", "scripts/exp_banded_pair.py:140"),
    "banded_probe_static_c": ("bgsa_tpu_torch/csrc/banded_pair.cu",
                              "scripts/exp_banded_pair.py:140"),
    "banded_probe_noload": ("bgsa_tpu_torch/csrc/banded_pair.cu",
                            "scripts/exp_banded_pair.py:140"),
    "banded_packed_pair": ("bgsa_tpu_torch/csrc/banded_packed_pair.cu",
                           "scripts/exp_banded_packed_pair.py:40"),
}
KPRINT = ("bgsa_tpu_torch/csrc/kprint_probe.cu", "tests/test_round2_fixes.py:90")
PRINTF_KERNELS = ("kprint_probe_kernel",)  # kernels allowed a stack frame: device printf
PARITY_SPECS = [("bitpal_packed", 1, -2, -3)]  # gpu_parity's 3-plane packed network


class SmokeFailure(Exception):
    pass


@dataclasses.dataclass
class Work:
    """What a timed kernel run had to do, for its bound: the library and the
    shape that pick its SASS instance (``roofline.SASS_SPECS``), the
    thread-columns the inputs need, the bytes it must move, the JAX source's
    operation count (None where none was taken), and what the design adds
    besides (reported beside the bound, never in it: a design must not move
    its own floor): the state bytes it moves through a device scratch, and
    the SASS entry of its own loop where the bound takes another instance's
    (BitPAl's tiled kernel and the Myers strip kernels are bound by their
    register network per word)."""

    library: str | None
    shape: dict
    columns: float
    nbytes: int
    jax_ops: float | None
    state_bytes: int = 0  # device scratch the design moves besides (not in the bound)
    design: str | None = None  # roofline.SASS_SPECS entry of the design's loop (not in the bound)
    bound_spec: str | None = None  # roofline.SASS_SPECS entry of the bound, if not the row's name


# the Myers kernels past their register bound (the strip kernels), timed in
# phases 3 and 14: (label, Q, m, n, S; None: the subject count
# io.seqfile.DatabaseReader cuts from one BUCKET_SIZE bucket): Q=20, m=1,000
# against a bucket of 5, 10, 20 and 40 kbp subjects, and the card-filling
# shape (its Eq, 103 MB, beyond L2)
MYERS_LONG = (("5 kbp bucket", 20, 1000, 5000, None), ("10 kbp bucket", 20, 1000, 10000, None),
              ("20 kbp bucket", 20, 1000, 20000, None), ("40 kbp bucket", 20, 1000, 40000, None),
              ("card-filling", 40, 500, 5000, 32768))
# (n, m, Q, S) at the strip boundaries (the plain versions loop over m x W
# in Python): 1,025 and 2,049 bp end in a strip of one to three words,
# 5,000 and 10,000 bp run five or six and ten or eleven strips (full words
# or 31-bit). m <= 32 runs a group's strips on one warp; on so few pairs,
# four batches of columns (m = 97, 128) run them as the wavefront over four
# warps, with two strips (two warps idle) and five or six. The subjects are
# skewed_subjects', so that the carries between strips differ
STRIP_GRID = [(1025, 32, 2, 129), (2049, 32, 2, 77), (5000, 20, 2, 65), (10000, 12, 2, 33),
              (1025, 97, 2, 77), (5000, 128, 2, 65)]
ORACLE_LONG = 256  # oracle samples at each long shape and of the 5 kbp CLI run
# the long-subject CLI runs of phase 5 (queries, query bp, subjects, subject
# bp, oracle samples): four 5 kbp buckets (the strip kernel on one warp a
# group) and, few pairs, two 10 kbp buckets of ten queries (the wavefront),
# both with queries as long as the subjects, so that the scores spread (a
# 10 kbp sweep of the numpy oracle takes seconds: fewer samples)
LONG_CLI = ((20, 5000, 20_000, 5000, ORACLE_LONG), (10, 10_000, 5632, 10_000, 64))
# the kernels line's shapes (Q, m, n, S), where the plain versions run in
# seconds (phase 14 times the kernels at every MYERS_LONG shape too): the
# pairs of a bucket of each long-subject CLI run, with two and four batches
# of columns: the strip kernels (one warp a group) and their wavefronts
STRIP_ROW = (20, 64, 5000, None)
WAVE_ROW = (10, 97, 10_000, None)


START = time.perf_counter()


def phase(header: str) -> None:
    """Print a phase's header after the seconds since the script started."""
    print(f"[{time.perf_counter() - START:.0f} s] {header}")


def main_library() -> str:
    from bgsa_tpu_torch.ops import build

    return build.load().path


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bucket_subjects(n: int) -> int:
    """Subjects of n bp in one BUCKET_SIZE bucket, as the reader cuts it."""
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE

    return BUCKET_SIZE // (n + 1) // 128 * 128


def skewed_subjects(rng, S, n, n_rate=0.0):
    """(S, n) int8 codes, A but for a share of C, G and T of each subject's
    own, log-uniform from 0.0003 to 0.75 (ACGT uniform). A uniform query of
    m << n bp is a subsequence of a uniform subject's first strip, so that
    every later strip sees the same carries (hp 0, hn 1) at every column;
    against these subjects the carries between strips differ from pair to
    pair and column to column, and the scores spread above n - m.
    ``n_rate``: a share of N (code 4)."""
    miss = np.exp(rng.uniform(np.log(3e-4), np.log(0.75), size=(S, 1))).astype(np.float32)
    codes = np.where(rng.random((S, n), dtype=np.float32) < miss,
                     rng.integers(1, 4, size=(S, n), dtype=np.int8), np.int8(0))
    if n_rate:
        codes[rng.random((S, n), dtype=np.float32) < n_rate] = 4
    return codes


class OracleSamples:
    """Sampled scores held against ``oracle`` in worker processes, its
    O(m n) sweeps spread over the host's cores. A context for one phase:
    entered, it starts the pool; ``submit`` draws ``samples`` (query,
    subject) pairs of a (Q, S) score array and queues oracle calls of a few
    subjects each; leaving, it checks every call and stops the pool, so no
    sweep runs beside another phase's work."""

    def __enter__(self):
        self.pool = concurrent.futures.ProcessPoolExecutor(
            os.cpu_count() or 1, mp_context=multiprocessing.get_context("spawn"))
        self.jobs = []
        return self

    def submit(self, label, rng, queries, subjects, scores, mode, factor=-1,
               samples=ORACLE_LONG):
        from bgsa_tpu_torch import oracle

        q_idx = rng.integers(0, len(queries), samples)
        s_idx = rng.integers(0, len(subjects), samples)
        chunk = max(1, 65536 // subjects.shape[1])  # a sweep's rows stay in cache
        for qi in np.unique(q_idx):
            sel = s_idx[q_idx == qi]
            for i in range(0, len(sel), chunk):
                part = sel[i:i + chunk]
                future = self.pool.submit(oracle.edit_distances, np.asarray(queries[qi]),
                                          np.asarray(subjects[part]), mode)
                self.jobs.append((label, future, factor, scores[qi, part]))

    def __exit__(self, *exc):
        try:
            if exc[0] is None:
                done = {}
                for label, future, factor, got in self.jobs:
                    bad = int(np.count_nonzero(got != factor * future.result()))
                    check(bad == 0, f"{label}: {bad} sampled scores differ from the oracle")
                    done[label] = done.get(label, 0) + got.size
                for label, count in done.items():
                    print(f"  {label}: {count} sampled scores equal the oracle (worker "
                          "processes)")
        finally:
            self.pool.shutdown(cancel_futures=True)
        return False


def random_codes(rng, shape, n_rate=0.0):
    """ACGT codes, with a share ``n_rate`` of N (code 4)."""
    codes = rng.integers(0, 4, size=shape).astype(np.int32)
    codes[rng.random(shape) < n_rate] = 4
    return codes


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    phase(f"== phase 1: environment")
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    from bgsa_tpu_torch.ops import build

    t0 = time.perf_counter()
    specs = bitpal_specs() + PARITY_SPECS
    kernels, scheme_libs = build.load_all(specs)
    print(f"kernel library built from bgsa_tpu_torch/csrc/{{{','.join(build.SOURCES)}}}: "
          f"nvcc {kernels.build_seconds:.2f} s (one process per source, in parallel), "
          f"-> {os.path.relpath(kernels.path, REPO)}")
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    check(build.ptxas_frames(kernels.log), "no ptxas report for the main library")
    faults = frame_faults("main library", kernels)
    print("BitPAl libraries, one per kernel and scheme (built beside it, in parallel):")
    for (name, *scheme), lib in zip(specs, scheme_libs):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", lib.log)]
        spilled = sum(sum(f) for f in build.ptxas_frames(lib.log).values())
        print(f"  {name:13s} {tuple(scheme)}: nvcc {lib.build_seconds:.2f} s, "
              f"{len(regs)} kernels, ptxas registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"stack+spill bytes {spilled}, state in registers up to W={lib.reg_words}")
        faults += frame_faults(f"{name} {tuple(scheme)}", lib)
    for fault in faults:
        print("  ptxas:", fault)
    check(not faults, f"ptxas reports a stack frame or spills in {len(faults)} function(s)")
    print(f"no spill in any library, and no stack frame but the printing kernel's "
          f"(device printf's argument buffer); all built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    return smi


def frame_faults(label, lib):
    """One line for each function of a library's ptxas report with spill
    stores or loads, or a stack frame outside a kernel that calls device
    printf (its arguments' buffer is a stack frame)."""
    from bgsa_tpu_torch.ops import build

    faults = []
    for fn, (stack, stores, loads) in build.ptxas_frames(lib.log).items():
        if stores or loads or (stack and not any(k in fn for k in PRINTF_KERNELS)):
            faults.append(f"{label} {fn}: {stack} bytes stack frame, {stores} bytes spill "
                          f"stores, {loads} bytes spill loads")
    return faults


def compare(eq, queries, *, read_len, factor, is_global):
    """Kernel vs plain version on the same CUDA tensors -> (max |diff|, kernel out)."""
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    got = ms.myers_semiglobal(eq, queries, read_len=read_len, factor=factor, is_global=is_global)
    torch.cuda.synchronize()
    want = ms.myers_semiglobal_ref(eq, queries, read_len=read_len, factor=factor,
                                   is_global=is_global)
    check(got.shape == want.shape and got.dtype == want.dtype, "kernel output shape/dtype")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0, got


def myers_path(W, reg_words, Q, S, m):
    """Which instance a Myers launch takes: registers, strips (one warp a
    group of 32 subjects) or the strips' wavefront."""
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    if W <= reg_words:
        return "registers"
    return "wavefront" if ms.strip_wave(Q, S, m, roofline.sm_count(CARD)) else "strips"


def phase_kernel_vs_plain(rng):
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.ops import build
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    phase(f"== phase 2: kernel vs plain torch version on the card (tolerance 0)")
    launches0 = ms.LAUNCHES
    modes = [(True, -1), (False, 1), (True, 1), (False, -1)]
    # (n, m, Q, S): subject length, query length, queries, subjects
    geometries = [(n, 150, 3, 1000) for n in (1, 31, 32, 33, 150, 500, 960, 1500)]
    geometries += [(150, 1100, 2, 777), (33, 1, 3, 129), (500, 60, 1, 1)] + STRIP_GRID
    reg_words = build.load().reg_words
    max_err = 0
    for gi, (n, m, Q, S) in enumerate(geometries):
        queries = random_codes(rng, (Q, m), n_rate=0.03)
        if (n, m, Q, S) in STRIP_GRID:
            subjects = skewed_subjects(rng, S, n, n_rate=0.03).astype(np.int32)
        else:
            subjects = random_codes(rng, (S, n), n_rate=0.03)
        if n == m:  # all-ones carries: a subject equal to a query, one of one base
            subjects[0] = queries[0]
            subjects[1] = 0
        codes = torch.from_numpy(subjects).cuda()
        eq = pack.pack_eq(codes, 32)
        qt = torch.from_numpy(queries).cuda()
        for is_global, factor in (modes[gi % 4], modes[(gi + 1) % 4]):
            err, _ = compare(eq, qt, read_len=n, factor=factor, is_global=is_global)
            W = eq.shape[1]
            print(f"  n={n:5d} m={m:5d} Q={Q} S={S:5d} W={W:3d} "
                  f"({myers_path(W, reg_words, Q, S, m)}) "
                  f"{'global' if is_global else 'semi  '} factor={factor:+d}: max |diff| {err}")
            check(err == 0, f"kernel != plain at n={n} m={m} S={S} global={is_global}")
            max_err = max(max_err, err)
    check(ms.LAUNCHES > launches0, "LAUNCHES did not grow in phase 2")
    print(f"  kernel launches in phase 2: {ms.LAUNCHES - launches0}")
    return max_err


def cuda_times_ms(fn, runs: int, warmup: int):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def time_kernel_and_plain(eq, qt, *, read_len, is_global, smi):
    """Kernel vs plain on one geometry: equal bit for bit, then median CUDA-event
    times (kernel 20 runs after 3 warm-ups, plain 3 after 1) -> (err, ms, plain ms)."""
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    kw = dict(read_len=read_len, factor=-1, is_global=is_global)
    err, _ = compare(eq, qt, **kw)
    check(err == 0, f"kernel != plain at {tuple(qt.shape)} x {tuple(eq.shape)}")
    kernel_ms = statistics.median(
        cuda_times_ms(lambda: ms.myers_semiglobal(eq, qt, **kw), runs=20, warmup=3))
    plain_ms = statistics.median(
        cuda_times_ms(lambda: ms.myers_semiglobal_ref(eq, qt, **kw), runs=3, warmup=1))
    (Q, m), S = qt.shape, eq.shape[2]
    cells = Q * m * S * read_len
    print(f"  Q={Q} m={m} S={S} n={read_len} {'global' if is_global else 'semi-global'}: "
          f"kernel median {kernel_ms:.4f} ms over 20 runs = {cells / kernel_ms / 1e6:.1f} GCUPS; "
          f"plain torch median {plain_ms:.1f} ms over 3 runs = {cells / plain_ms / 1e6:.1f} GCUPS; "
          f"max |diff| {err} ({smi})")
    return err, kernel_ms, plain_ms


def device_eq(rng, S, n, word_bits=32):
    """Subjects through the main path's device stages (host transport packing,
    device unpack and Eq packing), checked against the host packers (pack_eq_host)."""
    from bgsa_tpu_torch import pack as host_pack
    from bgsa_tpu_torch import pack

    subjects = random_codes(rng, (S, n))
    transport, payload = host_pack.select_transport(subjects)
    codes = pack.transport_unpack(transport)(torch.from_numpy(payload).cuda(), n)
    check(torch.equal(codes.cpu(), torch.from_numpy(subjects)), "device transport unpack")
    eq = pack.pack_eq(codes, word_bits)
    check(torch.equal(eq.cpu(), pack.eq_from_numpy(host_pack.pack_eq_host(subjects, word_bits))),
          "device pack_eq != pack_eq_host")
    return eq


def strip_work(name, eq, qt, n, wave=False):
    """Work of a Myers strip-kernel run (``wave``: the wavefront's): bound by
    the register network's cost (the <reg_words> register instance's SASS
    per column over its words, for every word-column), its own loop's SASS
    per word-column and the carry words its strips write and read back
    reported beside it."""
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.ops import build
    from bgsa_tpu_torch.ops.myers_semiglobal import carry_words

    (Q, m), (_, W, S) = qt.shape, eq.shape
    reg_words = build.load().reg_words
    planes = 2 if name == "myers_semiglobal" else 3
    return Work(main_library(), {"W": reg_words}, Q * m * S * W / reg_words,
                roofline.io_bytes(eq, qt) + 4 * Q * S, roofline.word_kernel_ops(name, Q, m, S, n),
                state_bytes=2 * (-(-W // reg_words) - 1) * planes * carry_words(m) * Q * S * 4,
                design=f"{name}_{'wave' if wave else 'strips'}", bound_spec=name)


def phase_bench(rng, smi, long_lines):
    from bgsa_tpu_torch import pack, roofline
    from bgsa_tpu_torch.ops import myers_semiglobal as ms
    from bgsa_tpu_torch.schemes import Mode

    phase(f"== phase 3: kernel and plain times ({smi})")
    Q, m, S, n = 40, 500, 32768, 500  # the JAX bench's Myers line
    eq = device_eq(rng, S, n)
    qt = torch.from_numpy(random_codes(rng, (Q, m))).cuda()
    print("  bench geometry (device unpack and pack_eq equal the host packers):")
    bench = time_kernel_and_plain(eq, qt, read_len=n, is_global=True, smi=smi)
    work = Work(main_library(), {"W": eq.shape[1]}, Q * m * S,
                roofline.io_bytes(eq, qt) + 4 * Q * S,
                roofline.word_kernel_ops("myers_semiglobal", Q, m, S, n))

    # one full bucket of the production run: 150 bp lines, default bucket size
    n = m = 150
    S = bucket_subjects(n)
    eq = device_eq(rng, S, n)
    qt = torch.from_numpy(random_codes(rng, (20, m))).cuda()
    print("  the production run's bucket shape:")
    errs = [time_kernel_and_plain(eq, qt, read_len=n, is_global=g, smi=smi)[0]
            for g in (True, False)]

    # the strip kernel in semi-global mode at the 5 kbp bucket (phase 14
    # times both kernels' global mode at every long shape)
    label, Q, m, n, S = MYERS_LONG[0]
    S = S or bucket_subjects(n)
    subjects, queries = skewed_subjects(rng, S, n), random_codes(rng, (Q, m))
    eq = pack.pack_eq(torch.from_numpy(subjects).cuda(), 32)
    qt = torch.from_numpy(queries).cuda()
    kw = dict(read_len=n, is_global=False)
    before = ms.STRIP_LAUNCHES
    got = ms.myers_semiglobal(eq, qt, **kw).cpu().numpy()
    check(ms.STRIP_LAUNCHES == before + 1, "myers_semiglobal did not run its strip kernel")
    with OracleSamples() as oracles:
        oracles.submit(f"myers_semiglobal, {label}, semi-global", rng, queries, subjects, got,
                       Mode.SEMI_GLOBAL)
    t = cuda_times_ms(lambda: ms.myers_semiglobal(eq, qt, **kw), runs=5, warmup=1)
    kernel_ms = statistics.median(t)
    long_lines[f"myers_semiglobal strips, {label}, semi-global"] = (
        "myers_semiglobal strips", kernel_ms, strip_work("myers_semiglobal", eq, qt, n))
    print(f"  the strip kernel at the {label}, semi-global: Q={Q} m={m} S={S} n={n} "
          f"W={eq.shape[1]}: kernel median {kernel_ms:.4f} ms of 5 ({min(t):.4f}-{max(t):.4f}) "
          f"= {Q * m * S * n / kernel_ms / 1e6:.1f} GCUPS ({smi})")
    return max(bench[0], *errs), bench[1], bench[2], work


def phase_goldens(tmp):
    from bgsa_tpu_torch.io import result as result_io
    from bgsa_tpu_torch.pipeline import PipelineConfig
    from bgsa_tpu_torch.pipeline import run_alignment

    phase(f"== phase 4: golden files through bgsa_tpu_torch.pipeline.run_alignment")
    cases = [
        (os.path.join(REPO, "sample-data", "query.txt"),
         os.path.join(REPO, "sample-data", "subject.txt"),
         PipelineConfig(), "sample_myers_global.txt"),
        (os.path.join(GOLDEN, "multibucket_query.txt"),
         os.path.join(GOLDEN, "multibucket_subject.txt"),
         PipelineConfig(bucket_size=40000), "multibucket_scores.txt"),
    ]
    for qp, sp, cfg, golden in cases:
        res = os.path.join(tmp, "golden.bin")
        conv = os.path.join(tmp, "golden.txt")
        run_alignment(qp, sp, res, config=cfg, device="cuda")
        result_io.convert_result(res, conv)
        with open(conv, "rb") as f, open(os.path.join(GOLDEN, golden), "rb") as g:
            check(f.read() == g.read(), f"{golden}: converted result differs")
        print(f"  {golden}: byte-equal")


def load_make_testdata():
    spec = importlib.util.spec_from_file_location(
        "make_testdata", os.path.join(REPO, "scripts", "make_testdata.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def result_scores(result_path, n_queries, n_subjects, dtype):
    """(Q, S) scores of a one-device result file with one query bucket
    (n_queries <= 100), read back through its ``.info`` bucket layout. The
    last bucket's pad records (subject counts round up to 128) are cut."""
    from bgsa_tpu_torch.io import result as result_io

    info = result_io.read_info(result_path + ".info")
    check(info.device_num == 1 and info.ref_count == n_queries <= 100, "result layout")
    data = np.fromfile(result_path, dtype=dtype)
    out, offset = [], 0
    for (count, *_) in info.device_read_counts:
        out.append(data[offset:offset + n_queries * count].reshape(n_queries, count))
        offset += n_queries * count
    check(offset == data.size, "result file size")
    scores = np.concatenate(out, axis=1)
    check(n_subjects <= scores.shape[1] < n_subjects + 128, "result subject count")
    return scores[:, :n_subjects]


def check_against_oracle(rng, qp, sp, res, mode, n_subjects):
    from bgsa_tpu_torch import oracle
    from bgsa_tpu_torch.io import seqfile
    from bgsa_tpu_torch.pack import encode_ascii

    queries = seqfile.read_queries(qp)
    q_idx = rng.integers(0, len(queries), N_SAMPLES)
    s_idx = rng.integers(0, n_subjects, N_SAMPLES)
    got = result_scores(res, len(queries), n_subjects, np.int16)[q_idx, s_idx]
    length = queries.shape[1]
    lines = np.memmap(sp, dtype=np.uint8, mode="r").reshape(-1, length + 1)
    want = np.empty(N_SAMPLES, np.int64)
    for qi in np.unique(q_idx):
        sel = np.nonzero(q_idx == qi)[0]
        subjects = encode_ascii(np.asarray(lines[s_idx[sel], :length]))
        want[sel] = -oracle.edit_distances(queries[qi], subjects, mode)
    bad = int(np.count_nonzero(got != want))
    check(bad == 0, f"{bad} of {N_SAMPLES} sampled scores differ from the oracle ({mode.value})")
    print(f"  {N_SAMPLES} sampled (query, subject) scores equal oracle ({mode.value})")


def print_stats(stats_path):
    with open(stats_path) as f:
        st = json.load(f)
    print(f"  RunStats: subjects {st['subject_count']}, read {st['read_time']:.3f} s, "
          f"pack {st['pack_time']:.3f} s, cal {st['cal_time']:.3f} s, "
          f"write {st['write_time']:.3f} s, compile {st['compile_time']:.3f} s, "
          f"total {st['total_time']:.3f} s, cal GCUPS {st['cal_gcups']:.1f}, "
          f"total GCUPS {st['total_gcups']:.1f}")
    return st


def long_cli_run(rng, tmp, make_testdata, n_q, m, n_s, n, samples, wave):
    """``bgsa-torch-align`` over n_q x m bp queries and n_s x n bp subjects
    from ``scripts/make_testdata.py``'s generator (seed 1): every launch the
    strip kernel's (``wave``: the wavefront's), counted; every score of the
    result file held to the kernel's on the whole input (for the wavefront's
    run, many pairs: the strips on one warp a group), and ``samples`` of
    them to the oracle. Returns the launches."""
    from bgsa_tpu_torch import cli, pack
    from bgsa_tpu_torch.io import seqfile
    from bgsa_tpu_torch.ops import myers_semiglobal as ms
    from bgsa_tpu_torch.pack import encode_ascii
    from bgsa_tpu_torch.schemes import Mode

    schedule = "the wavefront" if wave else "one warp a group"
    print(f"  long subjects: {n_q} x {m} bp queries vs {n_s} x {n} bp subjects "
          f"({-(-n_s // bucket_subjects(n))} buckets; the strip kernel, {schedule})")
    qp, sp = os.path.join(tmp, f"query{n_q}_{m}bp.txt"), os.path.join(tmp, f"subj{n_s}_{n}bp.txt")
    data_rng = np.random.default_rng(1)
    make_testdata.write_lines(qp, n_q, m, data_rng)
    make_testdata.write_lines(sp, n_s, n, data_rng)
    res, stats_path = os.path.join(tmp, "r_long.bin"), os.path.join(tmp, "stats_long.json")
    ms.LAUNCHES = ms.STRIP_LAUNCHES = ms.WAVE_LAUNCHES = 0
    rc = cli.align_main(["-q", qp, "-d", sp, "-f", res, "--stats-json", stats_path, "--quiet"])
    launches = ms.WAVE_LAUNCHES if wave else ms.STRIP_LAUNCHES
    check(rc == 0, f"bgsa-torch-align exited {rc} on long subjects")
    check(launches > 0 and launches == ms.LAUNCHES,
          f"{launches} of {ms.LAUNCHES} launches ran the strip kernel ({schedule})")
    print(f"  global: exit 0, myers_semiglobal kernel launches {launches}, all of them the "
          f"strip kernel's ({schedule})")
    print_stats(stats_path)
    queries = seqfile.read_queries(qp)
    subjects = encode_ascii(np.fromfile(sp, np.uint8).reshape(n_s, n + 1)[:, :n])
    scores = result_scores(res, n_q, n_s, np.int16)
    before = ms.STRIP_LAUNCHES
    kernel = ms.myers_semiglobal(pack.pack_eq(torch.from_numpy(subjects).cuda(), 32),
                                 torch.from_numpy(queries).cuda(), read_len=n,
                                 is_global=True).cpu().numpy()
    check(ms.STRIP_LAUNCHES == before + 1,
          "the whole input did not run the strip kernel on one warp a group")
    check(np.array_equal(scores, kernel), "a long-subject result file != the kernel's scores")
    print(f"  every score of the result file equals the kernel's on the whole input "
          f"({n_q} x {n_s}: one warp a group); {len(np.unique(scores))} distinct scores, "
          f"{scores.min()} to {scores.max()}")
    with OracleSamples() as oracles:
        oracles.submit(f"bgsa-torch-align, {n_q} x {m} bp vs {n_s} x {n} bp", rng, queries,
                       subjects, scores, Mode.GLOBAL, samples=samples)
    return launches


def phase_production(rng, tmp, smi):
    from bgsa_tpu_torch import cli
    from bgsa_tpu_torch.ops import myers_semiglobal as ms
    from bgsa_tpu_torch.schemes import Mode

    n_queries, n_subjects, length, n_semi = 20, 1_000_000, 150, 100_000
    phase(f"== phase 5: production size, {n_queries} x {length} bp queries vs "
          f"{n_subjects} x {length} bp subjects through bgsa_tpu_torch.cli ({smi})")
    make_testdata = load_make_testdata()
    data_rng = np.random.default_rng(1)  # scripts/make_testdata.py's seed and order
    qp = os.path.join(tmp, f"query{n_queries}_{length}bp.txt")
    sp = os.path.join(tmp, f"subj{n_subjects}_{length}bp.txt")
    t0 = time.perf_counter()
    make_testdata.write_lines(qp, n_queries, length, data_rng)
    make_testdata.write_lines(sp, n_subjects, length, data_rng)
    print(f"  generated inputs in {time.perf_counter() - t0:.2f} s")

    res, stats_path = os.path.join(tmp, "r.bin"), os.path.join(tmp, "stats.json")
    ms.LAUNCHES = 0
    rc = cli.align_main(["-q", qp, "-d", sp, "-f", res, "--stats-json", stats_path, "--quiet"])
    launches = ms.LAUNCHES
    check(rc == 0, f"bgsa-torch-align exited {rc}")
    check(launches > 0, "the main path launched no kernel")
    print(f"  global: bgsa-torch-align exit 0, myers_semiglobal kernel launches {launches}")
    st = print_stats(stats_path)
    check(st["subject_count"] == n_subjects, "subject count")
    check_against_oracle(rng, qp, sp, res, Mode.GLOBAL, n_subjects)

    sp_semi = os.path.join(tmp, f"subj{n_semi}_{length}bp.txt")
    with open(sp, "rb") as f, open(sp_semi, "wb") as g:
        g.write(f.read(n_semi * (length + 1)))
    res_semi = os.path.join(tmp, "r_semi.bin")
    rc = cli.align_main(["-q", qp, "-d", sp_semi, "-f", res_semi, "--semi-global",
                         "--stats-json", stats_path, "--quiet"])
    check(rc == 0, f"bgsa-torch-align --semi-global exited {rc}")
    print(f"  semi-global on the first {n_semi} subjects: exit 0")
    print_stats(stats_path)
    check_against_oracle(rng, qp, sp_semi, res_semi, Mode.SEMI_GLOBAL, n_semi)

    # long subjects: every bucket past the register bound
    long_launches = [long_cli_run(rng, tmp, make_testdata, *shape, wave)
                     for shape, wave in zip(LONG_CLI, (False, True))]
    return (launches, *long_launches), (qp, sp, sp_semi)


# -- the banded filter (-k) --------------------------------------------------

BANDED_GRID = [  # (q_len, s_len, k): every route and edge
    (150, 158, 8),   # packed, n_sub = 2
    (150, 150, 8),   # packed, n_sub = 3 (the headline geometry)
    (100, 100, 4),   # packed, n_sub = 6
    (40, 44, 4),     # packed, a short query with a single checkpoint
    (100, 100, 3),   # packed, n_sub = 8 (the generic instance)
    (7, 7, 1),       # packed, n_sub = 16: slots past 48 KB of shared memory
    (150, 150, 16),  # stream, band in the hi word
    (150, 181, 16),  # stream, band_down == 63
    (32, 47, 8),     # stream, band_down 31 (the narrow instance), one window
    (64, 72, 16),    # stream, the wide instance ending on a window's last column
    (96, 96, 16),    # stream, band_down 32, three windows
    (100, 95, 20),   # dual, 2k >= 32 and band_down >= 32: the head ends inside window 1
    (150, 148, 8),   # dual
    (41, 30, 20),    # dual, the head (t <= 2k) crosses a window and ends at q_len
    (32, 28, 20),    # dual, every column in the head
    (64, 60, 12),    # dual, narrow, two windows
    (96, 95, 16),    # dual, the head ends on window 1's first column
    (50, 20, 40),    # Peq-carry
    (55, 20, 40),    # Peq-carry (the -k 40 CLI run's)
    (63, 31, 32),    # Peq-carry, the route's longest query, band_down 32
    (40, 10, 35),    # Peq-carry, band_down 40
]
BANDED_KINDS = ("garbage", "near", "mix")
RAGGED_S = (1, 129, 1000)
# timed shapes (label, Q, S) at 150 bp, k=8: the JAX bench's banded line and
# one bucket of the production run (BUCKET_SIZE // 151, in 128s)
BANDED_TIMED = (("bench line (bench.py:278-284)", 8, 65280),
                ("one production bucket", 20, 190080))
# device time: launches a CUDA graph, replays timed
GRAPH_LAUNCHES, GRAPH_REPLAYS = 20, 5
# the stream, dual and Peq-carry kernels' own geometries (q_len, s_len, k),
# timed at both BANDED_TIMED shapes: stream at band_down 32 and 63, dual at
# 148 bp (the 148 bp CLI run's) and 95 bp subjects (2k >= 32), Peq-carry at
# the -k 40 CLI run's 55 vs 20 bp and the route's longest query, 63 vs 31 bp
ROUTE_GEOMETRIES = {"banded_stream": [(150, 150, 16), (150, 181, 16)],
                    "banded_stream_dual": [(150, 148, 8), (100, 95, 20)],
                    "banded": [(55, 20, 40), (63, 31, 32)]}
# one bucket of the Peq-carry route (Q, q_len, s_len, k): 55 bp queries
# against as many 20 bp subjects as the reader cuts from one BUCKET_SIZE
# bucket (1,367,296)
PEQ_BUCKET = (20, 55, 20, 40)
# the Peq-carry kernel on random initial windows and injection words, at
# each (q_len, s_len, k) with one injection word (where q_len - k needs
# more, the word index clamped at W - 1) and with one more than it needs
PEQ_WORDS = [(55, 20, 40), (63, 31, 32), (40, 10, 35), (150, 150, 8)]
# production runs: subjects of the -k 8 run, of the -k 16 and dual slices,
# and of the Peq-carry run
BANDED_SUBJECTS, BANDED_SLICE, PEQ_SUBJECTS = 1_000_000, 100_000, 10_000


def substituted(rng, base, count, length, edits):
    """count copies of base[:length], each with up to ``edits`` random
    substitutions."""
    out = np.repeat(base[None, :length], count, axis=0)
    for row in out:
        e = rng.integers(0, edits + 1)
        row[rng.integers(0, length, size=e)] = rng.integers(0, 4, size=e)
    return out


def banded_inputs(rng, Q, m, S, n, k, kind):
    """(queries, subjects) codes: all-garbage subjects (every lane exits),
    all-near subjects (queries and subjects within k/4 substitutions of one
    base sequence: where s_len <= q_len no pair exits), or the read-filter mix
    (benchutil.filter_mix_dataset, 30 % near)."""
    from bgsa_tpu_torch.benchutil import filter_mix_dataset

    if kind == "mix":
        q, s = filter_mix_dataset(rng, Q, S, max(m, n, 6))
        return q[:, :m].astype(np.int32), s[:, :n].astype(np.int32)
    if kind == "near":
        base = random_codes(rng, (max(m, n),))
        return substituted(rng, base, Q, m, k // 4), substituted(rng, base, S, n, k // 4)
    return random_codes(rng, (Q, m)), random_codes(rng, (S, n))


def banded_launches():
    from bgsa_tpu_torch.ops import banded as bo
    from bgsa_tpu_torch.ops import banded_packed as bp

    return {"banded_stream_packed": bp.LAUNCHES, **bo.LAUNCHES}


def reset_banded_launches():
    from bgsa_tpu_torch.ops import banded as bo
    from bgsa_tpu_torch.ops import banded_packed as bp

    bp.LAUNCHES = 0
    for name in bo.LAUNCHES:
        bo.LAUNCHES[name] = 0


def banded_compare(name, args, qt, m, n, k):
    """Kernel vs plain version on the same CUDA tensors -> (max |diff|, kernel out)."""
    from bgsa_tpu_torch.banded_pipeline import KERNELS

    kernel, plain = KERNELS[name]
    kw = dict(q_len=m, s_len=n, k=k)
    before = banded_launches()[name]
    got = kernel(*args, qt, **kw)
    torch.cuda.synchronize()
    check(banded_launches()[name] == before + 1, f"{name} did not launch its kernel")
    want = plain(*args, qt, **kw)
    check(got.shape == want.shape and got.dtype == want.dtype == torch.int32,
          f"{name} output shape/dtype")
    return int((got.long() - want.long()).abs().max()), got


def phase_banded_kernels(rng):
    from bgsa_tpu_torch import pack as host_pack
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.banded_pipeline import KERNELS, BandedEngine

    phase(f"== phase 6: banded kernels vs plain torch versions on the card (tolerance 0)")
    max_err = dict.fromkeys(BANDED_KERNELS, 0)
    for m, n, k in BANDED_GRID:
        engine = BandedEngine(k, device="cuda")
        route = engine.route(m, n)
        also, line = [], []
        for kind in BANDED_KINDS:
            for S in RAGGED_S:
                q, s = banded_inputs(rng, 3, m, S, n, k, kind)
                codes, qt = torch.from_numpy(s).cuda(), torch.from_numpy(q).cuda()
                last = kind == "mix" and S == RAGGED_S[-1]
                if last:
                    lo, hi, inj = pack.pack_banded(codes, k, m)
                    for got, want in zip((lo, hi, inj), host_pack.pack_banded_host(s, k, m)):
                        check(torch.equal(got.cpu(), pack.eq_from_numpy(want)),
                              f"device pack_banded != pack_banded_host at {(m, n, k)}")
                # the route's kernel on every input; on the mix at S=1000 also
                # every other kernel that takes the geometry
                for name in [route] + [x for x in KERNELS if x != route] if last else [route]:
                    try:
                        args = engine.kernel_args(name, codes, m)
                        err, got = banded_compare(name, args, qt, m, n, k)
                    except ValueError:  # this kernel does not take the geometry
                        check(name != route, f"the route {name} refused {(m, n, k)}")
                        continue
                    check(err == 0, f"{name} kernel != plain at {(m, n, k)} {kind} S={S}")
                    max_err[name] = max(max_err[name], err)
                    if name == route and S == RAGGED_S[-1]:
                        line.append(f"{kind} {float((got == 127).float().mean()):.2f}")
                    elif name != route:
                        also.append(name)
        print(f"  q={m:3d} s={n:3d} k={k:2d}: route {route}, also {', '.join(also) or '-'}; "
              f"share over budget: {', '.join(line)}; max |diff| 0")
    print("  device pack_banded equals pack_banded_host on every geometry")
    for m, n, k in PEQ_WORDS:  # random bits above band_down and past q_len - k
        for W in (1, max(1, -(-(m - k) // 32)) + 1):
            lo, hi, inj = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=shape,
                                                         dtype=np.int64).astype(np.int32)).cuda()
                           for shape in ((5, 1000), (5, 1000), (5, W, 1000)))
            qt = torch.from_numpy(random_codes(rng, (3, m), n_rate=0.03)).cuda()
            err, _ = banded_compare("banded", (lo, hi, inj), qt, m, n, k)
            check(err == 0, f"banded kernel != plain on random words at {(m, n, k)} W={W}")
            max_err["banded"] = max(max_err["banded"], err)
    print(f"  banded (Peq-carry) on random initial windows and injection words at "
          f"{PEQ_WORDS}, one word (the clamp) and one past q_len - k's: max |diff| 0")
    return max_err


def phase_banded_bench(rng, smi):
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.banded_pipeline import KERNELS, BandedEngine
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from bgsa_tpu_torch.ops import banded as banded_ops
    from bgsa_tpu_torch.ops.banded_packed import packed_subbands

    phase(f"== phase 7: banded kernel and plain times ({smi})")
    n = m = 150
    k = 8
    band_down = banded_ops.geometry(m, n, k)[1]
    engine = BandedEngine(k, device="cuda")
    results = {}
    for label, Q, S in BANDED_TIMED:
        q, s = filter_mix_dataset(rng, Q, S, n)
        codes = torch.from_numpy(s.astype(np.int32)).cuda()
        qt = torch.from_numpy(q).cuda()
        # the bound's path: the query-code checks fall through on codes 0..3
        check(int(codes.max()) < 4 and int(qt.max()) < 4, "the banded bench inputs hold N")
        cells = Q * m * S * n
        print(f"  {label}: Q={Q} m={m} S={S} n={n} k={k}, filter mix, full-matrix cells")
        live = []  # live lanes before each column, counted by the plain stream version
        banded_ops.banded_stream_ref(engine.kernel_args("banded_stream", codes, m)[0], qt,
                                     q_len=m, s_len=n, k=k, live=live)
        print(f"    live (lane, column) pairs: {sum(live)} of {Q * S * m} "
              f"({sum(live) / (Q * S * m):.3f})")
        for name, (kernel, plain) in KERNELS.items():
            pack_ms = statistics.median(
                cuda_times_ms(lambda: engine.kernel_args(name, codes, m), runs=5, warmup=1))
            args = engine.kernel_args(name, codes, m)
            err, got = banded_compare(name, args, qt, m, n, k)
            check(err == 0, f"{name} kernel != plain at the {label}")
            kw = dict(q_len=m, s_len=n, k=k)
            kernel_ms = statistics.median(
                cuda_times_ms(lambda: kernel(*args, qt, **kw), runs=20, warmup=3))
            plain_ms = statistics.median(
                cuda_times_ms(lambda: plain(*args, qt, **kw), runs=3, warmup=1))
            over = float((got == 127).float().mean())
            # sub-ms kernels: CUDA events hold the host's dispatch; a graph's do not
            device_ms = statistics.median(graph_times_ms(lambda: kernel(*args, qt, **kw)))
            print(f"    {name:21s} kernel median {kernel_ms:.4f} ms over 20 runs = "
                  f"{cells / kernel_ms / 1e6:.1f} GCUPS; device time {device_ms:.4f} ms (median "
                  f"of {GRAPH_REPLAYS} replays of a CUDA graph of {GRAPH_LAUNCHES} launches); "
                  f"plain torch median {plain_ms:.1f} ms over 3 runs; device packing "
                  f"{pack_ms:.3f} ms; over budget {over:.3f}; max |diff| {err} ({smi})")
            if label == BANDED_TIMED[0][0]:
                n_sub = packed_subbands(m, n, k) if name == "banded_stream_packed" else 1
                results[name] = (err, kernel_ms, plain_ms, Work(
                    main_library(), {"n_sub": n_sub, "wide": int(band_down >= 32)},
                    sum(live) / n_sub, roofline.io_bytes(*args, qt, got),
                    roofline.banded_ops(name, live)), device_ms)
        # the routes' own geometries, each on prefixes of one mix
        longest = max(max(gm, gn) for geoms in ROUTE_GEOMETRIES.values() for gm, gn, _ in geoms)
        route_q, route_s = filter_mix_dataset(rng, Q, S, longest)
        for name, geometries in ROUTE_GEOMETRIES.items():
            kernel = KERNELS[name][0]
            for gm, gn, gk in geometries:
                gqt = torch.from_numpy(np.ascontiguousarray(route_q[:, :gm])).cuda()
                gargs = BandedEngine(gk, device="cuda").kernel_args(
                    name, torch.from_numpy(route_s[:, :gn].astype(np.int32)).cuda(), gm)
                err, got = banded_compare(name, gargs, gqt, gm, gn, gk)
                check(err == 0, f"{name} kernel != plain at {(gm, gn, gk)}, the {label}")
                kw = dict(q_len=gm, s_len=gn, k=gk)
                kernel_ms = statistics.median(
                    cuda_times_ms(lambda: kernel(*gargs, gqt, **kw), runs=20, warmup=3))
                device_ms = statistics.median(graph_times_ms(lambda: kernel(*gargs, gqt, **kw)))
                print(f"    {name:21s} at q={gm} s={gn} k={gk} (band_down "
                      f"{banded_ops.geometry(gm, gn, gk)[1]}): kernel median {kernel_ms:.4f} ms "
                      f"over 20 runs; device time {device_ms:.4f} ms; over budget "
                      f"{float((got == 127).float().mean()):.3f}; max |diff| {err} ({smi})")
    peq_route_bucket(rng, smi)
    return results


def peq_route_bucket(rng, smi):
    """The Peq-carry kernel at one bucket of its route (``PEQ_BUCKET``): held
    to its plain version (timed once; it also counts the live lanes), timed,
    and its bound printed."""
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.banded_pipeline import KERNELS, BandedEngine
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from bgsa_tpu_torch.ops import banded as banded_ops

    Q, m, n, k = PEQ_BUCKET
    S = bucket_subjects(n)
    q, s = filter_mix_dataset(rng, Q, S, m)
    qt = torch.from_numpy(q).cuda()
    args = BandedEngine(k, device="cuda").kernel_args(
        "banded", torch.from_numpy(s[:, :n].astype(np.int32)).cuda(), m)
    del s
    kernel, kw = KERNELS["banded"][0], dict(q_len=m, s_len=n, k=k)
    before = banded_launches()["banded"]
    got = kernel(*args, qt, **kw)
    torch.cuda.synchronize()
    check(banded_launches()["banded"] == before + 1, "banded did not launch its kernel")
    live, plain = [], []
    plain_ms = cuda_times_ms(lambda: plain.append(banded_ops.banded_ref(*args, qt, live=live,
                                                                        **kw)), runs=1, warmup=0)
    err = int((got.long() - plain[0].long()).abs().max())
    check(err == 0, f"banded kernel != plain at the Peq-carry route's bucket {PEQ_BUCKET}, S={S}")
    kernel_ms = statistics.median(cuda_times_ms(lambda: kernel(*args, qt, **kw), runs=20,
                                                warmup=3))
    device_ms = statistics.median(graph_times_ms(lambda: kernel(*args, qt, **kw)))
    band_down = banded_ops.geometry(m, n, k)[1]
    work = Work(main_library(), {"n_sub": 1, "wide": int(band_down >= 32)}, sum(live),
                roofline.io_bytes(*args, qt, got), None)
    bound_ms, bound_by, pipe, per_column, _ = kernel_bound("banded", device_ms, work, {}, None)
    print(f"  Peq-carry route bucket: Q={Q} m={m} S={S} n={n} k={k} (band_down {band_down}), "
          f"filter mix: kernel median {kernel_ms:.4f} ms over 20 runs; device time "
          f"{device_ms:.4f} ms; plain torch {plain_ms[0]:.1f} ms (1 run); over budget "
          f"{float((got == 127).float().mean()):.3f}; live (pair, column) pairs {sum(live)} of "
          f"{Q * S * m}; bound {bound_ms:.4f} ms by {bound_by} ({pipe} pipe; SASS per column "
          f"{per_column['alu']:.1f} ALU, {per_column['issue']:.1f} issued), "
          f"{100 * bound_ms / device_ms:.1f} % of the device time; max |diff| {err} ({smi})")


def graph_times_ms(fn) -> list:
    """Device ms of one ``fn()``: GRAPH_LAUNCHES calls captured in one CUDA
    graph, each of GRAPH_REPLAYS replays timed by CUDA events, over the
    launches. A call timed alone by CUDA events also holds the host's
    dispatch, which is as long as a sub-0.2 ms kernel; a replay launches the
    kernels back to back from the device."""
    fn()  # warm-up: the library is loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    return [t / GRAPH_LAUNCHES for t in cuda_times_ms(graph.replay, runs=GRAPH_REPLAYS, warmup=1)]


def write_codes(path, codes):
    lut = np.frombuffer(b"ACGTN", np.uint8)
    buf = np.empty((codes.shape[0], codes.shape[1] + 1), np.uint8)
    buf[:, :-1] = lut[codes]
    buf[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(buf.tobytes())


def check_against_banded_ref(rng, queries, subjects, scores, k):
    """4,096 sampled (query, subject) scores against banded_ref."""
    from bgsa_tpu_torch import banded_ref

    q_idx = rng.integers(0, len(queries), N_SAMPLES)
    s_idx = rng.integers(0, len(subjects), N_SAMPLES)
    want = np.array([banded_ref.banded_score(queries[qi], subjects[si], k)
                     for qi, si in zip(q_idx, s_idx)])
    bad = int(np.count_nonzero(scores[q_idx, s_idx] != want))
    check(bad == 0, f"{bad} of {N_SAMPLES} sampled scores differ from banded_ref (-k {k})")
    print(f"  {N_SAMPLES} sampled (query, subject) scores equal banded_ref "
          f"({float(np.mean(want == 127)):.3f} over budget)")


def phase_banded_production(rng, tmp, smi):
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from bgsa_tpu_torch import cli
    from bgsa_tpu_torch.banded_pipeline import BandedEngine

    phase(f"== phase 8: banded filter at production size through bgsa_tpu_torch.cli ({smi})")
    t0 = time.perf_counter()
    q, s = filter_mix_dataset(np.random.default_rng(1), 20, BANDED_SUBJECTS, 150)
    runs = {  # the kernel a run takes -> (k, queries, subjects)
        "banded_stream_packed": (8, q, s),
        "banded_stream": (16, q, s[:BANDED_SLICE]),
        "banded_stream_dual": (8, q, s[:BANDED_SLICE, :148]),
        "banded": (40, q[:, :55], s[:PEQ_SUBJECTS, :20]),
    }
    print(f"  generated inputs (filter_mix_dataset, seed 1) in {time.perf_counter() - t0:.2f} s")

    launches, max_err = {}, {}
    for name, (k, queries, subjects) in runs.items():
        (Q, m), (S, n) = queries.shape, subjects.shape
        qpath, spath = os.path.join(tmp, f"bq{m}.txt"), os.path.join(tmp, f"{name}.txt")
        res, stats_path = os.path.join(tmp, f"{name}.bin"), os.path.join(tmp, "bstats.json")
        write_codes(qpath, queries)
        write_codes(spath, subjects)
        reset_banded_launches()
        rc = cli.align_main(["-q", qpath, "-d", spath, "-f", res, "-k", str(k),
                             "--stats-json", stats_path, "--quiet"])
        counts = banded_launches()
        check(rc == 0, f"bgsa-torch-align -k {k} exited {rc}")
        check(counts[name] > 0, f"-k {k} run did not launch the {name} kernel")
        launches[name] = counts[name]
        print(f"  -k {k}: {Q} x {m} bp vs {S} x {n} bp: exit 0, kernel launches {counts}")
        st = print_stats(stats_path)
        check(st["subject_count"] == S, "subject count")
        scores = result_scores(res, Q, S, np.int8)
        os.unlink(res)
        os.unlink(spath)

        # the run's kernel against its plain version on the run's whole input
        engine = BandedEngine(k, device="cuda")
        check(engine.route(m, n) == name, f"(q={m}, s={n}, k={k}) does not route to {name}")
        codes = torch.from_numpy(subjects.astype(np.int32)).cuda()
        qt = torch.from_numpy(queries.astype(np.int32)).cuda()
        err, got = banded_compare(name, engine.kernel_args(name, codes, m), qt, m, n, k)
        check(err == 0, f"{name} kernel != plain at Q={Q} m={m} S={S} n={n} k={k}")
        max_err[name] = err
        check(np.array_equal(scores, got[:, :S].to(torch.int8).cpu().numpy()),
              f"-k {k} result file != the {name} kernel's scores")
        print(f"  {name} kernel vs plain torch version on the run's whole input "
              f"(Q={Q} m={m} S={S} n={n} k={k}): max |diff| {err}; every score in the "
              "result file equals it")
        check_against_banded_ref(rng, queries, subjects, scores, k)
    return launches, max_err


# -- general integer scoring (BitPAl) ------------------------------------------

BITPAL_KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "bitpal_packed": ("bgsa_tpu_torch/csrc/bitpal_packed.cu", "bgsa_tpu/ops/bitpal_packed.py:347"),
    "bitpal": ("bgsa_tpu_torch/csrc/bitpal.cu", "bgsa_tpu/ops/bitpal.py:315"),
}
# the kernel grid's schemes: the bench scheme, small and zero-match
# lattices, an unpacked-only scheme and two wide ones (28 planes unpacked,
# and VERDICT's (5,-4,-10): 26 planes, whose register path ends at 2 words
# and whose carries take two words)
BITPAL_SCHEMES = [(2, -3, -5), (1, -1, -1), (0, -2, -3), (5, -1, -2), (5, -4, -11),
                  (5, -4, -10)]
# (n, m, S): 1100 bp is past every scheme's register bound (the tiled
# kernel), and its 33 query columns cross the 32-column tile (the planes go
# through the scratch); at 500 bp a tiled kernel is also held to the
# word-major plain model
BITPAL_GRID = [(1, 12, 1000), (33, 12, 129), (150, 12, 1000), (500, 6, 129), (1100, 33, 200)]
BITPAL_MODEL_N = 500
# timed shapes (label, Q, m, S, n) for (2,-3,-5): the JAX bench's BitPAl
# line, one bucket of the production run, and 1,100 bp (the tiled kernel
# on both routes)
BITPAL_TIMED = (("bench line (bench.py:187, 310-321)", 40, 500, 32768, 500),
                ("one production bucket", 20, 150, 190080, 150),
                ("1,100 bp", 40, 500, 8192, 1100))
# subjects of the packed production run and of the slice the other runs take
BITPAL_SUBJECTS, BITPAL_SLICE = 1_000_000, 100_000


def bitpal_specs():
    """(kernel, M, I, G) of every BitPAl library the smoke test builds."""
    from bgsa_tpu_torch.ops import bitpal as tb
    from bgsa_tpu_torch.ops import bitpal_packed as tbp

    return [(name, *scheme) for scheme in BITPAL_SCHEMES for name in BITPAL_KERNELS
            if name == "bitpal" or tbp.packed_supported(tb.BitpalParams(*scheme))]


def bitpal_fns(name):
    """(wrapper, plain version, module holding LAUNCHES, word-major plain
    model of the tiled kernel) of a BitPAl kernel."""
    from bgsa_tpu_torch.ops import bitpal as tb
    from bgsa_tpu_torch.ops import bitpal_packed as tbp

    if name == "bitpal_packed":
        return tbp.bitpal_packed, tbp.bitpal_packed_ref, tbp, tbp.bitpal_packed_tiled_ref
    return tb.bitpal, tb.bitpal_ref, tb, tb.bitpal_tiled_ref


def bitpal_launches():
    return {name: bitpal_fns(name)[2].LAUNCHES for name in BITPAL_KERNELS}


def bitpal_paths(name, scheme, W, m):
    """Which instance a launch takes: 'registers', or 'tiled' (with the
    number of tiles of the library's tile_columns)."""
    from bgsa_tpu_torch.ops import build

    lib = build.load_scheme(name, *scheme)
    if W <= lib.reg_words:
        return "registers"
    return f"tiled, {max(1, -(-m // lib.tile_columns))} tile(s)"


def reset_bitpal_launches():
    for name in BITPAL_KERNELS:
        bitpal_fns(name)[2].LAUNCHES = 0


def bitpal_compare(name, eq, qt, model=False, **kw):
    """Kernel vs plain version on the same CUDA tensors -> (max |diff|,
    kernel out, plain ms by CUDA events). ``model``: the kernel's output is
    also held to the word-major plain model at the library's tile (the
    larger of the two differences is returned)."""
    from bgsa_tpu_torch.ops import build

    fn, ref, module, tiled_ref = bitpal_fns(name)
    before = module.LAUNCHES
    got = fn(eq, qt, **kw)
    torch.cuda.synchronize()
    check(module.LAUNCHES == before + 1, f"{name} did not launch its kernel")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    wants = [ref(eq, qt, **kw)]
    stop.record()
    torch.cuda.synchronize()
    if model:
        scheme = (kw["match"], kw["mismatch"], kw["gap"])
        wants.append(tiled_ref(eq, qt, tile=build.load_scheme(name, *scheme).tile_columns, **kw))
    err = 0
    for want in wants:
        check(got.shape == want.shape and got.dtype == want.dtype == torch.int32,
              f"{name} output shape/dtype")
        if got.numel():
            err = max(err, int((got.long() - want.long()).abs().max()))
    return err, got, start.elapsed_time(stop)


def phase_bitpal_kernels(rng):
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.ops import build

    phase(f"== phase 9: BitPAl kernels vs plain torch versions on the card (tolerance 0)")
    max_err = dict.fromkeys(BITPAL_KERNELS, 0)
    specs = bitpal_specs()
    modes = ((False, 1), (True, 2))
    for si, scheme in enumerate(BITPAL_SCHEMES):
        names = [name for name in BITPAL_KERNELS if (name, *scheme) in specs]
        for gi, (n, m, S) in enumerate(BITPAL_GRID):
            qt = torch.from_numpy(random_codes(rng, (3, m), n_rate=0.03)).cuda()
            codes = torch.from_numpy(random_codes(rng, (S, n), n_rate=0.03)).cuda()
            paths = []
            for bi, word_bits in enumerate((31, 32)):
                eq = pack.pack_eq(codes, word_bits)
                W = eq.shape[1]
                # one mode a word layout, turn about: each scheme and layout
                # runs both modes over the grid
                for semi, factor in (modes[(si + gi + bi) % 2],):
                    kw = dict(match=scheme[0], mismatch=scheme[1], gap=scheme[2], read_len=n,
                              factor=factor, semi_global=semi, word_bits=word_bits)
                    for name in names:
                        model = (n == BITPAL_MODEL_N
                                 and W > build.load_scheme(name, *scheme).reg_words)
                        err, _, _ = bitpal_compare(name, eq, qt, model=model, **kw)
                        check(err == 0, f"{name} {scheme} kernel != plain at n={n} m={m} S={S} "
                                        f"word_bits={word_bits} semi={semi}")
                        max_err[name] = max(max_err[name], err)
                for name in names:
                    path = bitpal_paths(name, scheme, W, m)
                    if path != "registers" and n == BITPAL_MODEL_N:
                        path += ", and vs the word-major model"
                    paths.append(f"{name}/{word_bits} W={W} {path}")
            first = "global" if (si + gi) % 2 == 0 else "semi-global"
            print(f"  {scheme} n={n:4d} m={m:2d} S={S:4d}, {first} at 31 bits, the other mode "
                  f"at 32: {'; '.join(paths)}: max |diff| 0")
    return max_err


def phase_bitpal_bench(rng, smi):
    """Kernel and plain times at BITPAL_TIMED -> ({name: (max |diff|, ms,
    plain ms, Work)} at the bench line, {label: (name, ms, Work)} of the
    other global lines)."""
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.ops import bitpal as tb
    from bgsa_tpu_torch.ops import bitpal_packed as tbp
    from bgsa_tpu_torch.ops import build

    phase(f"== phase 10: BitPAl kernel and plain times, (2,-3,-5) ({smi})")
    results, extra = {}, {}
    routes = (("bitpal_packed", 31), ("bitpal", 32))
    for label, Q, m, S, n in BITPAL_TIMED:
        cells = Q * m * S * n
        seed = int(rng.integers(1 << 30))  # the same subjects in both word layouts
        eqs = {wb: device_eq(np.random.default_rng(seed), S, n, wb) for wb in (31, 32)}
        qt = torch.from_numpy(random_codes(rng, (Q, m))).cuda()
        print(f"  {label}: Q={Q} m={m} S={S} n={n} (device unpack and pack_eq equal "
              "the host packers)")
        outs = {}
        for semi in ((False, True) if label == BITPAL_TIMED[1][0] else (False,)):
            for name, wb in routes:
                fn = bitpal_fns(name)[0]
                kw = dict(match=2, mismatch=-3, gap=-5, read_len=n, semi_global=semi,
                          word_bits=wb)
                if label == BITPAL_TIMED[2][0]:
                    # the plain versions take minutes here (phase 9 holds the
                    # kernels to them at 1,100 bp): the two kernels, two
                    # networks, must agree
                    outs[name] = fn(eqs[wb], qt, **kw)
                    err, plain_ms = 0, float("nan")
                else:
                    err, _, plain_ms = bitpal_compare(name, eqs[wb], qt, **kw)
                check(err == 0, f"{name} kernel != plain at the {label}")
                kernel_ms = statistics.median(
                    cuda_times_ms(lambda: fn(eqs[wb], qt, **kw), runs=10, warmup=2))
                W = eqs[wb].shape[1]
                path = bitpal_paths(name, (2, -3, -5), W, m)
                plain = "not run" if outs else f"{plain_ms:.1f} ms (one run)"
                print(f"    {name:13s} {wb}-bit {'semi-global' if semi else 'global'} W={W} "
                      f"({path}): kernel median {kernel_ms:.4f} ms over 10 runs = "
                      f"{cells / kernel_ms / 1e6:.1f} GCUPS; plain torch {plain}; max |diff| "
                      f"{err} ({smi})")
                if semi:
                    continue
                lib = build.load_scheme(name, 2, -3, -5)
                if W > lib.reg_words:
                    # the tiled kernel, bound by the network's own cost: the
                    # largest register instance's SASS per column over its
                    # words, for every word-column; the tiled kernel's own
                    # loop (carry packing, slots) is reported beside it
                    check(lib.reg_words > 0, f"{name} (2,-3,-5) has no register instance")
                    p = tb.BitpalParams(2, -3, -5)
                    planes = len(p.values) if name == "bitpal" else tbp._bits_num(p)
                    tiles = max(1, -(-m // lib.tile_columns))
                    work = Work(lib.path, {"bits": wb, "W": lib.reg_words},
                                Q * m * S * W / lib.reg_words,
                                roofline.io_bytes(eqs[wb], qt) + 4 * Q * S,
                                roofline.word_kernel_ops(name, Q, m, S, n),
                                state_bytes=2 * (tiles - 1) * planes * 4 * W * Q * S,
                                design=f"{name}_tiled")
                else:
                    work = Work(lib.path, {"bits": wb, "W": W}, Q * m * S,
                                roofline.io_bytes(eqs[wb], qt) + 4 * Q * S,
                                roofline.word_kernel_ops(name, Q, m, S, n))
                if label == BITPAL_TIMED[0][0]:
                    results[name] = (err, kernel_ms, plain_ms, work)
                else:
                    extra[f"{name}, {label}"] = (name, kernel_ms, work)
        if outs:
            check(torch.equal(outs["bitpal"], outs["bitpal_packed"]),
                  f"bitpal != bitpal_packed at the {label}")
            print(f"    bitpal and bitpal_packed equal at the {label} (max |diff| 0)")
    return results, extra


def phase_bitpal_golden(tmp):
    from bgsa_tpu_torch.io import result as result_io
    from bgsa_tpu_torch.pipeline import PipelineConfig
    from bgsa_tpu_torch.schemes import Scoring
    from bgsa_tpu_torch.pipeline import run_alignment

    phase(f"== phase 11: the 500 bp BitPAl golden through bgsa_tpu_torch.pipeline.run_alignment")
    for packed in (True, False):
        res, conv = os.path.join(tmp, "bitpal_golden.bin"), os.path.join(tmp, "bitpal_golden.txt")
        reset_bitpal_launches()
        run_alignment(os.path.join(REPO, "sample-data", "query.txt"),
                      os.path.join(REPO, "sample-data", "subject.txt"), res,
                      scoring=Scoring(2, -3, -5), config=PipelineConfig(bitpal_packed=packed),
                      device="cuda")
        launches = bitpal_launches()
        name = "bitpal_packed" if packed else "bitpal"
        check(launches[name] > 0, f"the golden run did not launch {name}")
        result_io.convert_result(res, conv)
        with open(conv, "rb") as f, open(os.path.join(GOLDEN, "sample_bitpal_2_m3_m5.txt"),
                                         "rb") as g:
            check(f.read() == g.read(), f"sample_bitpal_2_m3_m5.txt differs ({name})")
        print(f"  sample_bitpal_2_m3_m5.txt: byte-equal through {name} (launches {launches})")


def subject_codes(path, count):
    """The first ``count`` lines of a line-format subject file as (count, n) codes."""
    from bgsa_tpu_torch.pack import encode_ascii

    with open(path, "rb") as f:
        length = f.readline().index(b"\n")
    lines = np.fromfile(path, dtype=np.uint8, count=count * (length + 1))
    return encode_ascii(lines.reshape(count, length + 1)[:, :length]).astype(np.int32)


def check_bitpal_oracle(rng, queries, subjects, scores, scoring, semi):
    """4,096 sampled (query, subject) scores against oracle."""
    from bgsa_tpu_torch import oracle

    q_idx = rng.integers(0, len(queries), N_SAMPLES)
    s_idx = rng.integers(0, len(subjects), N_SAMPLES)
    want = np.empty(N_SAMPLES, np.int64)
    for qi in np.unique(q_idx):
        sel = np.nonzero(q_idx == qi)[0]
        if semi:  # BitPAl's semi-global: full query, subject ends free
            want[sel] = oracle.align_scores_query_in_subject(queries[qi], subjects[s_idx[sel]],
                                                              scoring)
        else:
            want[sel] = oracle.align_scores(queries[qi], subjects[s_idx[sel]], scoring)
    bad = int(np.count_nonzero(scores[q_idx, s_idx] != want))
    check(bad == 0, f"{bad} of {N_SAMPLES} sampled scores differ from the oracle")
    print(f"  {N_SAMPLES} sampled (query, subject) scores equal oracle."
          f"{'align_scores_query_in_subject' if semi else 'align_scores'}")


def phase_bitpal_production(rng, tmp, smi, inputs):
    from bgsa_tpu_torch.io import seqfile
    from bgsa_tpu_torch.pipeline import PipelineConfig
    from bgsa_tpu_torch.schemes import Mode, Scoring, normalize
    from bgsa_tpu_torch import cli, pack
    from bgsa_tpu_torch.pipeline import Engine

    qp, sp, sp_slice = inputs
    phase(f"== phase 12: general scoring at production size through bgsa_tpu_torch.cli ({smi})")
    queries = seqfile.read_queries(qp)
    runs = [  # (flags, scoring, subject file, subject count)
        ([], Scoring(2, -3, -5), sp, BITPAL_SUBJECTS),
        (["--no-packed"], Scoring(2, -3, -5), sp_slice, BITPAL_SLICE),
        (["--semi-global"], Scoring(2, -3, -5), sp_slice, BITPAL_SLICE),
        ([], Scoring(5, -1, -2), sp_slice, BITPAL_SLICE),
    ]
    launches, max_err = {}, dict.fromkeys(BITPAL_KERNELS, 0)
    for flags, scoring, spath, S in runs:
        semi = "--semi-global" in flags
        scheme = normalize(scoring, Mode.SEMI_GLOBAL if semi else Mode.GLOBAL)
        engine = Engine(scheme, PipelineConfig(bitpal_packed="--no-packed" not in flags), "cuda")
        name, word_bits = engine.kernel, engine.word_bits
        res, stats_path = os.path.join(tmp, "bitpal.bin"), os.path.join(tmp, "bitpal_stats.json")
        args = ["-M", str(scoring.match), "-I", str(scoring.mismatch), "-G", str(scoring.gap),
                *flags]
        reset_bitpal_launches()
        rc = cli.align_main(["-q", qp, "-d", spath, "-f", res, *args, "--stats-json",
                             stats_path, "--quiet"])
        counts = bitpal_launches()
        check(rc == 0, f"bgsa-torch-align {' '.join(args)} exited {rc}")
        check(counts[name] > 0, f"{' '.join(args)} did not launch the {name} kernel")
        launches.setdefault(name, counts[name])  # the first run of each kernel
        print(f"  {' '.join(args)}: {len(queries)} x {queries.shape[1]} bp vs {S} subjects: "
              f"exit 0, {name} with {word_bits}-bit words, kernel launches {counts}")
        st = print_stats(stats_path)
        check(st["subject_count"] == S, "subject count")
        scores = result_scores(res, len(queries), S, np.int16)
        os.unlink(res)

        # the run's kernel against its plain version on the run's whole input
        subjects = subject_codes(spath, S)
        eq = pack.pack_eq(torch.from_numpy(subjects).cuda(), word_bits)
        qt = torch.from_numpy(queries.astype(np.int32)).cuda()
        err, got, plain_ms = bitpal_compare(
            name, eq, qt, match=scheme.match, mismatch=scheme.mismatch, gap=scheme.gap,
            read_len=subjects.shape[1], factor=scheme.factor, semi_global=semi,
            word_bits=word_bits)
        check(err == 0, f"{name} kernel != plain on the {' '.join(args)} run's input")
        max_err[name] = max(max_err[name], err)
        check(np.array_equal(scores, got.to(torch.int16).cpu().numpy()),
              f"{' '.join(args)} result file != the {name} kernel's scores")
        print(f"  {name} kernel vs plain torch version on the run's whole input (Q={len(queries)} "
              f"S={S} n={subjects.shape[1]}): max |diff| {err} (plain {plain_ms:.0f} ms); every "
              "score in the result file equals it")
        check_bitpal_oracle(rng, queries, subjects, scores, scoring, semi)
        del eq, got
    return launches, max_err


# -- the 31-bit Myers kernel, the mesh and --shards ----------------------------

MYERS_GLOBAL = ("bgsa_tpu_torch/csrc/myers_pallas.cu", "bgsa_tpu/ops/myers_pallas.py:89")
INT_PEAK = ("bgsa_tpu_torch/csrc/int_peak.cu", "scripts/roofline.py:187")
# (n, m, Q, S): every 31-bit word boundary near 31, 62 and 93, the register /
# strip switch above 32 words (992 bp), the strip boundaries, and ragged
# subject counts
MYERS31_GRID = [(n, 150, 3, 1000) for n in (1, 30, 31, 32, 61, 62, 63, 92, 93, 94, 150,
                                            500, 992, 993, 1500)]
MYERS31_GRID += [(150, 60, 2, 1), (500, 100, 3, 129), (62, 1100, 2, 777)] + STRIP_GRID
SHARD_SUBJECTS = 20_000  # subjects of the sharded-engine checks (even: two shards)
# timed shapes (label, Q, m, S, n) of phase 14: the JAX bench's Myers line and
# one production bucket (S None: the bucket's subject count)
MYERS31_TIMED = (("bench geometry (bench.py:187)", 40, 500, 32768, 500),
                 ("one production bucket", 20, 150, None, 150))
CARD = torch.device("cuda", 0)  # the mesh and shard checks repeat it


def phase_myers_global_kernel(rng):
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.ops import build
    from bgsa_tpu_torch.ops import myers_pallas as mp
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    phase(f"== phase 13: the 31-bit Myers kernel vs its plain version and the full-word "
          "kernel on the card (tolerance 0)")
    reg_words = build.load().lib.bgsa_myers_global_reg_words()
    max_err = 0
    for n, m, Q, S in MYERS31_GRID:
        queries = torch.from_numpy(random_codes(rng, (Q, m), n_rate=0.03)).cuda()
        if (n, m, Q, S) in STRIP_GRID:
            codes = torch.from_numpy(skewed_subjects(rng, S, n, n_rate=0.03)).cuda()
        else:
            codes = torch.from_numpy(random_codes(rng, (S, n), n_rate=0.03)).cuda()
        eq31, eq32 = pack.pack_eq(codes, 31), pack.pack_eq(codes, 32)
        # one plain run a geometry: its scores times factor (-1 or +1)
        plain = mp.myers_global_ref(eq31, queries, read_len=n, factor=1)
        for factor in (-1, 1):
            before = mp.LAUNCHES
            got = mp.myers_global(eq31, queries, read_len=n, factor=factor)
            torch.cuda.synchronize()
            check(mp.LAUNCHES == before + 1, "myers_global did not launch its kernel")
            want = plain * factor
            full = ms.myers_semiglobal(eq32, queries, read_len=n, factor=factor, is_global=True)
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"myers_global kernel != plain at n={n} m={m} S={S}")
            check(torch.equal(got, full), f"myers_global != the full-word kernel at n={n}")
            max_err = max(max_err, err)
        W = eq31.shape[1]
        print(f"  n={n:5d} m={m:5d} Q={Q} S={S:5d} W={W:3d} "
              f"({myers_path(W, reg_words, Q, S, m)}), factor -1 and +1: "
              "max |diff| 0 against the plain version, equal to myers_semiglobal's global scores")
    return max_err


def phase_myers_global_bench(rng, smi, long_lines):
    """Both Myers kernels on the same subjects: with their plain versions at
    MYERS31_TIMED, and past the register bound (the strip kernels, no plain
    run: it loops over m x W in Python) at MYERS_LONG, held to each other and
    to oracle samples -> (the 31-bit bench line's (max |diff|, ms, plain
    ms, Work), {name: (max |diff|, ms, plain ms, Work)} of each strip kernel
    at STRIP_ROW and of each wavefront at WAVE_ROW, one plain run each)."""
    from bgsa_tpu_torch import pack, roofline
    from bgsa_tpu_torch.ops import myers_pallas as mp
    from bgsa_tpu_torch.ops import myers_semiglobal as ms
    from bgsa_tpu_torch.schemes import Mode

    phase(f"== phase 14: 31-bit and full-word Myers times on the same subjects ({smi})")
    kernels = {"myers_global": (mp.myers_global, mp.myers_global_ref, 31),
               "myers_semiglobal": (
                   lambda e, q, **kw: ms.myers_semiglobal(e, q, is_global=True, **kw),
                   lambda e, q, **kw: ms.myers_semiglobal_ref(e, q, is_global=True, **kw), 32)}
    result = None
    for label, Q, m, S, n in MYERS31_TIMED:
        S = S or bucket_subjects(n)
        seed = int(rng.integers(1 << 30))  # the same subjects in both word layouts
        eqs = {wb: device_eq(np.random.default_rng(seed), S, n, wb) for wb in (31, 32)}
        qt = torch.from_numpy(random_codes(rng, (Q, m))).cuda()
        cells = Q * m * S * n
        print(f"  {label}: Q={Q} m={m} S={S} n={n}, global")
        times = {}
        for name, (fn, ref, wb) in kernels.items():
            eq = eqs[wb]
            got = fn(eq, qt, read_len=n)
            want = ref(eq, qt, read_len=n)
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"{name} kernel != plain at the {label}")
            kernel_ms = statistics.median(cuda_times_ms(lambda: fn(eq, qt, read_len=n),
                                                        runs=20, warmup=3))
            plain_ms = statistics.median(cuda_times_ms(lambda: ref(eq, qt, read_len=n),
                                                       runs=3, warmup=1))
            times[name] = got
            print(f"    {name:16s} kernel median {kernel_ms:.4f} ms over 20 runs = "
                  f"{cells / kernel_ms / 1e6:.1f} GCUPS; plain torch median {plain_ms:.1f} ms "
                  f"over 3 runs; max |diff| {err} ({smi})")
            if name == "myers_global" and result is None:
                result = (err, kernel_ms, plain_ms, Work(
                    main_library(), {"W": eq.shape[1]}, Q * m * S,
                    roofline.io_bytes(eq, qt) + 4 * Q * S,
                    roofline.word_kernel_ops("myers_global", Q, m, S, n)))
        check(torch.equal(times["myers_global"], times["myers_semiglobal"]),
              f"the two layouts' scores differ at the {label}")
        print("    both kernels give the same scores")

    strips, waves = {}, {}
    sms = roofline.sm_count(CARD)
    with OracleSamples() as oracles:  # each shape's samples, checked after the last
        for label, Q, m, n, S in MYERS_LONG:
            S = S or bucket_subjects(n)
            wave = ms.strip_wave(Q, S, m, sms)
            subjects, queries = skewed_subjects(rng, S, n), random_codes(rng, (Q, m))
            codes, qt = torch.from_numpy(subjects).cuda(), torch.from_numpy(queries).cuda()
            print(f"  {label}: Q={Q} m={m} S={S} n={n}, global (the strip kernels, "
                  f"{'the wavefront' if wave else 'one warp a group'})")
            outs = {}
            for name, (fn, ref, wb) in kernels.items():
                module = mp if wb == 31 else ms
                eq = pack.pack_eq(codes, wb)
                before = module.WAVE_LAUNCHES if wave else module.STRIP_LAUNCHES
                outs[name] = fn(eq, qt, read_len=n)
                after = module.WAVE_LAUNCHES if wave else module.STRIP_LAUNCHES
                check(after == before + 1, f"{name} did not run its strip kernel at the {label}")
                t = cuda_times_ms(lambda: fn(eq, qt, read_len=n), runs=5, warmup=1)
                kernel_ms, work = statistics.median(t), strip_work(name, eq, qt, n, wave)
                long_lines[f"{name} strips{' wave' if wave else ''}, {label}"] = (
                    f"{name} strips{' wave' if wave else ''}", kernel_ms, work)
                print(f"    {name:16s} W={eq.shape[1]:4d}: kernel median {kernel_ms:.4f} ms of 5 "
                      f"({min(t):.4f}-{max(t):.4f}) = {Q * m * S * n / kernel_ms / 1e6:.1f} GCUPS "
                      f"({smi})")
                del eq
            check(torch.equal(outs["myers_global"], outs["myers_semiglobal"]),
                  f"the two strip kernels' scores differ at the {label}")
            got = outs["myers_global"].cpu().numpy()
            oracles.submit(f"the strip kernels, {label}", rng, queries, subjects, got, Mode.GLOBAL)
            print(f"    both kernels give the same scores ({len(np.unique(got))} distinct, "
                  f"{-got.max() - (n - m)} to {-got.min() - (n - m)} above n - m)")

    # the kernels line's rows: the strip kernels and their wavefronts, each
    # against its plain version
    for (Q, m, n, S), wave, rows in ((STRIP_ROW, False, strips), (WAVE_ROW, True, waves)):
        S = S or bucket_subjects(n)
        schedule = "the wavefront" if wave else "one warp a group"
        check(ms.strip_wave(Q, S, m, sms) == wave, f"the row Q={Q} m={m} S={S} is not {schedule}")
        codes = torch.from_numpy(skewed_subjects(rng, S, n, n_rate=0.03)).cuda()
        qt = torch.from_numpy(random_codes(rng, (Q, m), n_rate=0.03)).cuda()
        print(f"  the kernels line's row, {schedule}: Q={Q} m={m} S={S} n={n}, global")
        outs = {}
        for name, (fn, ref, wb) in kernels.items():
            module = mp if wb == 31 else ms
            eq = pack.pack_eq(codes, wb)
            before = module.WAVE_LAUNCHES if wave else module.STRIP_LAUNCHES
            outs[name] = fn(eq, qt, read_len=n)
            after = module.WAVE_LAUNCHES if wave else module.STRIP_LAUNCHES
            check(after == before + 1, f"{name} did not run its strip kernel ({schedule})")
            plain_ms, err = plain_once(ref, eq, qt, n, outs[name])
            check(err == 0, f"{name} strip kernel ({schedule}) != plain")
            kernel_ms = statistics.median(cuda_times_ms(lambda: fn(eq, qt, read_len=n),
                                                        runs=20, warmup=3))
            rows[name] = (err, kernel_ms, plain_ms, strip_work(name, eq, qt, n, wave))
            print(f"    {name:16s} W={eq.shape[1]:4d}: kernel median {kernel_ms:.4f} ms over 20 "
                  f"runs; plain torch {plain_ms:.1f} ms (one run); max |diff| 0 ({smi})")
        check(torch.equal(outs["myers_global"], outs["myers_semiglobal"]),
              f"the two strip kernels' scores differ ({schedule})")
    return result, strips, waves


def plain_once(ref, eq, qt, n, got):
    """(ms of one plain run by CUDA events, max |diff| against ``got``)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = ref(eq, qt, read_len=n)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), int((got.long() - want.long()).abs().max())


def equal_engines(make, q, s, label):
    """An engine on two shards of cuda:0 against the same engine on one
    device: equal scores, and each shard launched the engine's kernel."""
    one = np.asarray(make(None).scores(q, s))
    two = make([CARD] * 2)
    before = kernel_launch_counts()
    got = two.scores(q, s)
    after = kernel_launch_counts()
    check(len(got.shards) == 2, f"{label}: not two shards")
    check(np.array_equal(np.asarray(got), one), f"{label}: two shards != one device")
    grew = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    check(sum(grew.values()) == 2, f"{label}: the shards launched {grew}, not one kernel each")
    return grew


def kernel_launch_counts():
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    return {**banded_launches(), **bitpal_launches(), "myers_semiglobal": ms.LAUNCHES}


def phase_mesh_and_shards(rng, tmp, smi, slice_path):
    import contextlib
    import io

    from bgsa_tpu_torch import cli, pack
    from bgsa_tpu_torch.banded_pipeline import BandedEngine
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from bgsa_tpu_torch.io import result as result_io
    from bgsa_tpu_torch.ops import myers_pallas as mp
    from bgsa_tpu_torch.parallel.mesh import make_mesh, myers_global_sharded
    from bgsa_tpu_torch.pipeline import Engine, PipelineConfig, run_alignment
    from bgsa_tpu_torch.schemes import Scoring, normalize

    phase(f"== phase 15: the device mesh and --shards on one card, cuda:0 repeated ({smi})")
    Q, n = 20, 150
    S = bucket_subjects(n)
    eq31 = device_eq(rng, S, n, 31)
    qt = torch.from_numpy(random_codes(rng, (Q, n))).cuda()
    single = mp.myers_global(eq31, qt, read_len=n).cpu().numpy()
    mesh = make_mesh([CARD] * 4, query_shards=2)
    mp.LAUNCHES = 0  # the mesh path: myers_global_sharded, merge both ways
    sharded = myers_global_sharded(eq31, qt, mesh, read_len=n)
    merged = myers_global_sharded(eq31, qt, mesh, read_len=n, merge=True)
    torch.cuda.synchronize()
    launches = mp.LAUNCHES
    check(launches == 8, f"the mesh path launched myers_global {launches} times, not 4 + 4")
    check(np.array_equal(np.asarray(sharded), single), "sharded scores != one device")
    check(merged.device == CARD and np.array_equal(merged.cpu().numpy(), single),
          "merged scores != one device")
    print(f"  myers_global_sharded over a {mesh.shape} mesh of cuda:0 at the production bucket "
          f"(Q={Q}, S={S}, n={n}): merge=False and merge=True equal the one-device kernel; "
          f"myers_global launches {launches}")
    # past the register bound: the card-filling shape (every shard the strip
    # kernel on one warp a group) and the 40 kbp bucket (few pairs: the
    # wavefront; a 5 kbp bucket's shards are few pairs too)
    strip_launched = []
    for (label, lq, lm, ln, ls), wave in ((MYERS_LONG[4], False), (MYERS_LONG[3], True)):
        ls = ls or bucket_subjects(ln)
        long_eq = pack.pack_eq(torch.from_numpy(skewed_subjects(rng, ls, ln)).cuda(), 31)
        long_q = torch.from_numpy(random_codes(rng, (lq, lm))).cuda()
        one = mp.myers_global(long_eq, long_q, read_len=ln).cpu().numpy()
        mp.LAUNCHES = mp.STRIP_LAUNCHES = mp.WAVE_LAUNCHES = 0
        sharded = myers_global_sharded(long_eq, long_q, mesh, read_len=ln)
        merged = myers_global_sharded(long_eq, long_q, mesh, read_len=ln, merge=True)
        torch.cuda.synchronize()
        ran = mp.WAVE_LAUNCHES if wave else mp.STRIP_LAUNCHES
        schedule = "the wavefront" if wave else "one warp a group"
        check(ran == mp.LAUNCHES == 8,
              f"the mesh path ran the strip kernel ({schedule}) {ran} of {mp.LAUNCHES} times, "
              "not 4 + 4")
        check(np.array_equal(np.asarray(sharded), one), f"sharded != one device at {label}")
        check(np.array_equal(merged.cpu().numpy(), one), f"merged != one device at {label}")
        print(f"  the same at the {label} (Q={lq}, m={lm}, S={ls}, n={ln}, "
              f"W={long_eq.shape[1]}): equal to the one-device kernel; strip-kernel launches "
              f"({schedule}) {ran}")
        strip_launched.append(ran)
        del long_eq

    # the engines on two shards against one device, 2-bit and 2bit+N transports
    queries = random_codes(rng, (Q, n))
    clean = random_codes(rng, (SHARD_SUBJECTS, n)).astype(np.uint8)
    rare_n = clean.copy()
    rare_n[rng.random(rare_n.shape) < 5e-4] = 4
    for subjects in (clean, rare_n):
        transport = pack.select_transport(subjects, n_shards=2)[0]
        for label, scoring, packed in (("Myers", Scoring(0, -1, -1), True),
                                       ("BitPAl packed", Scoring(2, -3, -5), True),
                                       ("BitPAl non-packed", Scoring(2, -3, -5), False)):
            grew = equal_engines(lambda d: Engine(normalize(scoring), PipelineConfig(
                bitpal_packed=packed), CARD, devices=d), queries, subjects, label)
            print(f"  Engine {label:17s} ({transport:5s}): two shards == one device; "
                  f"launches {grew}")
    for m, s_len, k in ((150, 150, 8), (150, 150, 16), (150, 148, 8), (55, 20, 40)):
        q, subj = filter_mix_dataset(rng, Q, SHARD_SUBJECTS, max(m, s_len))
        subj = subj[:, :s_len].astype(np.uint8)
        subj[rng.random(subj.shape) < 5e-4] = 4
        route = BandedEngine(k, device=CARD).route(m, s_len)
        grew = equal_engines(lambda d: BandedEngine(k, device=CARD, devices=d), q[:, :m],
                             subj, f"BandedEngine {route}")
        transport = pack.select_transport(subj, n_shards=2)[0]
        print(f"  BandedEngine q={m} s={s_len} k={k} ({route}, {transport}): two shards == one "
              f"device; launches {grew}")

    # the CLI: --shards 0 and the JAX error text past the visible devices
    with open(slice_path, "rb") as f:
        length = f.readline().index(b"\n")
    qp = os.path.join(tmp, "shard_queries.txt")
    write_codes(qp, random_codes(rng, (Q, length)))
    outs = {}
    for label, flags in (("unsharded", []), ("--shards 0", ["--shards", "0"])):
        res = os.path.join(tmp, f"shards_{len(flags)}.bin")
        rc = cli.align_main(["-q", qp, "-d", slice_path, "-f", res, "--quiet", *flags])
        check(rc == 0, f"bgsa-torch-align {' '.join(flags)} exited {rc}")
        outs[label] = res
    two = os.path.join(tmp, "shards_two.bin")
    run_alignment(qp, slice_path, two, devices=[CARD] * 2)
    texts = {}
    for label, res in (*outs.items(), ("two shards", two)):
        result_io.convert_result(res, res + ".txt")
        with open(res + ".txt", "rb") as f:
            texts[label] = f.read()
    check(texts["--shards 0"] == texts["unsharded"] == texts["two shards"],
          "a sharded run's converted text != the unsharded run's")
    # the lane-pad unit is v_num x shards: one card pads as one device does
    same_bytes = torch.cuda.device_count() == 1
    for suffix in ("", ".info") if same_bytes else ():
        with open(outs["unsharded"] + suffix, "rb") as f, open(outs["--shards 0"] + suffix,
                                                               "rb") as g:
            check(f.read() == g.read(), f"--shards 0 {suffix or 'result'} bytes != unsharded")
    print(f"  bgsa-torch-align --shards 0 ({torch.cuda.device_count()} visible device(s)) on the "
          f"{os.path.basename(slice_path)} slice: converted text equal to the unsharded run's"
          f"{', result and .info bytes too' if same_bytes else ''}; run_alignment on two "
          "shards of cuda:0: converted text equal")
    too_many = torch.cuda.device_count() + 1
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.align_main(["-q", qp, "-d", slice_path, "-f", os.path.join(tmp, "x.bin"),
                             "--quiet", "--shards", str(too_many)])
    want = (f"--shards {too_many} exceeds the {too_many - 1} visible local device(s); "
            "use --shards 0 for all local devices")
    check(rc == 1 and want in err.getvalue(), f"--shards {too_many}: rc {rc}, {err.getvalue()!r}")
    print(f"  --shards {too_many}: exit 1, {err.getvalue().strip()!r}")
    return launches, *strip_launched


def phase_int_peak(smi):
    from bgsa_tpu_torch import roofline

    phase(f"== phase 16: the int32 ALU issue peak ({smi})")
    sms, clock = roofline.sm_count(), roofline.sm_clock_mhz()
    derived = roofline.derived_int32_peak(clock, sms)
    roofline.LAUNCHES = 0  # the bound path: the measurement itself
    runs = {chains: roofline.measure_int32_peak(chains=chains) for chains in (8, 16, 32)}
    launches = roofline.LAUNCHES
    best = max(runs.values(), key=lambda r: r["ops_per_s"])
    text = roofline.sass_text(main_library())
    check(text is not None, "no cuobjdump: the SASS per chain step cannot be read")
    functions = roofline.sass_functions(text)
    spec = roofline.SASS_SPECS["int_peak"]
    for chains, r in runs.items():
        # both loops of the kernel: 35 iterations = two main-loop trips of 16 and 3 more
        x = r["x"]
        err = int((roofline.int_peak(x, steps=35, unroll=1).long()
                   - roofline.int_peak_ref(x, steps=35, unroll=1).long()).abs().max())
        check(err == 0, f"chains={chains}: int_peak kernel != plain at 35 iterations")
        check(1.8 <= r["linearity"] <= 2.2, f"chains={chains}: doubling the iterations took "
                                            f"x{r['linearity']:.3f}")
        per_step = {p: v / chains for p, v in roofline.column_instructions(
            roofline.find_function(functions, spec.function.format(chains=chains)), spec).items()}
        steps_per_s = r["ops_per_s"] / roofline.PEAK_OPS_PER_CHAIN_ITER
        share = {p: steps_per_s * v / (roofline.PIPE_RATES[p] * sms * clock * 1e6)
                 for p, v in per_step.items()}
        print(f"  chains={chains:2d}: {r['ms']:.3f} ms ({r['steps']} x {r['unroll']} iterations, "
              f"{r['elements']} elements), x2 iterations {r['ms_double']:.3f} ms = "
              f"x{r['linearity']:.3f}; {r['ops_per_s'] / 1e12:.3f} T source-ops/s = "
              f"{100 * r['ops_per_s'] / derived:.1f} % of one pipe; SASS per chain step "
              f"{per_step['alu']:.2f} ALU-pipe, {per_step['fma']:.2f} FMA-pipe, "
              f"{per_step['issue']:.2f} issued -> ALU pipe {100 * share['alu']:.1f} %, "
              f"FMA pipe {100 * share['fma']:.1f} %, issue {100 * share['issue']:.1f} % of its "
              "rate; kernel vs plain at 35 iterations: max |diff| 0")
        for p, v in share.items():
            check(v <= 1.05, f"chains={chains}: the {p} pipe at {100 * v:.1f} % of its "
                             "published rate")
    print(f"  {sms} SMs x 64 int32/clock x {clock:.0f} MHz (clocks.max.sm) = "
          f"{derived / 1e12:.3f} T/s a pipe; fastest: {best['ops_per_s'] / 1e12:.3f} T "
          f"source-ops/s at {best['chains']} chains; int_peak launches {launches}")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = roofline.int_peak_ref(best["x"], steps=best["steps"], unroll=best["unroll"])
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    err = int((best["out"].long() - want.long()).abs().max())
    check(err == 0, "the fastest int_peak run's output != its plain version")
    print(f"  the fastest run's output vs the plain version on the same inputs: max |diff| {err}; "
          f"plain {plain_ms:.1f} ms (one run)")
    work = Work(main_library(), {"chains": best["chains"]},
                best["elements"] * best["steps"] * best["unroll"], best["bytes"], best["ops"])
    return best, err, launches, plain_ms, work


# -- the paired-query experiments, the kprint fixture, gpu_parity --------------

PAIR_STREAM_GRID = [  # (q_len, s_len, k) of the stream pair and the probes
    (150, 150, 8),    # the experiments' geometry: four 32-column batches and a tail
    (150, 150, 16),   # the band in the high word (band_down >= 32)
    (150, 181, 16),   # band_down == 63
    (40, 44, 4),      # a short query with a single checkpoint
]
PAIR_PACKED_GRID = [  # (q_len, s_len, k) of the packed pair
    (150, 158, 8),    # n_sub = 2
    (150, 150, 8),    # n_sub = 3
    (72, 72, 5),      # n_sub = 5
    (100, 100, 4),    # n_sub = 6
    (3, 5, 4),        # q_len < k (n_sub = 5): err starts at k
]
PAIR_QUERIES = 4
# the packed column's cost probes (no TPU twin: not in the kernels line)
PACKED_PROBES = ("banded_packed_probe_full", "banded_packed_probe_static_c",
                 "banded_packed_probe_noload")


def pair_fns():
    """name -> (wrapper, plain version) of every kernel of PAIR_KERNELS."""
    import functools

    from bgsa_tpu_torch.ops import banded_packed_pair as bpp
    from bgsa_tpu_torch.ops import banded_pair as bpr

    fns = {"banded_stream_pair": (bpr.banded_stream_pair, bpr.banded_stream_pair_ref)}
    for mode in bpr.PROBE_MODES:
        fns[f"banded_probe_{mode}"] = (functools.partial(bpr.banded_probe, mode=mode),
                                       functools.partial(bpr.banded_probe_ref, mode=mode))
    fns["banded_packed_pair"] = (bpp.banded_packed_pair, bpp.banded_packed_pair_ref)
    for mode in bpp.PROBE_MODES:
        fns[f"banded_packed_probe_{mode}"] = (
            functools.partial(bpp.banded_packed_probe, mode=mode),
            functools.partial(bpp.banded_packed_probe_ref, mode=mode))
    return fns


def pair_launches():
    from bgsa_tpu_torch.ops import banded_packed_pair as bpp
    from bgsa_tpu_torch.ops import banded_pair as bpr

    return {**bpr.LAUNCHES, "banded_packed_pair": bpp.LAUNCHES,
            **{f"banded_packed_probe_{mode}": n for mode, n in bpp.PROBE_LAUNCHES.items()}}


def reset_pair_launches():
    from bgsa_tpu_torch.ops import banded_packed_pair as bpp
    from bgsa_tpu_torch.ops import banded_pair as bpr

    bpp.LAUNCHES = 0
    for name in bpr.LAUNCHES:
        bpr.LAUNCHES[name] = 0
    for mode in bpp.PROBE_LAUNCHES:
        bpp.PROBE_LAUNCHES[mode] = 0


def pair_compare(name, streams, qt, kw):
    """Kernel ``name`` vs its plain version on the same CUDA tensors -> (max
    |diff|, kernel out)."""
    kernel, plain = pair_fns()[name]
    before = pair_launches()[name]
    got = kernel(streams, qt, **kw)
    torch.cuda.synchronize()
    check(pair_launches()[name] == before + 1, f"{name} did not launch its kernel")
    want = plain(streams, qt, **kw)
    check(got.shape == want.shape and got.dtype == want.dtype == torch.int32,
          f"{name} output shape/dtype")
    return int((got.long() - want.long()).abs().max()), got


def phase_pair_kernels(rng):
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.banded_pipeline import BandedEngine
    from bgsa_tpu_torch.ops import banded as bo
    from bgsa_tpu_torch.ops import banded_packed as bpk

    phase(f"== phase 17: the paired-query kernels and the banded probes vs their plain versions, "
          "and each pair vs the kernel it pairs, on the card (tolerance 0)")
    max_err = dict.fromkeys([*PAIR_KERNELS, *PACKED_PROBES], 0)
    before = pair_launches()
    stream_names = [name for name in PAIR_KERNELS if name != "banded_packed_pair"]
    for grid, names, shipping in (
            (PAIR_STREAM_GRID, stream_names, "banded_stream"),
            (PAIR_PACKED_GRID, ["banded_packed_pair", *PACKED_PROBES], "banded_stream_packed")):
        for m, n, k in grid:
            kw = dict(q_len=m, s_len=n, k=k)
            over = []
            for kind in BANDED_KINDS:
                for S in RAGGED_S:
                    q, s = banded_inputs(rng, PAIR_QUERIES, m, S, n, k, kind)
                    codes, qt = torch.from_numpy(s).cuda(), torch.from_numpy(q).cuda()
                    if shipping == "banded_stream":
                        streams = pack.pack_banded_stream(codes, k, m)
                        want = bo.banded_stream(streams, qt, **kw)
                    else:
                        streams = BandedEngine(k, device="cuda").kernel_args(shipping, codes, m)[0]
                        want = bpk.banded_stream_packed(streams, qt, **kw)
                    for name in names:
                        err, got = pair_compare(name, streams, qt, kw)
                        check(err == 0, f"{name} kernel != plain at {(m, n, k)} {kind} S={S}")
                        max_err[name] = max(max_err[name], err)
                        if "pair" in name:
                            check(torch.equal(got, want),
                                  f"{name} != {shipping} at {(m, n, k)} {kind} S={S}")
                    if S == RAGGED_S[-1]:
                        over.append(f"{kind} {float((want == 127).float().mean()):.2f}")
            print(f"  q={m:3d} s={n:3d} k={k:2d}: {', '.join(names)} vs plain, pairs equal to "
                  f"{shipping}; share over budget: {', '.join(over)}; max |diff| 0")
    after = pair_launches()
    print(f"  kernel launches in phase 17: { {k: after[k] - before[k] for k in after} }")
    return max_err


def against_plain(name, inputs, kw):
    """Kernel ``name`` and its plain version on an experiment's own inputs ->
    (kernel out, plain ms, max |diff|); fails unless the two are equal."""
    from bgsa_tpu_torch.benchutil import elapsed_ms

    kernel, plain = pair_fns()[name]
    out, plain_out = kernel(*inputs, **kw), []
    plain_ms = elapsed_ms(lambda: plain_out.append(plain(*inputs, **kw)), CARD)
    err = int((out.long() - plain_out[0].long()).abs().max())
    check(err == 0, f"{name} kernel != plain at the experiment's shape {tuple(out.shape)}")
    return out, plain_ms, err


def phase_experiments(smi):
    """The two experiments at their own shapes -> (launches, {name: (ms,
    plain ms, max |diff|, Work)}) of PAIR_KERNELS: ms is the median device
    time of the variant's kernel in a chain (the profiler's); the plain
    version is timed once on the same inputs, and its output is held against
    the kernel's at tolerance 0."""
    from bgsa_tpu_torch import pack, roofline
    from bgsa_tpu_torch.benchutil import GateFailure
    from bgsa_tpu_torch.ops import banded as bo
    from bgsa_tpu_torch.ops import banded_packed_pair as bpp
    from bgsa_tpu_torch.ops import banded_pair as bpr
    from bgsa_tpu_torch.scripts import exp_banded_packed_pair as packed_exp
    from bgsa_tpu_torch.scripts import exp_banded_pair as pair_exp

    phase(f"== phase 18: the paired-query experiments at their own shapes ({smi})")
    reset_pair_launches()
    try:
        stream_run = pair_exp.run(CARD)
        pair_exp.report(stream_run)
        packed_runs = {kind: packed_exp.run(kind, CARD) for kind in packed_exp.KINDS}
        for result in packed_runs.values():
            packed_exp.report(result)
    except GateFailure as e:
        raise SmokeFailure(str(e)) from e
    torch.cuda.synchronize()
    launches = pair_launches()
    for name in PAIR_KERNELS:
        check(launches[name] > 0, f"the experiments launched no {name} kernel")
    print(f"  gates bit-exact; kernel launches {launches}")

    rows = {}
    stream, queries, kw = stream_run["stream"], stream_run["queries"], stream_run["kw"]
    (Q, m), S = queries.shape, stream.shape[-1]
    live = []  # the pair threads still running before each column
    bo.banded_stream_ref(stream, queries, live=live, threads=bpr.pair_threads, **kw)
    variants = {"banded_stream_pair": "pair", "banded_probe_full": "p_full",
                "banded_probe_static_c": "p_statc", "banded_probe_noload": "p_noload"}
    for name, label in variants.items():
        out, plain_ms, err = against_plain(name, (stream, queries), kw)
        columns = sum(live) if name == "banded_stream_pair" else Q * S * m  # probes: every one
        rows[name] = (statistics.median(stream_run["kernel_ms"][label]), plain_ms, err, Work(
            main_library(), {}, columns, roofline.io_bytes(stream, queries, out), None))
    mix = packed_runs["mix"]
    streams, queries, codes, kw = mix["streams"], mix["queries"], mix["codes"], mix["kw"]
    n_sub = streams.shape[0]
    live = []
    bo.banded_stream_ref(pack.pack_banded_stream(codes, kw["k"], kw["q_len"]), queries, live=live,
                         threads=bpp.packed_pair_threads(n_sub), **kw)
    out, plain_ms, err = against_plain("banded_packed_pair", (streams, queries), kw)
    rows["banded_packed_pair"] = (statistics.median(mix["kernel_ms"]["pair"]), plain_ms, err, Work(
        main_library(), {"n_sub": n_sub}, sum(live), roofline.io_bytes(streams, queries, out),
        None))
    packed_ms = statistics.median(mix["kernel_ms"]["packed"])
    for name, label in zip(PACKED_PROBES, ("p_full", "p_statc", "p_noload")):
        _, plain_ms, err = against_plain(name, (streams, queries), kw)
        ms = statistics.median(mix["kernel_ms"][label])
        print(f"  {name:28s} kernel alone {ms:.4f} ms (median device time in a chain; the "
              f"shipping packed kernel {packed_ms:.4f} ms); plain torch {plain_ms:.1f} ms, max "
              f"|diff| {err} ({smi})")
    for name, (ms, plain_ms, err, work) in rows.items():
        print(f"  {name:21s} kernel alone {ms:.4f} ms (median device time in a chain); plain "
              f"torch {plain_ms:.1f} ms (one run), kernel vs plain max |diff| {err}; "
              f"thread-columns the inputs need {work.columns:.0f} ({smi})")
    return launches, rows


def phase_kprint():
    """The fixture in a child process -> its JSON result (launches, ms, plain ms)."""
    phase(f"== phase 19: the kprint fixture in a child process (python -m bgsa_tpu_torch.debug)")
    proc = subprocess.run([sys.executable, "-m", "bgsa_tpu_torch.debug"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"python -m bgsa_tpu_torch.debug exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    results = [line for line in lines if line.startswith("{")]
    check(len(results) == 1, f"the child printed {len(results)} result lines")
    result = json.loads(results[0])
    probes = sum(line.strip() == "probe 0" for line in lines)
    check(result["out_equals_x"], "kprint_probe's output != its input")
    check(result["launches"] == 1, f"the fixture launched {result['launches']} kernels, not 1")
    check(probes == result["probe_lines"],
          f"{probes} 'probe 0' lines on the child's stdout, not {result['probe_lines']}")
    print(f"  exit 0; 'probe 0' printed {probes} times (the fixture's launch, a warm-up, "
          f"{result['timed_launches']} timed launches, the plain version); out == x; kernel "
          f"median {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms ({result['device']})")
    return result


def phase_gpu_parity():
    from bgsa_tpu_torch.scripts import gpu_parity

    phase(f"== phase 20: bgsa_tpu_torch.scripts.gpu_parity (every kernel family vs the oracles)")
    rc = gpu_parity.main([])
    check(rc == 0, f"gpu_parity exited {rc}")


def library_sass(library, sass) -> dict:
    """The SASS functions of a library, read once (``sass`` caches them)."""
    from bgsa_tpu_torch import roofline

    if library not in sass:
        text = roofline.sass_text(library)
        check(text is not None, "no cuobjdump: the kernels' SASS cannot be read")
        sass[library] = roofline.sass_functions(text)
    return sass[library]


def design_sass(work, sass):
    """Instructions per pipe of one trip of the design's own loop
    (``Work.design``; BitPAl's tiled kernel and the Myers strip kernels: one
    word-column), or None."""
    from bgsa_tpu_torch import roofline

    if work.design is None:
        return None
    spec = roofline.SASS_SPECS[work.design]
    return roofline.column_instructions(roofline.find_function(
        library_sass(work.library, sass), spec.function.format(**work.shape)), spec)


def kernel_bound(name, ms, work, sass, peak_ops_per_s):
    """(bound ms, "operations" or "bytes", pipe, instructions per column,
    JAX-op share) of one kernel row."""
    from bgsa_tpu_torch import roofline

    spec_name = work.bound_spec or name
    if spec_name not in roofline.SASS_SPECS:  # computes nothing: its bytes bound it
        return (*roofline.bound(0, work.nbytes, 1.0), None, None, None)
    spec = roofline.SASS_SPECS[spec_name]
    per_column = roofline.column_instructions(
        roofline.find_function(library_sass(work.library, sass),
                               spec.function.format(**work.shape)), spec)
    instructions, rate, pipe = roofline.instruction_bound(
        per_column, work.columns, roofline.sm_count(), roofline.sm_clock_mhz())
    bound_ms, bound_by = roofline.bound(instructions, work.nbytes, rate)
    check(bound_ms <= 1.05 * ms, f"{name}: bound {bound_ms:.4f} ms above its time {ms:.4f} ms")
    if work.jax_ops is None:
        return bound_ms, bound_by, pipe, per_column, None
    jax_ms = roofline.bound(work.jax_ops, work.nbytes, peak_ops_per_s)[0]
    return bound_ms, bound_by, pipe, per_column, jax_ms / ms


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import bgsa_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(bgsa_tpu_torch.__file__))
    if pkg_dir != os.path.join(REPO, "bgsa_tpu_torch"):
        print(f"FAIL: bgsa_tpu_torch imported from {pkg_dir}, not this checkout", file=sys.stderr)
        return 1
    rng = np.random.default_rng(2026)
    long_lines = {}  # label -> (row name, ms, Work) of the strip kernels' other shapes
    try:
        smi = phase_environment()
        max_err = phase_kernel_vs_plain(rng)
        bench_err, kernel_ms, plain_ms, myers_work = phase_bench(rng, smi, long_lines)
        with tempfile.TemporaryDirectory(prefix="bgsa_smoke_") as tmp:
            phase_goldens(tmp)
            (launches, strip_launches, wave_launches), inputs = phase_production(rng, tmp, smi)
            banded_err = phase_banded_kernels(rng)
            banded_times = phase_banded_bench(rng, smi)
            banded_launched, production_err = phase_banded_production(rng, tmp, smi)
            bitpal_err = phase_bitpal_kernels(rng)
            bitpal_times, bitpal_lines = phase_bitpal_bench(rng, smi)
            phase_bitpal_golden(tmp)
            bitpal_launched, bitpal_production_err = phase_bitpal_production(
                rng, tmp, smi, inputs)
            global_err = phase_myers_global_kernel(rng)
            global_times, strip_times, wave_times = phase_myers_global_bench(
                rng, smi, long_lines)
            global_launched, global_strip_launched, global_wave_launched = (
                phase_mesh_and_shards(rng, tmp, smi, inputs[2]))
        peak, peak_err, peak_launched, peak_plain, peak_work = phase_int_peak(smi)
        pair_err = phase_pair_kernels(rng)
        pair_launched, pair_rows = phase_experiments(smi)
        kprint = phase_kprint()
        phase_gpu_parity()
        check("jax" not in sys.modules, "jax was imported")
        check(not any(m == "bgsa_tpu" or m.startswith("bgsa_tpu.") for m in sys.modules),
              "a bgsa_tpu module was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    # (name, source, replaces, launches on its path, max |diff|, ms, plain ms, Work)
    rows = [("myers_semiglobal", KERNEL_SOURCE, KERNEL_REPLACES, launches,
             max(max_err, bench_err), kernel_ms, plain_ms, myers_work)]
    for label, times, launched in (("strips", strip_times, strip_launches),
                                   ("strips wave", wave_times, wave_launches)):
        err, ms, plain, work = times["myers_semiglobal"]
        rows.append((f"myers_semiglobal {label}", KERNEL_SOURCE, KERNEL_REPLACES, launched,
                     max(err, max_err), ms, plain, work))
    device = {}  # name -> device ms of a CUDA graph's replays, where taken
    for name, (source, replaces) in BANDED_KERNELS.items():
        err, ms, plain, work, device[name] = banded_times[name]
        rows.append((name, source, replaces, banded_launched[name],
                     max(err, banded_err[name], production_err[name]), ms, plain, work))
    for name, (source, replaces) in BITPAL_KERNELS.items():
        err, ms, plain, work = bitpal_times[name]
        rows.append((name, source, replaces, bitpal_launched[name],
                     max(err, bitpal_err[name], bitpal_production_err[name]), ms, plain, work))
    err, ms, plain, work = global_times
    rows.append(("myers_global", *MYERS_GLOBAL, global_launched, max(err, global_err), ms, plain,
                 work))
    for label, times, launched in (("strips", strip_times, global_strip_launched),
                                   ("strips wave", wave_times, global_wave_launched)):
        err, ms, plain, work = times["myers_global"]
        rows.append((f"myers_global {label}", *MYERS_GLOBAL, launched, max(err, global_err), ms,
                     plain, work))
    rows.append(("int_peak", *INT_PEAK, peak_launched, peak_err, peak["ms"], peak_plain,
                 peak_work))
    for name, (source, replaces) in PAIR_KERNELS.items():
        ms, plain, err, work = pair_rows[name]
        rows.append((name, source, replaces, pair_launched[name], max(err, pair_err[name]), ms,
                     plain, work))
    rows.append(("kprint_probe", *KPRINT, kprint["launches"], 0, kprint["ms"], kprint["plain_ms"],
                 Work(None, {}, 0, 2 * 4 * 8 * 128, None)))
    phase(f"== bounds: each kernel's SASS per column at the slowest pipe's rate, or its bytes")
    kernels, sass = [], {}
    try:
        for name, source, replaces, launched, err, ms, plain, work in rows:
            bound_ms, bound_by, pipe, per_column, jax_share = kernel_bound(
                name, ms, work, sass, peak["ops_per_s"])
            design = design_sass(work, sass)
            kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                            "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                            "device_ms": device.get(name), "state_bytes": work.state_bytes,
                            "design_sass": design})
            if per_column is None:
                how = "its bytes: it computes nothing, and its time is launch latency"
            else:
                how = (f"{pipe} pipe; SASS per column {per_column['alu']:.1f} ALU, "
                       f"{per_column['fma']:.1f} FMA, {per_column['issue']:.1f} issued")
            if jax_share is not None:
                how += f"; vs JAX-op count at the peak mix's rate {100 * jax_share:.1f} %"
            if work.design:
                how += (f" (the register network's, per word-column); the design's own "
                        f"{design['alu']:.2f} ALU, {design['issue']:.2f} issued, not in the bound")
            if work.state_bytes:
                how += f"; state {work.state_bytes / 1e9:.3f} GB through memory, not bound"
            print(f"  {name:21s} {ms:10.4f} ms, bound {bound_ms:10.4f} ms by {bound_by} "
                  f"({100 * bound_ms / ms:.1f} % of the time; {how}); launches {launched}")
        for label, (name, ms, work) in {**bitpal_lines, **long_lines}.items():  # other lines
            bound_ms, bound_by, pipe, per_column, _ = kernel_bound(
                name, ms, work, sass, peak["ops_per_s"])
            design = design_sass(work, sass)
            own = (f"; the design's own {design['alu']:.2f} ALU, {design['issue']:.2f} "
                   "issued, not in the bound" if design else "")
            print(f"  {label}: {ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({100 * bound_ms / ms:.1f} %; {pipe} pipe, register SASS per column "
                  f"{per_column['alu']:.1f} ALU, {per_column['issue']:.1f} issued{own}; state "
                  f"{work.state_bytes / 1e9:.3f} GB through memory)")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    phase("== done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
