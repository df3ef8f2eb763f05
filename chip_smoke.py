"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases; any failure exits non-zero, before the result line:

1. environment: a CUDA device, its name and power limit (nvidia-smi), and
   the kernel library built from the checkout's sources;
2. the Myers kernel against its plain torch version on the card, bit for
   bit (tolerance 0: integer scores), over subject lengths 1..1500 bp,
   ragged subject counts, both modes, factor -1 and +1, and N codes;
3. kernel and plain times by CUDA events, equal bit for bit, at the bench
   geometry (Q=40, m=500, S=32768, n=500, global) and at one bucket of the
   production run (Q=20, m=150, S=190,080, n=150, both modes), with the
   subjects taken through the device unpack and Eq packing;
4. the golden files through the port's ``run_alignment``, byte for byte;
5. production size: 20 x 150 bp queries against 1,000,000 x 150 bp subjects
   through ``bgsa_tpu_torch.cli.align_main`` (the main path; its kernel
   launches are counted), with 4,096 sampled scores checked against the
   numpy oracle, and the same in semi-global mode on a 100,000-subject slice;
6. the four banded kernels against their plain torch versions on the card,
   bit for bit (tolerance 0), over a geometry grid that hits every route and
   edge (packed n_sub 2, 3 and 6, the stream kernel's hi word and
   band_down == 63, the dual kernel with 2k >= 32, the Peq-carry corner, a
   single-checkpoint query), each on all-garbage, all-near and read-filter
   mix inputs at ragged subject counts; the device packers against
   the host ``pack.pack_banded_host``;
7. banded kernel and plain times by CUDA events at the JAX bench's banded
   line (Q=8, S=65,280, 150 bp, k=8, filter mix) and at one production
   bucket (Q=20, S=190,080), each of the four kernels on the same data;
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
   wide (5,-4,-11), subject lengths 1..1100 bp (1100 bp takes the scratch
   path of every scheme), both word layouts (31 and 32 bits), both modes
   and ragged subject counts;
10. BitPAl kernel and plain times by CUDA events at the JAX bench's BitPAl
    line (Q=40, m=500, S=32768, n=500, (2,-3,-5), global; packed with
    31-bit words, and the non-packed kernel with 32-bit words on the same
    data) and at one production bucket (Q=20, S=190,080, 150 bp, both
    kernels, both modes);
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
    and 93 and the register/scratch switch (992/993 bp), ragged subject
    counts, factor -1 and +1, N codes;
14. both Myers kernels and their plain versions timed by CUDA events on the
    same subjects at the bench geometry and at one production bucket;
15. the device mesh and ``--shards`` on one card: ``myers_global_sharded``
    over a (2, 2) mesh of ``cuda:0`` at the production bucket, merge both
    ways (its launches counted), every engine and route on two shards of
    ``cuda:0`` (2-bit and 2bit+N payloads) against one device,
    ``bgsa-torch-align --shards 0`` byte-equal to the unsharded run, and
    ``--shards`` past the visible devices refused with ``bgsa-align``'s text;
16. the int32 issue peak: its rate at 8, 16 and 32 chains and at twice the
    iterations, each chain count's kernel against its plain version at 35
    iterations (both of the kernel's loops) and the fastest run's output
    against its plain version on the same inputs (timed), and each pipe's
    rate (cuobjdump: the SASS per chain step) held to 105 % of SMs x 64 x
    ``clocks.max.sm``.

Kernel inputs are packed by ``BandedEngine.kernel_args``, as the engine
packs them for its route. Every kernel library (the main one and one per
BitPAl kernel and scheme) is built in phase 1, all nvcc processes started
together. The script imports ``bgsa_tpu_torch``, torch, numpy and the
standard library, and loads ``scripts/make_testdata.py`` by path; it fails
if jax or any ``bgsa_tpu`` module was loaded.

The second-to-last line is a JSON object describing each kernel of the
paths, with its bound: the kernel's own instructions per column (its SASS,
``roofline.column_instructions``) for the columns the timed inputs need, at
the slowest pipe's published rate at ``clocks.max.sm``, or the bytes over
3.35 TB/s, whichever is larger. A bound above 105 % of the kernel's measured
time fails the run: a floor cannot be slower than the kernel. The last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
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


class SmokeFailure(Exception):
    pass


@dataclasses.dataclass
class Work:
    """What a timed kernel run had to do, for its bound: the library and the
    shape that pick its SASS instance (``roofline.SASS_SPECS``), the
    thread-columns the inputs need, the bytes it must move, the JAX source's
    operation count, and the trips of a word loop nested in its column loop."""

    library: str
    shape: dict
    columns: float
    nbytes: int
    jax_ops: float
    inner_trips: int = 0


def main_library() -> str:
    from bgsa_tpu_torch.ops import build

    return build.load().path


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


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
    print("== phase 1: environment")
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    from bgsa_tpu_torch.ops import build

    t0 = time.perf_counter()
    kernels, scheme_libs = build.load_all(bitpal_specs())
    print(f"kernel library built from bgsa_tpu_torch/csrc/{{{','.join(build.SOURCES)}}}: "
          f"nvcc {kernels.build_seconds:.2f} s (one process per source, in parallel), "
          f"-> {os.path.relpath(kernels.path, REPO)}")
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    print("BitPAl libraries, one per kernel and scheme (built beside it, in parallel):")
    spilling = []
    for (name, *scheme), lib in zip(bitpal_specs(), scheme_libs):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", lib.log)]
        spills = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores", lib.log)
        spilled = sum(int(a) + int(b) for a, b in spills)
        print(f"  {name:13s} {tuple(scheme)}: nvcc {lib.build_seconds:.2f} s, "
              f"{len(regs)} kernels, ptxas registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"stack+spill bytes {spilled}, state in registers up to W={lib.reg_words}")
        if spilled:
            spilling.append(f"{name} {tuple(scheme)}")
            for line in lib.log.splitlines():
                if "Compiling entry" in line or "spill" in line or "registers" in line:
                    print("    ptxas:", line.strip())
    check(not spilling, f"ptxas reports a stack frame or spills in {', '.join(spilling)}")
    print(f"all libraries built and loaded in {time.perf_counter() - t0:.2f} s")
    return smi


def compare(eq, queries, *, read_len, factor, is_global):
    """Kernel vs plain version on the same CUDA tensors -> (max |diff|, kernel out)."""
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    got = ms.myers_semiglobal(eq, queries, read_len=read_len, factor=factor, is_global=is_global)
    torch.cuda.synchronize()
    want = ms.myers_semiglobal_ref(eq, queries, read_len=read_len, factor=factor,
                                   is_global=is_global)
    check(got.shape == want.shape and got.dtype == want.dtype, "kernel output shape/dtype")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0, got


def phase_kernel_vs_plain(rng):
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    print("== phase 2: kernel vs plain torch version on the card (tolerance 0)")
    launches0 = ms.LAUNCHES
    modes = [(True, -1), (False, 1), (True, 1), (False, -1)]
    # (n, m, Q, S): subject length, query length, queries, subjects
    geometries = [(n, 150, 3, 1000) for n in (1, 31, 32, 33, 150, 500, 960, 1500)]
    geometries += [(150, 1100, 2, 777), (33, 1, 3, 129), (500, 60, 1, 1)]
    max_err = 0
    for gi, (n, m, Q, S) in enumerate(geometries):
        queries = random_codes(rng, (Q, m), n_rate=0.03)
        subjects = random_codes(rng, (S, n), n_rate=0.03)
        if n == m:  # all-ones carries: a subject equal to a query, one of one base
            subjects[0] = queries[0]
            subjects[1] = 0
        codes = torch.from_numpy(subjects).cuda()
        eq = pack.pack_eq(codes, 32)
        qt = torch.from_numpy(queries).cuda()
        for is_global, factor in (modes[gi % 4], modes[(gi + 1) % 4]):
            err, _ = compare(eq, qt, read_len=n, factor=factor, is_global=is_global)
            print(f"  n={n:5d} m={m:5d} Q={Q} S={S:5d} W={eq.shape[1]:3d} "
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


def phase_bench(rng, smi):
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE

    print(f"== phase 3: kernel and plain times ({smi})")
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
    S = BUCKET_SIZE // (n + 1) // 128 * 128
    eq = device_eq(rng, S, n)
    qt = torch.from_numpy(random_codes(rng, (20, m))).cuda()
    print("  the production run's bucket shape:")
    errs = [time_kernel_and_plain(eq, qt, read_len=n, is_global=g, smi=smi)[0]
            for g in (True, False)]
    return max(bench[0], *errs), bench[1], bench[2], work


def phase_goldens(tmp):
    from bgsa_tpu_torch.io import result as result_io
    from bgsa_tpu_torch.pipeline import PipelineConfig
    from bgsa_tpu_torch.pipeline import run_alignment

    print("== phase 4: golden files through bgsa_tpu_torch.pipeline.run_alignment")
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


def phase_production(rng, tmp, smi):
    from bgsa_tpu_torch.schemes import Mode
    from bgsa_tpu_torch import cli
    from bgsa_tpu_torch.ops import myers_semiglobal as ms

    n_queries, n_subjects, length, n_semi = 20, 1_000_000, 150, 100_000
    print(f"== phase 5: production size, {n_queries} x {length} bp queries vs "
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
    return launches, (qp, sp, sp_semi)


# -- the banded filter (-k) --------------------------------------------------

BANDED_GRID = [  # (q_len, s_len, k): every route and edge
    (150, 158, 8),   # packed, n_sub = 2
    (150, 150, 8),   # packed, n_sub = 3 (the headline geometry)
    (100, 100, 4),   # packed, n_sub = 6
    (40, 44, 4),     # packed, a short query with a single checkpoint
    (150, 150, 16),  # stream, band in the hi word
    (150, 181, 16),  # stream, band_down == 63
    (100, 95, 20),   # dual, 2k >= 32 and band_down >= 32
    (150, 148, 8),   # dual
    (50, 20, 40),    # Peq-carry
    (55, 20, 40),    # Peq-carry
]
BANDED_KINDS = ("garbage", "near", "mix")
RAGGED_S = (1, 129, 1000)
# timed shapes (label, Q, S) at 150 bp, k=8: the JAX bench's banded line and
# one bucket of the production run (BUCKET_SIZE // 151, in 128s)
BANDED_TIMED = (("bench line (bench.py:278-284)", 8, 65280),
                ("one production bucket", 20, 190080))
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

    print("== phase 6: banded kernels vs plain torch versions on the card (tolerance 0)")
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
    return max_err


def phase_banded_bench(rng, smi):
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.banded_pipeline import KERNELS, BandedEngine
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from bgsa_tpu_torch.ops import banded as banded_ops
    from bgsa_tpu_torch.ops.banded_packed import packed_subbands

    print(f"== phase 7: banded kernel and plain times ({smi})")
    n = m = 150
    k = 8
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
            print(f"    {name:21s} kernel median {kernel_ms:.4f} ms over 20 runs = "
                  f"{cells / kernel_ms / 1e6:.1f} GCUPS; plain torch median {plain_ms:.1f} ms "
                  f"over 3 runs; device packing {pack_ms:.3f} ms; over budget {over:.3f}; "
                  f"max |diff| {err} ({smi})")
            if label == BANDED_TIMED[0][0]:
                n_sub = packed_subbands(m, n, k) if name == "banded_stream_packed" else 1
                results[name] = (err, kernel_ms, plain_ms, Work(
                    main_library(), {"n_sub": n_sub}, sum(live) / n_sub,
                    roofline.io_bytes(*args, qt, got), roofline.banded_ops(name, live)))
    return results


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

    print(f"== phase 8: banded filter at production size through bgsa_tpu_torch.cli ({smi})")
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
# lattices, an unpacked-only scheme and a wide one (28 planes unpacked)
BITPAL_SCHEMES = [(2, -3, -5), (1, -1, -1), (0, -2, -3), (5, -1, -2), (5, -4, -11)]
# (n, m, S): 1100 bp is past every scheme's register bound (the scratch path)
BITPAL_GRID = [(1, 12, 1000), (33, 12, 129), (150, 12, 1000), (500, 6, 129), (1100, 3, 200)]
# timed shapes (label, Q, m, S, n) for (2,-3,-5): the JAX bench's BitPAl line
# and one bucket of the production run
BITPAL_TIMED = (("bench line (bench.py:187, 310-321)", 40, 500, 32768, 500),
                ("one production bucket", 20, 150, 190080, 150))
# subjects of the packed production run and of the slice the other runs take
BITPAL_SUBJECTS, BITPAL_SLICE = 1_000_000, 100_000


def bitpal_specs():
    """(kernel, M, I, G) of every BitPAl library the smoke test builds."""
    from bgsa_tpu_torch.ops import bitpal as tb
    from bgsa_tpu_torch.ops import bitpal_packed as tbp

    return [(name, *scheme) for scheme in BITPAL_SCHEMES for name in BITPAL_KERNELS
            if name == "bitpal" or tbp.packed_supported(tb.BitpalParams(*scheme))]


def bitpal_fns(name):
    """(wrapper, plain version, module holding LAUNCHES) of a BitPAl kernel."""
    from bgsa_tpu_torch.ops import bitpal as tb
    from bgsa_tpu_torch.ops import bitpal_packed as tbp

    if name == "bitpal_packed":
        return tbp.bitpal_packed, tbp.bitpal_packed_ref, tbp
    return tb.bitpal, tb.bitpal_ref, tb


def bitpal_launches():
    return {name: bitpal_fns(name)[2].LAUNCHES for name in BITPAL_KERNELS}


def reset_bitpal_launches():
    for name in BITPAL_KERNELS:
        bitpal_fns(name)[2].LAUNCHES = 0


def bitpal_compare(name, eq, qt, **kw):
    """Kernel vs plain version on the same CUDA tensors -> (max |diff|,
    kernel out, plain ms by CUDA events)."""
    fn, ref, module = bitpal_fns(name)
    before = module.LAUNCHES
    got = fn(eq, qt, **kw)
    torch.cuda.synchronize()
    check(module.LAUNCHES == before + 1, f"{name} did not launch its kernel")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = ref(eq, qt, **kw)
    stop.record()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype == torch.int32,
          f"{name} output shape/dtype")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    return err, got, start.elapsed_time(stop)


def phase_bitpal_kernels(rng):
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.ops import build

    print("== phase 9: BitPAl kernels vs plain torch versions on the card (tolerance 0)")
    max_err = dict.fromkeys(BITPAL_KERNELS, 0)
    specs = bitpal_specs()
    for scheme in BITPAL_SCHEMES:
        names = [name for name in BITPAL_KERNELS if (name, *scheme) in specs]
        for n, m, S in BITPAL_GRID:
            qt = torch.from_numpy(random_codes(rng, (3, m), n_rate=0.03)).cuda()
            codes = torch.from_numpy(random_codes(rng, (S, n), n_rate=0.03)).cuda()
            paths = []
            for word_bits in (31, 32):
                eq = pack.pack_eq(codes, word_bits)
                W = eq.shape[1]
                for semi, factor in ((False, 1), (True, 2)):
                    kw = dict(match=scheme[0], mismatch=scheme[1], gap=scheme[2], read_len=n,
                              factor=factor, semi_global=semi, word_bits=word_bits)
                    for name in names:
                        err, _, _ = bitpal_compare(name, eq, qt, **kw)
                        check(err == 0, f"{name} {scheme} kernel != plain at n={n} S={S} "
                                        f"word_bits={word_bits} semi={semi}")
                        max_err[name] = max(max_err[name], err)
                for name in names:
                    reg_words = build.load_scheme(name, *scheme).reg_words
                    paths.append(f"{name}/{word_bits} W={W} "
                                 f"{'registers' if W <= reg_words else 'scratch'}")
            print(f"  {scheme} n={n:4d} m={m:2d} S={S:4d}, both modes: {'; '.join(paths)}: "
                  "max |diff| 0")
    return max_err


def phase_bitpal_bench(rng, smi):
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.ops import build

    print(f"== phase 10: BitPAl kernel and plain times, (2,-3,-5) ({smi})")
    results = {}
    routes = (("bitpal_packed", 31), ("bitpal", 32))
    for label, Q, m, S, n in BITPAL_TIMED:
        cells = Q * m * S * n
        seed = int(rng.integers(1 << 30))  # the same subjects in both word layouts
        eqs = {wb: device_eq(np.random.default_rng(seed), S, n, wb) for wb in (31, 32)}
        qt = torch.from_numpy(random_codes(rng, (Q, m))).cuda()
        print(f"  {label}: Q={Q} m={m} S={S} n={n} (device unpack and pack_eq equal "
              "the host packers)")
        for semi in ((False,) if label == BITPAL_TIMED[0][0] else (False, True)):
            for name, wb in routes:
                fn = bitpal_fns(name)[0]
                kw = dict(match=2, mismatch=-3, gap=-5, read_len=n, semi_global=semi,
                          word_bits=wb)
                err, _, plain_ms = bitpal_compare(name, eqs[wb], qt, **kw)
                check(err == 0, f"{name} kernel != plain at the {label}")
                kernel_ms = statistics.median(
                    cuda_times_ms(lambda: fn(eqs[wb], qt, **kw), runs=10, warmup=2))
                print(f"    {name:13s} {wb}-bit {'semi-global' if semi else 'global'}: kernel "
                      f"median {kernel_ms:.4f} ms over 10 runs = {cells / kernel_ms / 1e6:.1f} "
                      f"GCUPS; plain torch {plain_ms:.1f} ms (one run); max |diff| {err} ({smi})")
                if label == BITPAL_TIMED[0][0]:
                    lib = build.load_scheme(name, 2, -3, -5)
                    W = eqs[wb].shape[1]
                    scratch = W > lib.reg_words  # the scratch instance (W = 0) loops W words
                    results[name] = (err, kernel_ms, plain_ms, Work(
                        lib.path, {"bits": wb, "W": 0 if scratch else W}, Q * m * S,
                        roofline.io_bytes(eqs[wb], qt) + 4 * Q * S,
                        roofline.word_kernel_ops(name, Q, m, S, n), W if scratch else 0))
    return results


def phase_bitpal_golden(tmp):
    from bgsa_tpu_torch.io import result as result_io
    from bgsa_tpu_torch.pipeline import PipelineConfig
    from bgsa_tpu_torch.schemes import Scoring
    from bgsa_tpu_torch.pipeline import run_alignment

    print("== phase 11: the 500 bp BitPAl golden through bgsa_tpu_torch.pipeline.run_alignment")
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
    print(f"== phase 12: general scoring at production size through bgsa_tpu_torch.cli ({smi})")
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
# scratch switch above 32 words (992 bp), and ragged subject counts
MYERS31_GRID = [(n, 150, 3, 1000) for n in (1, 30, 31, 32, 61, 62, 63, 92, 93, 94, 150,
                                            500, 992, 993, 1500)]
MYERS31_GRID += [(150, 60, 2, 1), (500, 100, 3, 129), (62, 1100, 2, 777)]
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

    print("== phase 13: the 31-bit Myers kernel vs its plain version and the full-word "
          "kernel on the card (tolerance 0)")
    reg_words = build.load().lib.bgsa_myers_global_reg_words()
    max_err = 0
    for n, m, Q, S in MYERS31_GRID:
        queries = torch.from_numpy(random_codes(rng, (Q, m), n_rate=0.03)).cuda()
        codes = torch.from_numpy(random_codes(rng, (S, n), n_rate=0.03)).cuda()
        eq31, eq32 = pack.pack_eq(codes, 31), pack.pack_eq(codes, 32)
        for factor in (-1, 1):
            before = mp.LAUNCHES
            got = mp.myers_global(eq31, queries, read_len=n, factor=factor)
            torch.cuda.synchronize()
            check(mp.LAUNCHES == before + 1, "myers_global did not launch its kernel")
            want = mp.myers_global_ref(eq31, queries, read_len=n, factor=factor)
            full = ms.myers_semiglobal(eq32, queries, read_len=n, factor=factor, is_global=True)
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"myers_global kernel != plain at n={n} m={m} S={S}")
            check(torch.equal(got, full), f"myers_global != the full-word kernel at n={n}")
            max_err = max(max_err, err)
        W = eq31.shape[1]
        print(f"  n={n:5d} m={m:5d} Q={Q} S={S:5d} W={W:3d} "
              f"({'registers' if W <= reg_words else 'scratch'}), factor -1 and +1: "
              "max |diff| 0 against the plain version, equal to myers_semiglobal's global scores")
    return max_err


def phase_myers_global_bench(rng, smi):
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.ops import myers_pallas as mp
    from bgsa_tpu_torch.ops import myers_semiglobal as ms
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE

    print(f"== phase 14: 31-bit and full-word Myers times on the same subjects ({smi})")
    result = None
    for label, Q, m, S, n in MYERS31_TIMED:
        S = S or BUCKET_SIZE // (n + 1) // 128 * 128
        seed = int(rng.integers(1 << 30))  # the same subjects in both word layouts
        eq31 = device_eq(np.random.default_rng(seed), S, n, 31)
        eq32 = device_eq(np.random.default_rng(seed), S, n, 32)
        qt = torch.from_numpy(random_codes(rng, (Q, m))).cuda()
        cells = Q * m * S * n
        print(f"  {label}: Q={Q} m={m} S={S} n={n}, global")
        times = {}
        for name, fn, ref, eq in (
                ("myers_global", mp.myers_global, mp.myers_global_ref, eq31),
                ("myers_semiglobal", lambda e, q, **kw: ms.myers_semiglobal(e, q, is_global=True,
                                                                            **kw),
                 lambda e, q, **kw: ms.myers_semiglobal_ref(e, q, is_global=True, **kw), eq32)):
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
                    main_library(), {"W": eq31.shape[1]}, Q * m * S,
                    roofline.io_bytes(eq31, qt) + 4 * Q * S,
                    roofline.word_kernel_ops("myers_global", Q, m, S, n)))
        check(torch.equal(times["myers_global"], times["myers_semiglobal"]),
              f"the two layouts' scores differ at the {label}")
        print("    both kernels give the same scores")
    return result


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
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE, Engine, PipelineConfig, run_alignment
    from bgsa_tpu_torch.schemes import Scoring, normalize

    print(f"== phase 15: the device mesh and --shards on one card, cuda:0 repeated ({smi})")
    Q, n = 20, 150
    S = BUCKET_SIZE // (n + 1) // 128 * 128
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
    return launches


def phase_int_peak(smi):
    from bgsa_tpu_torch import roofline

    print(f"== phase 16: the int32 ALU issue peak ({smi})")
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


def kernel_bound(name, ms, work, sass, peak_ops_per_s):
    """(bound ms, "operations" or "bytes", pipe, instructions per column,
    JAX-op share) of one kernel row."""
    from bgsa_tpu_torch import roofline

    if work.library not in sass:
        text = roofline.sass_text(work.library)
        check(text is not None, "no cuobjdump: the kernels' SASS cannot be read")
        sass[work.library] = roofline.sass_functions(text)
    spec = roofline.SASS_SPECS[name]
    per_column = roofline.column_instructions(
        roofline.find_function(sass[work.library], spec.function.format(**work.shape)), spec,
        inner_trips=work.inner_trips)
    instructions, rate, pipe = roofline.instruction_bound(
        per_column, work.columns, roofline.sm_count(), roofline.sm_clock_mhz())
    bound_ms, bound_by = roofline.bound(instructions, work.nbytes, rate)
    check(bound_ms <= 1.05 * ms, f"{name}: bound {bound_ms:.4f} ms above its time {ms:.4f} ms")
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
    try:
        smi = phase_environment()
        max_err = phase_kernel_vs_plain(rng)
        bench_err, kernel_ms, plain_ms, myers_work = phase_bench(rng, smi)
        with tempfile.TemporaryDirectory(prefix="bgsa_smoke_") as tmp:
            phase_goldens(tmp)
            launches, inputs = phase_production(rng, tmp, smi)
            banded_err = phase_banded_kernels(rng)
            banded_times = phase_banded_bench(rng, smi)
            banded_launched, production_err = phase_banded_production(rng, tmp, smi)
            bitpal_err = phase_bitpal_kernels(rng)
            bitpal_times = phase_bitpal_bench(rng, smi)
            phase_bitpal_golden(tmp)
            bitpal_launched, bitpal_production_err = phase_bitpal_production(
                rng, tmp, smi, inputs)
            global_err = phase_myers_global_kernel(rng)
            global_times = phase_myers_global_bench(rng, smi)
            global_launched = phase_mesh_and_shards(rng, tmp, smi, inputs[2])
        peak, peak_err, peak_launched, peak_plain, peak_work = phase_int_peak(smi)
        check("jax" not in sys.modules, "jax was imported")
        check(not any(m == "bgsa_tpu" or m.startswith("bgsa_tpu.") for m in sys.modules),
              "a bgsa_tpu module was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    # (name, source, replaces, launches on its path, max |diff|, ms, plain ms, Work)
    rows = [("myers_semiglobal", KERNEL_SOURCE, KERNEL_REPLACES, launches,
             max(max_err, bench_err), kernel_ms, plain_ms, myers_work)]
    for name, (source, replaces) in BANDED_KERNELS.items():
        err, ms, plain, work = banded_times[name]
        rows.append((name, source, replaces, banded_launched[name],
                     max(err, banded_err[name], production_err[name]), ms, plain, work))
    for name, (source, replaces) in BITPAL_KERNELS.items():
        err, ms, plain, work = bitpal_times[name]
        rows.append((name, source, replaces, bitpal_launched[name],
                     max(err, bitpal_err[name], bitpal_production_err[name]), ms, plain, work))
    err, ms, plain, work = global_times
    rows.append(("myers_global", *MYERS_GLOBAL, global_launched, max(err, global_err), ms, plain,
                 work))
    rows.append(("int_peak", *INT_PEAK, peak_launched, peak_err, peak["ms"], peak_plain,
                 peak_work))
    print("== bounds: each kernel's SASS per column at the slowest pipe's rate, or its bytes")
    kernels, sass = [], {}
    try:
        for name, source, replaces, launched, err, ms, plain, work in rows:
            bound_ms, bound_by, pipe, per_column, jax_share = kernel_bound(
                name, ms, work, sass, peak["ops_per_s"])
            kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                            "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
            print(f"  {name:21s} {ms:10.4f} ms, bound {bound_ms:10.4f} ms by {bound_by} "
                  f"({pipe} pipe; {100 * bound_ms / ms:.1f} % of the time); SASS per column "
                  f"{per_column['alu']:.1f} ALU, {per_column['fma']:.1f} FMA, "
                  f"{per_column['issue']:.1f} issued; vs JAX-op count at the peak mix's rate "
                  f"{100 * jax_share:.1f} %; launches {launched}")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
