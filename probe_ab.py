"""A/B of two checkouts on one GPU: the kernels a change redesigned.

    python3 probe_ab.py OTHER_CHECKOUT [PART,...]

Run from the root of this checkout on a machine with a CUDA GPU;
OTHER_CHECKOUT is another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. The two trees run in turns, other / this / this /
other, each turn a child process started in its tree, so each builds and
imports its own ``bgsa_tpu_torch``. PART names what a turn runs
(``bitpal``, ``cli``, ``banded``, ``generic``, ``stream``, ``myers_long``,
``peq``, ``pair``, ``myers``, ``strips``; default all ten). A turn prints:

- the registers, stack and shared memory of every ``banded_packed_kernel``
  instance in the tree's main kernel library, (``stream``) of every
  ``banded_stream_kernel`` instance, and (``bitpal``) of every kernel in
  its (2,-3,-5) non-packed BitPAl library, from ``cuobjdump -res-usage``
  (it reads the library itself, so a cached one too);
- ``bitpal``: the BitPAl kernels timed by CUDA events (median of 5 after a warm-up) on
  the same subjects in both trees: (2,-3,-5) non-packed with 32-bit words
  at the JAX bench's line (Q=40, m=500, S=32768, 500 bp) and at 1,100 bp
  (S=8192), and packed with 31-bit words at the bench line (its register
  path);
- ``cli``: ``-k 8`` over 1,000,000 x 150 bp filter-mix subjects through
  the CLI (``probe_banded.cli_runs``: three runs' RunStats, then one
  profiled);
- ``banded``: the packed banded kernel timed by CUDA events (median of 20
  after 3 warm-ups), and its device time (20 launches captured in a CUDA
  graph, each of 5 replays timed by CUDA events), on the filter mix
  (``chip_smoke.banded_inputs``) at the banded bench line with 150 bp
  queries and subjects at k = 10, 8, 6, 5 and 4 (2 to 6 fields a
  register), and at one production bucket at k = 8 against 158 bp subjects
  (two fields) and 150 bp ones (three);
- ``generic``: the same for the generic instance (n_sub >= 7, the field
  count a runtime argument) at the bench line's Q and S: n_sub 7 (150 bp
  queries, 151 bp subjects, k = 3), 8 (100 bp, k = 3) and 16 (7 bp, k =
  1); and at the bucket's, n_sub 7 and 8;
- ``stream``: the stream and dual banded kernels, timed as ``banded`` on
  the filter mix at the bench line's and the bucket's Q and S: both at the
  bench line's geometry (150 bp, k = 8), the stream kernel at its own
  (150 bp queries, 150 and 181 bp subjects, k = 16: band_down 32 and 63)
  and the dual kernel at its own (150 vs 148 bp, k = 8; 100 vs 95 bp,
  k = 20);
- ``myers_long``: the registers, stack and shared memory of every Myers
  kernel (both layouts), then both Myers kernels past their register bound
  (full-word ``myers_semiglobal``, 31-bit ``myers_global``) timed by CUDA
  events (median of 3 after a warm-up; every shape runs well over 0.2 ms)
  on the same subjects (A but for each one's own share of C, G and T,
  log-uniform from 0.0003 to 0.75, so that the scores spread), with
  output checksums, at ``MYERS_LONG``: Q=20
  queries of 1,000 bp against one database bucket of 5, 10, 20 and 40 kbp
  subjects (the subject count ``io.seqfile.DatabaseReader`` cuts from
  ``pipeline.BUCKET_SIZE``: 5,632, 2,816, 1,408 and 640), global, the
  5 kbp bucket also semi-global (full-word only), and the card-filling
  shape (Q=40, m=500, S=32,768, 5 kbp subjects: Eq beyond L2); then
  ``bgsa-torch-align`` twice over 20 x 5,000 bp queries and 20,000 x
  5,000 bp subjects (``scripts/make_testdata.py``'s generator, seed 1:
  four buckets), each run's RunStats, kernel launches and result
  checksum;
- ``peq``: the registers, stack and shared memory of every
  ``banded_peq_kernel`` instance, then the Peq-carry kernel timed as
  ``banded`` on the filter mix at the banded bench line (Q=8, S=65,280, 150
  bp, k = 8), one 150 bp bucket (Q=20, S=190,080), one bucket of its route
  (Q=20, 55 bp queries against 1,367,296 x 20 bp subjects, k = 40: the
  subject count ``io.seqfile.DatabaseReader`` cuts from
  ``pipeline.BUCKET_SIZE``) and the route's longest query (Q=20, 63 bp
  against one bucket of 897,280 x 31 bp, k = 32), each with its bound from
  the tree's own SASS per column (``roofline.column_instructions``) for the
  live (pair, column) pairs the reference's checkpoints leave, at the
  slowest pipe's rate;
- ``pair``: the registers, stack and shared memory of every paired-query
  kernel and every ``banded_stream_kernel`` instance, then each pair
  kernel beside the kernel it pairs (``banded_stream_pair`` and
  ``banded_stream``, ``banded_packed_pair`` and ``banded_stream_packed``)
  on the same inputs, timed as ``peq``, with output checksums, the tree's
  own SASS per column and bound for the thread-columns the reference's
  checkpoints leave (a pair thread runs until both its queries are over
  budget), and the warps an SM holds of each (computed from the registers
  and the dynamic shared memory the tree's launcher gives it, at sm_90's
  limits), then the pair's device time over the single kernel's: at the
  experiments' own shapes (stream: ``filter_mix_dataset`` rng 7, Q=8,
  S=65,536, 150 bp, k = 8; packed: rng 13, Q=8, S=65,280, n_sub 3) and at
  one 150 bp bucket (Q=20, S=190,080, k = 8, the filter mix): the stream
  pair at 150 bp subjects, the packed pair at 150 bp (n_sub 3) and 158 bp
  (n_sub 2);
- ``myers``: the full-word Myers register kernel (``myers_regs``), global,
  on the same random subjects and queries in both trees (3 % N), at the
  shapes of the benchmark's Myers cells: the 960 bp cell's full bucket
  (Q=200, m=960, S=29,824, W=30) and its tail (S=10,528), and the 150 bp
  cell's bucket (Q=20, m=150, S=190,080, W=5). For each: the instance that
  ran (the tree's smallest ``myers_regs<N>`` with N >= W), its registers
  and shared memory (``cuobjdump -res-usage``), its column loop's SASS per
  pipe (``roofline.column_instructions``, a column and a word-column of
  the instance), the kernel timed by CUDA events (median of 5 after a
  warm-up; each run is one launch of 3.7 ms or more), its GCUPS, and the
  output checksum;
- ``strips``: both schedules of the full-word Myers strips past the
  register bound, each launched through the C entry point on its own
  (``myers_strips``, one warp a group of 32 subjects, and
  ``myers_strips_wave``, the wavefront), global, on skewed subjects (as
  ``myers_long``) and random queries: for each kernel its registers, static
  shared memory, the blocks an SM holds (``resident_warps``, the
  wavefront's 98,304 B of dynamic shared memory added), its column loop's
  SASS per word-column (``roofline.column_instructions``: the cheapest
  loop, a full strip's) and a digest of its SASS opcodes and operands, so
  that an unchanged kernel reads the same in both trees; then the one-warp
  strips at ``STRIP_ROW`` (Q=20, m=64, S=5,632, 5 kbp) and at the 5 kbp
  cell's full bucket and tail (Q=20, m=5,000, S=5,632 and 3,200, 5 kbp),
  and both schedules at Q=20 queries of 1,000 bp against one bucket of 5,
  10, 20 and 40 kbp subjects (as ``myers_long``): CUDA-event medians of 5
  after a warm-up, GCUPS, the frozen floor (11 ALU ops a word-column and 2
  a column at 64 a clock an SM, every SM at its maximum clock) and its
  share of the time, output checksums.

Exits with the first failing turn's code.
"""

import os
import subprocess
import sys

TURN = r"""
import os, re, statistics, subprocess, sys
import numpy as np
import torch
from torch.utils.cpp_extension import CUDA_HOME
sys.path.insert(0, ".")
import chip_smoke
from bgsa_tpu_torch.banded_pipeline import BandedEngine
from bgsa_tpu_torch.ops import banded as bo
from bgsa_tpu_torch.ops import banded_packed as bpk
from bgsa_tpu_torch.ops import bitpal as tb
from bgsa_tpu_torch.ops import bitpal_packed as tbp
from bgsa_tpu_torch.ops import build
parts = sys.argv[2].split(",")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
libs = [(build.load().path, "banded_packed_kernel")]
if "stream" in parts:
    libs.append((build.load().path, "banded_stream_kernel"))
if "bitpal" in parts:
    libs.append((build.load_scheme("bitpal", 2, -3, -5).path, "kernel"))
if "myers_long" in parts:
    libs += [(build.load().path, "myers"), (build.load().path, "global31")]
if "peq" in parts:
    libs.append((build.load().path, "banded_peq_kernel"))
if "pair" in parts:
    libs += [(build.load().path, "banded_stream_kernel"), (build.load().path, "pair_kernel")]
if "myers" in parts:
    libs.append((build.load().path, "myers_regs"))
if "strips" in parts:
    libs.append((build.load().path, "myers_strips"))
registers = {}  # mangled name -> registers, from the main library's res-usage
shared = {}  # mangled name -> static shared memory bytes, the same
for path, pattern in libs:
    usage = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-res-usage", path],
                           capture_output=True, text=True, check=True).stdout
    print(f"{sys.argv[1]}: cuobjdump -res-usage of {os.path.basename(path)}")
    for name, res in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", usage):
        if path == build.load().path:
            registers[name] = int(re.search(r"REG:(\d+)", res).group(1))
            shared[name] = int(re.search(r"SHARED:(\d+)", res).group(1))
        if pattern in name:
            print(f"  {name}: {res.strip()}")
for label, fn, Q, m, S, n, wb in (
        ("non-packed, bench line", tb.bitpal, 40, 500, 32768, 500, 32),
        ("non-packed, 1,100 bp", tb.bitpal, 40, 500, 8192, 1100, 32),
        ("packed, bench line", tbp.bitpal_packed, 40, 500, 32768, 500, 31)) * ("bitpal" in parts):
    rng = np.random.default_rng(7)
    qt = torch.from_numpy(rng.integers(0, 4, size=(Q, m)).astype(np.int32)).cuda()
    eq = chip_smoke.device_eq(rng, S, n, wb)
    kw = dict(match=2, mismatch=-3, gap=-5, read_len=n, word_bits=wb)
    out = fn(eq, qt, **kw)
    ms = chip_smoke.cuda_times_ms(lambda: fn(eq, qt, **kw), runs=5, warmup=1)
    print(f"  BitPAl (2,-3,-5) {label}: Q={Q} m={m} S={S} n={n} {wb}-bit W={eq.shape[1]}: "
          f"kernel median {statistics.median(ms):.4f} ms of 5 ({min(ms):.4f}-{max(ms):.4f}); "
          f"output checksum {int(out.long().sum())} ({smi})")
if "cli" in parts:
    import tempfile
    import probe_banded
    with tempfile.TemporaryDirectory(prefix="bgsa_ab_") as tmp:
        probe_banded.cli_runs(tmp)
# (label, Q, m, n, S or None for a bucket's count, modes: True = global)
MYERS_LONG = (("5 kbp bucket", 20, 1000, 5000, None, (True, False)),
              ("10 kbp bucket", 20, 1000, 10000, None, (True,)),
              ("20 kbp bucket", 20, 1000, 20000, None, (True,)),
              ("40 kbp bucket", 20, 1000, 40000, None, (True,)),
              ("card-filling", 40, 500, 5000, 32768, (True,)))
if "myers_long" in parts:
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.ops import myers_pallas as mp
    from bgsa_tpu_torch.ops import myers_semiglobal as ms
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE
    for label, Q, m, n, S, modes in MYERS_LONG:
        S = S or BUCKET_SIZE // (n + 1) // 128 * 128
        # the same subjects in both trees and layouts: A but for each
        # subject's own share of C, G and T, log-uniform from 0.0003 to 0.75
        # (chip_smoke.skewed_subjects), so that a query is seldom a
        # subsequence of a strip and the scores spread above n - m
        lrng = np.random.default_rng(n + S)
        miss = np.exp(lrng.uniform(np.log(3e-4), np.log(0.75), size=(S, 1))).astype(np.float32)
        codes = np.where(lrng.random((S, n), dtype=np.float32) < miss,
                         lrng.integers(1, 4, size=(S, n), dtype=np.int8), np.int8(0))
        codes = torch.from_numpy(codes).cuda()
        qt = torch.from_numpy(lrng.integers(0, 4, size=(Q, m)).astype(np.int32)).cuda()
        runs = [("myers_semiglobal", g, pack.pack_eq(codes, 32)) for g in modes]
        runs.append(("myers_global", True, pack.pack_eq(codes, 31)))
        del codes
        for name, is_global, eq in runs:
            if name == "myers_global":
                run = lambda: mp.myers_global(eq, qt, read_len=n)
            else:
                run = lambda: ms.myers_semiglobal(eq, qt, read_len=n, is_global=is_global)
            checksum = int(run().long().sum())
            t = chip_smoke.cuda_times_ms(run, runs=3, warmup=1)
            print(f"  {name} {'global' if is_global else 'semi-global'}, {label}: Q={Q} m={m} "
                  f"S={S} n={n} W={eq.shape[1]}: kernel median {statistics.median(t):.4f} ms of "
                  f"3 ({min(t):.4f}-{max(t):.4f}); output checksum {checksum} ({smi})", flush=True)
        del runs
    import importlib.util, tempfile
    from bgsa_tpu_torch import cli
    spec = importlib.util.spec_from_file_location("make_testdata", "scripts/make_testdata.py")
    make_testdata = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_testdata)
    with tempfile.TemporaryDirectory(prefix="bgsa_ab_") as tmp:
        data_rng = np.random.default_rng(1)  # scripts/make_testdata.py's seed and order
        qp, sp = os.path.join(tmp, "q.txt"), os.path.join(tmp, "s.txt")
        make_testdata.write_lines(qp, 20, 5000, data_rng)
        make_testdata.write_lines(sp, 20000, 5000, data_rng)
        res, stats = os.path.join(tmp, "r.bin"), os.path.join(tmp, "stats.json")
        for i in range(2):
            before = ms.LAUNCHES
            rc = cli.align_main(["-q", qp, "-d", sp, "-f", res, "--stats-json", stats, "--quiet"])
            checksum = int(np.fromfile(res, dtype=np.int16).astype(np.int64).sum())
            print(f"  bgsa-torch-align, 20 x 5,000 bp vs 20,000 x 5,000 bp, run {i}: exit {rc}, "
                  f"myers_semiglobal launches {ms.LAUNCHES - before}, result checksum "
                  f"{checksum} ({smi})")
            chip_smoke.print_stats(stats)
rng = np.random.default_rng(2026)
lines = []  # (label, Q, S, [(m, n, k), ...])
for label, Q, S in chip_smoke.BANDED_TIMED * ("banded" in parts):
    # n_sub 2..6 at the bench line (150 bp, k = 10, 8, 6, 5, 4); at the
    # bucket two fields (158 bp) and three
    lines.append((label, Q, S, [(150, 150, k) for k in (10, 8, 6, 5, 4)]
                  if label == chip_smoke.BANDED_TIMED[0][0] else [(150, 158, 8), (150, 150, 8)]))
if "generic" in parts:  # n_sub 7, 8 and 16
    label, Q, S = chip_smoke.BANDED_TIMED[0]
    lines.append((label, Q, S, [(150, 151, 3), (100, 100, 3), (7, 7, 1)]))
    label, Q, S = chip_smoke.BANDED_TIMED[1]
    lines.append((label, Q, S, [(150, 151, 3), (100, 100, 3)]))
def device_ms(run):
    # median, min and max device ms of one run(): 20 launches captured in a
    # CUDA graph, each of 5 replays timed by CUDA events
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            run()
    dev = [t / 20 for t in chip_smoke.cuda_times_ms(graph.replay, runs=5, warmup=1)]
    return statistics.median(dev), min(dev), max(dev)
for label, Q, S in chip_smoke.BANDED_TIMED * ("stream" in parts):
    # the banded bench line's geometry (both kernels take it), then each
    # route's own: stream at band_down 32 and 63, dual at 148 and 95 bp
    for name, (m, n, k) in (("banded_stream", (150, 150, 8)), ("banded_stream_dual", (150, 150, 8)),
                            ("banded_stream", (150, 150, 16)), ("banded_stream", (150, 181, 16)),
                            ("banded_stream_dual", (150, 148, 8)),
                            ("banded_stream_dual", (100, 95, 20))):
        engine = BandedEngine(k, device="cuda")
        q, s = chip_smoke.banded_inputs(rng, Q, m, S, n, k, "mix")
        codes, qt = torch.from_numpy(s).cuda(), torch.from_numpy(q).cuda()
        args = engine.kernel_args(name, codes, m)
        fn = getattr(bo, name)
        kw = dict(q_len=m, s_len=n, k=k)
        run = lambda: fn(*args, qt, **kw)
        checksum = int(run().long().sum())
        ms = statistics.median(chip_smoke.cuda_times_ms(run, runs=20, warmup=3))
        dev, lo, hi = device_ms(run)
        print(f"  {name}, {label}: Q={Q} S={S} m={m} n={n} k={k}: kernel median {ms:.4f} ms over "
              f"20 runs; device time {dev:.4f} ms ({lo:.4f}-{hi:.4f}; a CUDA graph of 20 "
              f"launches, 5 replays); output checksum {checksum} ({smi})")
def peq_live(args, qt, m, n, k):
    # live (pair, column) pairs before each column, as the reference's
    # checkpoints leave them, over the planes the reference carries (here,
    # not banded_ref(live=): the turn runs in trees whose banded_ref takes
    # no live)
    _, band_down, _ = bo.geometry(m, n, k)
    lo, hi, inj = args
    W = inj.shape[1]
    injw = inj.long() & bo.MASK32
    peq = [bo.words64(lo, hi)]
    def window_at(c, t):
        if t:
            peq[0] = bo.shr(peq[0], 1)
            if t - 1 < m - k:
                w, b = min((t - 1) // 32, W - 1), (t - 1) % 32
                peq[0] = peq[0] | (((injw[:, w] >> b) & 1) << band_down)
        return peq[0][c]
    live = []
    bo._scan(qt, lo.shape[-1], window_at, q_len=m, s_len=n, k=k, live=live)
    return sum(live)
if "peq" in parts:
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE
    functions = roofline.sass_functions(roofline.sass_text(build.load().path))
    spec = roofline.SASS_SPECS["banded"]
    for label, Q, m, n, k, S in (("bench line", 8, 150, 150, 8, 65280),
                                 ("150 bp bucket", 20, 150, 150, 8, None),
                                 ("route bucket", 20, 55, 20, 40, None),
                                 ("31 bp bucket", 20, 63, 31, 32, None)):
        S = S or BUCKET_SIZE // (n + 1) // 128 * 128
        q, s = chip_smoke.banded_inputs(rng, Q, m, S, n, k, "mix")
        codes, qt = torch.from_numpy(s).cuda(), torch.from_numpy(q).cuda()
        del s
        args = BandedEngine(k, device="cuda").kernel_args("banded", codes, m)
        del codes
        kw = dict(q_len=m, s_len=n, k=k)
        run = lambda: bo.banded(*args, qt, **kw)
        got = run()
        checksum = int(got.long().sum())
        ms = statistics.median(chip_smoke.cuda_times_ms(run, runs=20, warmup=3))
        dev, lo, hi = device_ms(run)
        wide = int(bo.geometry(m, n, k)[1] >= 32)
        per = roofline.column_instructions(
            roofline.find_function(functions, spec.function.format(wide=wide)), spec)
        live = peq_live(args, qt, m, n, k)
        ins, rate, pipe = roofline.instruction_bound(per, live, roofline.sm_count(),
                                                     roofline.sm_clock_mhz())
        bound_ms, by = roofline.bound(ins, roofline.io_bytes(*args, qt, got), rate)
        print(f"  Peq-carry, {label}: Q={Q} S={S} m={m} n={n} k={k}: kernel median {ms:.4f} ms "
              f"over 20 runs; device time {dev:.4f} ms ({lo:.4f}-{hi:.4f}; a CUDA graph of 20 "
              f"launches, 5 replays); SASS per column {per['alu']:.2f} ALU, {per['issue']:.2f} "
              f"issued; live (pair, column) pairs {live} of {Q * S * m}; bound {bound_ms:.4f} ms "
              f"by {by} ({pipe}), {100 * bound_ms / dev:.1f} % of the device time; over budget "
              f"{float((got == 127).float().mean()):.3f}; output checksum {checksum} ({smi})",
              flush=True)
        del args, got
def resident_warps(regs, smem):
    # warps an SM holds of a 128-thread kernel (4 warps a block) on sm_90:
    # 65,536 registers an SM, allocated to a warp 256 at a time (a thread's
    # count rounded up to 8); 228 KB of shared memory an SM, 1 KB of it
    # reserved a block; at most 32 blocks and 64 warps an SM
    by_regs = 65536 // (32 * (-(-regs // 8) * 8)) // 4
    by_smem = 228 * 1024 // (smem + 1024)
    return 4 * min(by_regs, by_smem, 16)
def dynamic_smem(name, m, n_sub, wide):
    # the dynamic shared memory the tree's launcher gives the kernel: the
    # window slots, then the staged query rows (none in a tree whose pair
    # kernels read their codes from global memory a column)
    stream = name in ("banded_stream", "banded_stream_pair")
    slots = 6 * 128 * (16 if wide else 8) if stream else n_sub * 5 * 8 * 128
    if "pair" not in name:
        return slots + m
    source = "banded_pair.cu" if stream else "banded_packed_pair.cu"
    with open(os.path.join("bgsa_tpu_torch", "csrc", source)) as f:
        return slots + 2 * m if "pair_smem_bytes" in f.read() else 0
if "pair" in parts:
    from bgsa_tpu_torch import pack, roofline
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from bgsa_tpu_torch.ops import banded_packed_pair as bpp
    from bgsa_tpu_torch.ops import banded_pair as bpr
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE
    from bgsa_tpu_torch.scripts import exp_banded_packed_pair as packed_exp
    from bgsa_tpu_torch.scripts import exp_banded_pair as pair_exp
    functions = roofline.sass_functions(roofline.sass_text(build.load().path))
    def pair_line(label, route, m, n, k, codes, qt):
        # the pair and the kernel it pairs on the same inputs: CUDA events,
        # a CUDA graph's device time, the tree's own SASS per column and
        # bound for the thread-columns the reference's checkpoints leave,
        # the resident warps an SM, and output checksums; then pair / single
        kw = dict(q_len=m, s_len=n, k=k)
        wide = int(bo.geometry(m, n, k)[1] >= 32)
        n_sub = bpk.packed_subbands(m, n, k) if route == "packed" else 1
        stream = pack.pack_banded_stream(codes, k, m)
        if route == "packed":
            args = (BandedEngine(k, device="cuda").kernel_args("banded_stream_packed", codes, m)[0],)
            names = {"banded_stream_packed": bpk.banded_stream_packed,
                     "banded_packed_pair": bpp.banded_packed_pair}
        else:
            args = (stream,)
            names = {"banded_stream": bo.banded_stream, "banded_stream_pair": bpr.banded_stream_pair}
        dev = {}
        for name, fn in names.items():
            run = lambda: fn(*args, qt, **kw)
            got = run()
            checksum = int(got.long().sum())
            ms = statistics.median(chip_smoke.cuda_times_ms(run, runs=20, warmup=3))
            dev[name], lo, hi = device_ms(run)
            live = []
            threads = (bpr.pair_threads if name == "banded_stream_pair" else
                       bpp.packed_pair_threads(n_sub) if name == "banded_packed_pair" else None)
            bo.banded_stream_ref(stream, qt, live=live, threads=threads, **kw)
            columns = sum(live) / (n_sub if name == "banded_stream_packed" else 1)
            spec = roofline.SASS_SPECS[name]
            pattern = spec.function.format(wide=wide, n_sub=n_sub)
            per = roofline.column_instructions(roofline.find_function(functions, pattern), spec)
            ins, rate, pipe = roofline.instruction_bound(per, columns, roofline.sm_count(),
                                                         roofline.sm_clock_mhz())
            bound_ms, by = roofline.bound(ins, roofline.io_bytes(*args, qt, got), rate)
            regs = [r for fn_name, r in registers.items() if re.search(pattern, fn_name)]
            smem = dynamic_smem(name, m, n_sub, wide)
            print(f"  pair part, {label}: {name} Q={qt.shape[0]} S={codes.shape[0]} m={m} n={n} "
                  f"k={k} n_sub={n_sub}: kernel median {ms:.4f} ms over 20 runs; device time "
                  f"{dev[name]:.4f} ms ({lo:.4f}-{hi:.4f}; a CUDA graph of 20 launches, 5 "
                  f"replays); SASS per column {per['alu']:.2f} ALU, {per['issue']:.2f} issued; "
                  f"thread-columns {columns:.0f}; bound {bound_ms:.4f} ms by {by} ({pipe}), "
                  f"{100 * bound_ms / dev[name]:.1f} % of the device time; registers {regs}, "
                  f"dynamic shared memory {smem} B, resident warps an SM "
                  f"{resident_warps(max(regs), smem)}; over budget "
                  f"{float((got == 127).float().mean()):.3f}; output checksum {checksum} ({smi})",
                  flush=True)
        pair, single = [dev[name] for name in names][::-1]
        print(f"  pair part, {label}: {list(names)[1]} / {list(names)[0]} device time "
              f"{pair / single:.3f} ({smi})", flush=True)
    # the experiments' own shapes
    q, s = filter_mix_dataset(np.random.default_rng(pair_exp.SEED), pair_exp.QUERIES,
                              pair_exp.SUBJECTS, pair_exp.LENGTH)
    pair_line("stream experiment", "stream", pair_exp.LENGTH, pair_exp.LENGTH, pair_exp.K,
              torch.from_numpy(s.astype(np.int32)).cuda(), torch.from_numpy(q).cuda())
    q, s = packed_exp.inputs("mix")
    pair_line("packed experiment (mix)", "packed", packed_exp.LENGTH, packed_exp.LENGTH,
              packed_exp.K, torch.from_numpy(s).cuda(), torch.from_numpy(q).cuda())
    # one 150 bp bucket: stream at 150 bp, packed at 150 bp (n_sub 3) and
    # 158 bp subjects (n_sub 2)
    Q, S = 20, BUCKET_SIZE // 151 // 128 * 128
    for route, n in (("stream", 150), ("packed", 150), ("packed", 158)):
        q, s = chip_smoke.banded_inputs(rng, Q, 150, S, n, 8, "mix")
        pair_line(f"bucket, {n} bp", route, 150, n, 8, torch.from_numpy(s).cuda(),
                  torch.from_numpy(q).cuda())
if "myers" in parts:
    from bgsa_tpu_torch import pack, roofline
    from bgsa_tpu_torch.ops import myers_semiglobal as ms
    functions = roofline.sass_functions(roofline.sass_text(build.load().path))
    spec = roofline.SASS_SPECS["myers_semiglobal"]
    widths = sorted({int(w) for name in functions
                     for w in re.findall(r"myers_regsILi(\d+)E", name)})
    for label, Q, m, S, n in (("960 bp bucket", 200, 960, 29824, 960),
                              ("960 bp tail", 200, 960, 10528, 960),
                              ("150 bp bucket", 20, 150, 190080, 150)):
        mrng = np.random.default_rng(Q + m + S)
        eq = pack.pack_eq(torch.from_numpy(chip_smoke.random_codes(mrng, (S, n), 0.03)).cuda(), 32)
        qt = torch.from_numpy(chip_smoke.random_codes(mrng, (Q, m))).cuda()
        W = eq.shape[1]
        run = lambda: ms.myers_semiglobal(eq, qt, read_len=n, is_global=True)
        checksum = int(run().long().sum())
        t = chip_smoke.cuda_times_ms(run, runs=5, warmup=1)
        inst = min(w for w in widths if w >= W)
        pattern = spec.function.format(W=inst)
        name = [f for f in functions if re.search(pattern, f)][0]
        per = roofline.column_instructions(roofline.find_function(functions, pattern), spec)
        per_word = ", ".join(f"{per[p] / inst:.2f} {p}" for p in ("alu", "fma", "issue"))
        print(f"  myers part, {label}: Q={Q} m={m} S={S} n={n} W={W}: myers_regs<{inst}> "
              f"registers {registers[name]}, shared memory {shared[name]} B; SASS a column "
              f"{per['alu']:.0f} alu, {per['fma']:.0f} fma, {per['issue']:.0f} issue (a "
              f"word-column of the instance: {per_word}); kernel median "
              f"{statistics.median(t):.4f} ms of 5 ({min(t):.4f}-{max(t):.4f}) = "
              f"{Q * m * S * n / statistics.median(t) / 1e6:.1f} GCUPS; output checksum "
              f"{checksum} ({smi})", flush=True)
        del eq, qt
# (label, Q, m, n, S or None for a bucket's count, schedules: True = wavefront)
STRIPS = (("STRIP_ROW", 20, 64, 5000, 5632, (False,)),
          ("5 kbp cell bucket", 20, 5000, 5000, 5632, (False,)),
          ("5 kbp cell tail", 20, 5000, 5000, 3200, (False,)),
          ("5 kbp bucket", 20, 1000, 5000, None, (False, True)),
          ("10 kbp bucket", 20, 1000, 10000, None, (False, True)),
          ("20 kbp bucket", 20, 1000, 20000, None, (False, True)),
          ("40 kbp bucket", 20, 1000, 40000, None, (False, True)))
if "strips" in parts:
    import hashlib
    from bgsa_tpu_torch import pack, roofline
    from bgsa_tpu_torch.ops import myers_semiglobal as ms
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE
    functions = roofline.sass_functions(roofline.sass_text(build.load().path))
    kernels = build.load()
    for kernel, spec_name, dynamic in (("myers_strips", "myers_semiglobal_strips", 0),
                                       ("myers_strips_wave", "myers_semiglobal_wave", 98304)):
        spec = roofline.SASS_SPECS[spec_name]
        name = [f for f in functions if re.search(spec.function, f)][0]
        ins = functions[name]
        per = roofline.column_instructions(ins, spec)
        digest = hashlib.sha1(repr([x[1:] for x in ins]).encode()).hexdigest()[:12]
        smem = shared[name] + dynamic
        print(f"  strips part, {kernel}: registers {registers[name]}, shared memory {smem} B, "
              f"blocks an SM {resident_warps(registers[name], smem) // 4}; SASS a word-column "
              f"{per['alu']:.2f} alu, {per['fma']:.2f} fma, {per['issue']:.2f} issue; SASS "
              f"digest {digest} ({len(ins)} instructions)", flush=True)
    peak = 64 * roofline.sm_count() * roofline.sm_clock_mhz() * 1e6
    for label, Q, m, n, S, schedules in STRIPS:
        S = S or BUCKET_SIZE // (n + 1) // 128 * 128
        lrng = np.random.default_rng(n + S + m)
        miss = np.exp(lrng.uniform(np.log(3e-4), np.log(0.75), size=(S, 1))).astype(np.float32)
        codes = np.where(lrng.random((S, n), dtype=np.float32) < miss,
                         lrng.integers(1, 4, size=(S, n), dtype=np.int8), np.int8(0))
        eq = pack.pack_eq(torch.from_numpy(codes).cuda(), 32)
        del codes
        qt = torch.from_numpy(lrng.integers(0, 4, size=(Q, m)).astype(np.uint8)).cuda()
        W = eq.shape[1]
        out = torch.empty((Q, S), dtype=torch.int32, device="cuda")
        carries = torch.empty((2, ms.carry_words(m), Q, S), dtype=torch.int32, device="cuda")
        floor_ms = Q * m * S * (11 * W + 2) / peak * 1e3
        for wave in schedules:
            def run():
                rc = kernels.lib.bgsa_myers_semiglobal(
                    eq.data_ptr(), qt.data_ptr(), out.data_ptr(), carries.data_ptr(), Q, m, W, S,
                    n, -1, 1, int(wave), torch.cuda.current_stream().cuda_stream)
                kernels.check(rc, "myers_semiglobal")
            run()
            checksum = int(out.long().sum())
            t = chip_smoke.cuda_times_ms(run, runs=5, warmup=1)
            med = statistics.median(t)
            print(f"  strips part, {label}: {'myers_strips_wave' if wave else 'myers_strips'} "
                  f"Q={Q} m={m} S={S} n={n} W={W}: kernel median {med:.4f} ms of 5 "
                  f"({min(t):.4f}-{max(t):.4f}) = {Q * m * S * n / med / 1e6:.1f} GCUPS; floor "
                  f"{floor_ms:.4f} ms ({100 * floor_ms / med:.1f} %); output checksum {checksum} "
                  f"({smi})", flush=True)
        del eq, qt, out, carries
for label, Q, S, geometries in lines:
    for m, n, k in geometries:
        engine = BandedEngine(k, device="cuda")
        q, s = chip_smoke.banded_inputs(rng, Q, m, S, n, k, "mix")
        codes, qt = torch.from_numpy(s).cuda(), torch.from_numpy(q).cuda()
        args = engine.kernel_args("banded_stream_packed", codes, m)
        kw = dict(q_len=m, s_len=n, k=k)
        run = lambda: bpk.banded_stream_packed(*args, qt, **kw)
        checksum = int(run().long().sum())
        ms = statistics.median(chip_smoke.cuda_times_ms(run, runs=20, warmup=3))
        dev, lo, hi = device_ms(run)
        print(f"  packed banded, {label}: Q={Q} S={S} m={m} n={n} k={k} "
              f"n_sub={bpk.packed_subbands(m, n, k)}: kernel median {ms:.4f} ms over 20 runs; "
              f"device time {dev:.4f} ms ({lo:.4f}-{hi:.4f}; a CUDA graph of 20 launches, 5 "
              f"replays); output checksum {checksum} ({smi})")
"""


PARTS = ("bitpal", "cli", "banded", "generic", "stream", "myers_long", "peq", "pair", "myers",
         "strips")


def main(argv) -> int:
    parts = argv[1] if len(argv) == 2 else ",".join(PARTS)
    if (len(argv) not in (1, 2) or not os.path.isfile(os.path.join(argv[0], "chip_smoke.py"))
            or not set(parts.split(",")) <= set(PARTS)):
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(argv[0])
    rc = 0
    for label, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        print(f"== {label}: {tree}", flush=True)
        code = subprocess.run([sys.executable, "-c", TURN, label, parts], cwd=tree).returncode
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
