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
   numpy oracle, and the same in semi-global mode on a 100,000-subject slice.

The second-to-last line is a JSON object describing each kernel of the
path; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import os
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


class SmokeFailure(Exception):
    pass


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
    kernels = build.load()
    print(f"kernel library built from {KERNEL_SOURCE}: nvcc {kernels.build_seconds:.2f} s, "
          f"build+load {time.perf_counter() - t0:.2f} s -> {os.path.relpath(kernels.path, REPO)}")
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
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


def device_eq(rng, S, n):
    """Subjects through the main path's device stages (host transport packing,
    device unpack and Eq packing), checked against bgsa_tpu.pack's host versions."""
    from bgsa_tpu import pack as host_pack
    from bgsa_tpu_torch import pack

    subjects = random_codes(rng, (S, n))
    transport, payload = host_pack.select_transport(subjects)
    codes = pack.transport_unpack(transport)(torch.from_numpy(payload).cuda(), n)
    check(torch.equal(codes.cpu(), torch.from_numpy(subjects)), "device transport unpack")
    eq = pack.pack_eq(codes, 32)
    check(torch.equal(eq.cpu(), pack.eq_from_numpy(host_pack.pack_eq(subjects, 32))),
          "device pack_eq != bgsa_tpu.pack.pack_eq")
    return eq


def phase_bench(rng, smi):
    from bgsa_tpu.pipeline import TPU_BUCKET_SIZE

    print(f"== phase 3: kernel and plain times ({smi})")
    Q, m, S, n = 40, 500, 32768, 500  # the JAX bench's Myers line
    eq = device_eq(rng, S, n)
    qt = torch.from_numpy(random_codes(rng, (Q, m))).cuda()
    print("  bench geometry (device unpack and pack_eq equal bgsa_tpu.pack's host versions):")
    bench = time_kernel_and_plain(eq, qt, read_len=n, is_global=True, smi=smi)

    # one full bucket of the production run: 150 bp lines, default bucket size
    n = m = 150
    S = TPU_BUCKET_SIZE // (n + 1) // 128 * 128
    eq = device_eq(rng, S, n)
    qt = torch.from_numpy(random_codes(rng, (20, m))).cuda()
    print("  the production run's bucket shape:")
    errs = [time_kernel_and_plain(eq, qt, read_len=n, is_global=g, smi=smi)[0]
            for g in (True, False)]
    return max(bench[0], *errs), bench[1], bench[2]


def phase_goldens(tmp):
    from bgsa_tpu.io import result as result_io
    from bgsa_tpu.pipeline import PipelineConfig
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


def sampled_scores(result_path, q_idx, s_idx, n_queries):
    """Scores of (query, subject) pairs read from a one-device result file
    with one query bucket (n_queries <= 100)."""
    from bgsa_tpu.io import result as result_io

    info = result_io.read_info(result_path + ".info")
    check(info.device_num == 1 and info.ref_count == n_queries <= 100, "result layout")
    counts = np.array([c[0] for c in info.device_read_counts], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    offsets = np.concatenate([[0], np.cumsum(n_queries * counts)])
    data = np.memmap(result_path, dtype=np.int16, mode="r")
    b = np.searchsorted(starts, s_idx, side="right") - 1
    return np.asarray(data[offsets[b] + q_idx * counts[b] + (s_idx - starts[b])])


def check_against_oracle(rng, qp, sp, res, mode, n_subjects):
    from bgsa_tpu import oracle
    from bgsa_tpu.io import seqfile
    from bgsa_tpu.pack import encode_ascii

    queries = seqfile.read_queries(qp)
    q_idx = rng.integers(0, len(queries), N_SAMPLES)
    s_idx = rng.integers(0, n_subjects, N_SAMPLES)
    got = sampled_scores(res, q_idx, s_idx, len(queries))
    length = queries.shape[1]
    lines = np.memmap(sp, dtype=np.uint8, mode="r").reshape(-1, length + 1)
    want = np.empty(N_SAMPLES, np.int64)
    for qi in np.unique(q_idx):
        sel = np.nonzero(q_idx == qi)[0]
        subjects = encode_ascii(np.asarray(lines[s_idx[sel], :length]))
        want[sel] = -oracle.edit_distances(queries[qi], subjects, mode)
    bad = int(np.count_nonzero(got != want))
    check(bad == 0, f"{bad} of {N_SAMPLES} sampled scores differ from the oracle ({mode.value})")
    print(f"  {N_SAMPLES} sampled (query, subject) scores equal bgsa_tpu.oracle ({mode.value})")


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
    from bgsa_tpu.schemes import Mode
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
    return launches


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
        bench_err, kernel_ms, plain_ms = phase_bench(rng, smi)
        with tempfile.TemporaryDirectory(prefix="bgsa_smoke_") as tmp:
            phase_goldens(tmp)
            launches = phase_production(rng, tmp, smi)
        check("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "myers_semiglobal",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(max_err, bench_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
