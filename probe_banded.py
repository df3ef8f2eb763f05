"""On-chip probe of the banded filter's costs, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 probe_banded.py

It prints the card's name and power limit (nvidia-smi), then:

1. build: the nvcc time of the kernel library as ``ops.build`` builds it
   (one nvcc per source, all started together, then a link) against one
   nvcc over all sources, in the order parallel, single, single, parallel,
   each into a fresh directory;
2. the packed kernel's unrolled instantiations against its generic one
   (``banded_packed_kernel<0>``, which takes any n_sub; built from a copy of
   the sources whose dispatch sends every n_sub there): CUDA-event medians
   of 20 runs each, in the order unrolled, generic, generic, unrolled, at
   Q=8, S=65,280, 150 bp filter mix, for n_sub 2..6 (k = 10, 8, 6, 5, 4);
3. ``-k 8`` with 20 x 150 bp queries against 1,000,000 x 150 bp filter-mix
   subjects (seed 1) through ``bgsa_tpu_torch.cli``: the RunStats of three
   runs, then one run under ``torch.profiler``: its wall time, the device
   time summed over the CUDA kernel and copy events, and the largest of
   them by name;
4. one full bucket (190,080 x 150 bp, 2-bit transport, 20 queries) through
   the engine's device stages, CUDA-event medians of 10: upload from pinned
   memory, unpack, stream packing, kernel, int8 narrowing.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def build_times(tmp):
    from bgsa_tpu_torch.ops import build

    sources = [os.path.join(build.CSRC_DIR, s) for s in build.SOURCES]
    nvcc = build.nvcc_path()

    def parallel(out):
        return build.compile_library(sources, out)[2]

    def single(out):
        os.makedirs(out)
        t0 = time.perf_counter()
        subprocess.run([nvcc, *build.COMPILE_FLAGS, "-shared", "-o",
                        os.path.join(out, "lib.so"), *sources], check=True, capture_output=True)
        return time.perf_counter() - t0

    print("== 1: nvcc time of the kernel library")
    for i, (label, fn) in enumerate((("parallel", parallel), ("single", single),
                                     ("single", single), ("parallel", parallel))):
        print(f"  {label:8s} {fn(os.path.join(tmp, f'build{i}')):.2f} s")


def generic_kernels(tmp):
    """The kernel library built from a copy of the sources whose packed
    dispatch sends every n_sub to the generic instantiation."""
    from bgsa_tpu_torch.ops import build

    src = os.path.join(tmp, "csrc")
    shutil.copytree(build.CSRC_DIR, src)
    path = os.path.join(src, "banded_packed.cu")
    with open(path) as f:
        text, n = re.subn(r"switch \(n_sub\) \{.*?\n  \}\n", "return BGSA_PACKED_LAUNCH(0);\n",
                          f.read(), flags=re.S)
    if n != 1:
        raise RuntimeError("banded_packed.cu: no n_sub dispatch switch to replace")
    with open(path, "w") as f:
        f.write(text)
    lib_path, _, _ = build.compile_library([os.path.join(src, s) for s in build.SOURCES],
                                           os.path.join(tmp, "generic"))
    lib = ctypes.CDLL(lib_path)
    build._declare(lib, build._SIGNATURES)
    return build.Kernels(lib, lib_path, "", 0.0, lib.bgsa_reg_words())


def packed_instantiations(tmp, rng):
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from bgsa_tpu_torch.banded_pipeline import BandedEngine
    from bgsa_tpu_torch.ops import banded_packed as bp
    from bgsa_tpu_torch.ops import build
    from chip_smoke import cuda_times_ms

    print("== 2: packed kernel, unrolled n_sub against the generic instantiation")
    unrolled, generic = build.load(), generic_kernels(tmp)
    Q, S, n = 8, 65280, 150
    q, s = filter_mix_dataset(rng, Q, S, n)
    codes = torch.from_numpy(s.astype(np.int32)).cuda()
    qt = torch.from_numpy(q).cuda()
    for k in (10, 8, 6, 5, 4):
        kw = dict(q_len=n, s_len=n, k=k)
        (streams,) = BandedEngine(k).kernel_args("banded_stream_packed", codes, n)
        times, outs = collections.defaultdict(list), {}
        for label in ("unrolled", "generic", "generic", "unrolled"):
            build._kernels = unrolled if label == "unrolled" else generic
            outs[label] = bp.banded_stream_packed(streams, qt, **kw)
            times[label] += cuda_times_ms(lambda: bp.banded_stream_packed(streams, qt, **kw),
                                          runs=20, warmup=3)
        build._kernels = unrolled
        if not torch.equal(outs["unrolled"], outs["generic"]):
            raise RuntimeError(f"unrolled and generic packed kernels differ at k={k}")
        print(f"  n_sub={bp.packed_subbands(n, n, k)} k={k:2d}: unrolled median "
              f"{statistics.median(times['unrolled']):.4f} ms, generic median "
              f"{statistics.median(times['generic']):.4f} ms (40 runs each), equal outputs")


def cli_runs(tmp):
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from chip_smoke import write_codes

    print("== 3: -k 8, 20 x 150 bp vs 1,000,000 x 150 bp filter mix through the CLI")
    q, s = filter_mix_dataset(np.random.default_rng(1), 20, 1_000_000, 150)
    qp, sp = os.path.join(tmp, "q.txt"), os.path.join(tmp, "s.txt")
    write_codes(qp, q)
    write_codes(sp, s)
    del s
    profile_cli(tmp, ["-q", qp, "-d", sp, "-k", "8"])


def profile_cli(tmp, args):
    """Three ``bgsa-torch-align`` runs with ``args`` (RunStats of each), then
    one under ``torch.profiler``: wall time, device time summed over the
    CUDA kernel and copy events, and the largest of them by name."""
    from bgsa_tpu_torch import cli
    from chip_smoke import print_stats

    res, stats = os.path.join(tmp, "r.bin"), os.path.join(tmp, "stats.json")
    argv = [*args, "-f", res, "--stats-json", stats, "--quiet"]
    for i in range(3):
        if cli.align_main(argv) != 0:
            raise RuntimeError(f"bgsa-torch-align {' '.join(args)} failed")
        print(f"  run {i}:")
        print_stats(stats)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.align_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name[e.name[:70]]
            row[0] += e.time_range.elapsed_us()
            row[1] += 1
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print(f"  profiled run: wall {wall * 1e3:.1f} ms, device time {busy_ms:.1f} ms "
          f"({busy_ms / (wall * 1e3):.3f} of wall) over {sum(c for _, c in by_name.values())} "
          "kernel and copy events; the largest by name:")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {us / 1e3:8.3f} ms {count:6d}x  {name}")


def bucket_stages(rng):
    from bgsa_tpu_torch import pack as host_pack
    from bgsa_tpu_torch.benchutil import filter_mix_dataset
    from bgsa_tpu_torch.pipeline import BUCKET_SIZE
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.banded_pipeline import KERNELS, BandedEngine
    from chip_smoke import cuda_times_ms

    n = m = 150
    k, Q = 8, 20
    S = BUCKET_SIZE // (n + 1) // 128 * 128
    q, s = filter_mix_dataset(rng, Q, S, n)
    transport, payload = host_pack.select_transport(s)
    if isinstance(payload, tuple):
        raise RuntimeError(f"expected a one-array transport, got {transport}")
    host = torch.from_numpy(payload).pin_memory()
    qt = torch.from_numpy(q).cuda()
    engine = BandedEngine(k)
    name = engine.route(m, n)
    kernel = KERNELS[name][0]
    dev_payload = host.cuda()
    codes = pack.transport_unpack(transport)(dev_payload, n)
    args = engine.kernel_args(name, codes, m)
    out = kernel(*args, qt, q_len=m, s_len=n, k=k)
    stages = {
        "upload": lambda: host.to("cuda", non_blocking=True),
        "unpack": lambda: pack.transport_unpack(transport)(dev_payload, n),
        "stream packing": lambda: engine.kernel_args(name, codes, m),
        f"kernel ({name})": lambda: kernel(*args, qt, q_len=m, s_len=n, k=k),
        "int8 narrowing": lambda: out.to(torch.int8),
    }
    print(f"== 4: one bucket, S={S} x {n} bp, {transport} transport, Q={Q}, k={k}: "
          "CUDA-event medians of 10")
    for label, fn in stages.items():
        print(f"  {label}: {statistics.median(cuda_times_ms(fn, runs=10, warmup=2)):.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    rng = np.random.default_rng(2026)
    with tempfile.TemporaryDirectory(prefix="bgsa_probe_") as tmp:
        build_times(tmp)
        packed_instantiations(tmp, rng)
        cli_runs(tmp)
        bucket_stages(rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
