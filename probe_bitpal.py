"""On-chip probe of the BitPAl path's costs, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 probe_bitpal.py

It prints the card's name and power limit (nvidia-smi), then:

1. ``-M 2 -I -3 -G -5`` with 20 x 150 bp queries against 1,000,000 x 150 bp
   subjects (seed 1, ``scripts/make_testdata.py``; the inputs of
   ``chip_smoke.py`` phases 5 and 12) through ``bgsa_tpu_torch.cli``: the
   RunStats of three runs, then one run under ``torch.profiler``
   (``probe_banded.profile_cli``);
2. one full bucket (190,080 x 150 bp, 2-bit transport, 20 queries,
   (2,-3,-5), global) through the engine's device stages, on the packed
   route (31-bit words) and the non-packed one (32-bit words), CUDA-event
   medians of 10: upload from pinned memory, unpack, Eq packing, kernel,
   int16 narrowing.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def cli_runs(tmp):
    from chip_smoke import load_make_testdata
    from probe_banded import profile_cli

    print("== 1: -M 2 -I -3 -G -5, 20 x 150 bp vs 1,000,000 x 150 bp through the CLI")
    make_testdata = load_make_testdata()
    data_rng = np.random.default_rng(1)  # scripts/make_testdata.py's seed and order
    qp, sp = os.path.join(tmp, "q.txt"), os.path.join(tmp, "s.txt")
    make_testdata.write_lines(qp, 20, 150, data_rng)
    make_testdata.write_lines(sp, 1_000_000, 150, data_rng)
    profile_cli(tmp, ["-q", qp, "-d", sp, "-M", "2", "-I", "-3", "-G", "-5"])


def bucket_stages(rng):
    from bgsa_tpu import pack as host_pack
    from bgsa_tpu.pipeline import TPU_BUCKET_SIZE, PipelineConfig
    from bgsa_tpu.schemes import Scoring, normalize
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.ops.bitpal import bitpal
    from bgsa_tpu_torch.ops.bitpal_packed import bitpal_packed
    from bgsa_tpu_torch.pipeline import Engine
    from chip_smoke import cuda_times_ms, random_codes

    n = m = 150
    Q = 20
    S = TPU_BUCKET_SIZE // (n + 1) // 128 * 128
    q, s = random_codes(rng, (Q, m)), random_codes(rng, (S, n))
    transport, payload = host_pack.select_transport(s)
    if isinstance(payload, tuple):
        raise RuntimeError(f"expected a one-array transport, got {transport}")
    host = torch.from_numpy(payload).pin_memory()
    qt = torch.from_numpy(q).cuda()
    dev_payload = host.cuda()
    codes = pack.transport_unpack(transport)(dev_payload, n)
    scheme = normalize(Scoring(2, -3, -5))
    for packed in (True, False):
        engine = Engine(scheme, PipelineConfig(bitpal_packed=packed), "cuda")
        name, word_bits = engine.kernel, engine.word_bits
        kernel = bitpal_packed if packed else bitpal
        kw = dict(match=2, mismatch=-3, gap=-5, read_len=n, word_bits=word_bits)
        eq = pack.pack_eq(codes, word_bits)
        out = kernel(eq, qt, **kw)
        stages = {
            "upload": lambda: host.to("cuda", non_blocking=True),
            "unpack": lambda: pack.transport_unpack(transport)(dev_payload, n),
            f"Eq packing ({word_bits}-bit)": lambda: pack.pack_eq(codes, word_bits),
            f"kernel ({name})": lambda: kernel(eq, qt, **kw),
            "int16 narrowing": lambda: out.to(torch.int16),
        }
        print(f"== 2: one bucket, S={S} x {n} bp, {transport} transport, Q={Q}, {name}: "
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
    with tempfile.TemporaryDirectory(prefix="bgsa_probe_") as tmp:
        cli_runs(tmp)
        bucket_stages(np.random.default_rng(2026))
    return 0


if __name__ == "__main__":
    sys.exit(main())
