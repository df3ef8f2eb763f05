"""Experiment: two queries per packed banded thread, and the packed column's cost.

The twin of ``scripts/exp_banded_packed_pair.py`` on the card. The packed
banded kernel (``csrc/banded_packed.cu``) runs one 64-bit register's serial
chain a column for n_sub subjects; the test carries two queries' packed
states per thread (``ops.banded_packed_pair.banded_packed_pair``), both
reading the same subject words, and asks whether the second independent
chain lifts its rate. Beside them run the packed column's cost probes
(``ops.banded_packed_pair.banded_packed_probe``, no TPU twin): ``p_full``
(the column in its per-column form: the query code, the plane address, two
stream words and a funnel shift per field), ``p_statc`` (no query-code
read) and ``p_noload`` (the band update alone), every column run, nothing
latched; the split prices what the shipping kernel's window fold removes.

Shape: the experiment's own: rng 13, Q = 8, k = 8, 150 bp, S = 65,280
(n_sub = 3; the subject count rounded down to n_sub x 128), subjects from
``filter_mix_dataset`` (``mix``) or uniform random (``garbage``), the
streams packed on the device by ``pack_packed_streams``. Gate: the pair
kernel equals ``banded_stream_packed`` bit for bit, and each probe its
plain version on the first two queries and 128 subjects a chunk. Timing:
every variant, each a chain of 24 launches (``benchutil.chain_of``), 8
interleaved repetitions, each chain timed by CUDA events; billed GCUPS and
M align/s from the medians, fastest first, with the change against
``packed``, and on the card each kernel's own device time
(``benchutil.kernel_times``: a chain is dispatched launch by launch, and
these kernels are short enough for the host's work between launches to
show). The JAX script's ``packed_r16u16`` and ``pair_r32u16`` set
``rows_per_block``, which has no counterpart here (a CUDA thread holds one
subject group, with no row blocks), so they cannot be reproduced.

    python -m bgsa_tpu_torch.scripts.exp_banded_packed_pair [mix|garbage] [--device cpu]

Without a GPU and without ``--device cpu`` (the plain versions, timed by the
host clock: not a device time) it exits 1; a failed gate exits 1.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from ..benchutil import (GateFailure, chain_of, device_name, elapsed_ms, filter_mix_dataset,
                         kernel_times, median_gcups, script_device)
from ..ops import banded_packed as bpk
from ..ops import banded_packed_pair as bpp

# the experiment's shape (module level, so a test can shrink it)
SEED, QUERIES, SUBJECTS, LENGTH, K = 13, 8, 65536, 150, 8
CHAIN, REPS = 24, 8
KINDS = ("mix", "garbage")
# variant -> its CUDA kernel's name in the profiler (n_sub = 3 at this shape)
KERNELS = {"packed": r"banded_packed_kernel(<3>|ILi3E)",
           "pair": r"banded_packed_pair_kernel(<3>|ILi3E)",
           **{f"p_{label}": rf"banded_packed_probe_kernel(<{i}, 3>|ILi{i}ELi3E)"
              for i, label in enumerate(("full", "statc", "noload"))}}
PROBES = {"p_full": "full", "p_statc": "static_c", "p_noload": "noload"}


def inputs(kind: str):
    """(queries, subjects) codes of the experiment; S a multiple of n_sub x 128."""
    rng = np.random.default_rng(SEED)
    n_sub = bpk.packed_subbands(LENGTH, LENGTH, K)
    S = (SUBJECTS // (n_sub * 128)) * (n_sub * 128)
    if kind == "garbage":
        q = rng.integers(0, 4, size=(QUERIES, LENGTH)).astype(np.int32)
        s = rng.integers(0, 4, size=(S, LENGTH))
    else:
        q, s = filter_mix_dataset(rng, QUERIES, S, LENGTH)
    return q, s.astype(np.int32)


def run(kind: str, device) -> dict:
    """Gate, then time both variants: {"device", "kind", "cells" (billed per
    chain), "chain_ms" (name -> the chains' times), "kernel_ms" (name -> the
    device times of one chain's launches; on the card only), "streams",
    "queries", "codes", "kw"}. Raises GateFailure when the pair kernel
    differs from banded_stream_packed."""
    q, s = inputs(kind)
    n_sub = bpk.packed_subbands(LENGTH, LENGTH, K)
    queries = torch.from_numpy(q).to(device)
    codes = torch.from_numpy(s).to(device)
    streams = bpk.pack_packed_streams(codes, K, LENGTH, n_sub)
    kw = dict(q_len=LENGTH, s_len=LENGTH, k=K)

    print(f"[{kind}] gate ...", file=sys.stderr)
    want = bpk.banded_stream_packed(streams, queries, **kw)
    got = bpp.banded_packed_pair(streams, queries, **kw)
    if not torch.equal(want, got):
        bad = torch.nonzero(want != got)[:5].tolist()
        raise GateFailure(f"[{kind}] banded_packed_pair != banded_stream_packed at {bad}")
    few = streams[:, :, :, :128].contiguous()
    for label, mode in PROBES.items():
        got = bpp.banded_packed_probe(few, queries[:2], mode=mode, **kw)
        if not torch.equal(got, bpp.banded_packed_probe_ref(few, queries[:2], mode=mode, **kw)):
            raise GateFailure(f"[{kind}] banded_packed_probe {mode} != its plain version")
    print("bit-exact", file=sys.stderr)

    runs = {"packed": lambda x: bpk.banded_stream_packed(streams, x, **kw),
            "pair": lambda x: bpp.banded_packed_pair(streams, x, **kw),
            **{label: lambda x, mode=mode: bpp.banded_packed_probe(streams, x, mode=mode, **kw)
               for label, mode in PROBES.items()}}
    samples = {name: chain_of(fn, queries, CHAIN) for name, fn in runs.items()}
    for sample in samples.values():
        sample()  # warm-up
    chain_ms = {name: [] for name in samples}
    for rep in range(REPS):  # interleaved
        for name, sample in samples.items():
            chain_ms[name].append(elapsed_ms(sample, device))
        print(f"rep {rep + 1}/{REPS}", file=sys.stderr)
    return {"device": device_name(device), "kind": kind,
            "cells": QUERIES * LENGTH * s.shape[0] * LENGTH * CHAIN, "chain_ms": chain_ms,
            "kernel_ms": kernel_times(samples, KERNELS, device, CHAIN), "streams": streams,
            "queries": queries, "codes": codes, "kw": kw}


def report(result: dict, base: str = "packed") -> dict:
    """Print each variant's rate from its median chain, fastest first, and on
    the card from its kernel's median device time; name -> billed GCUPS of
    the chains."""
    chain = median_gcups(result["cells"], result["chain_ms"])
    kernel = median_gcups(result["cells"] / CHAIN, result["kernel_ms"])
    where = result["device"] if result["device"] != "cpu" else \
        "cpu, plain torch (host clock, not a device time)"
    for name, rate in sorted(chain.items(), key=lambda kv: -kv[1]):
        line = (f"[{result['kind']}] {name:6s}: {rate:6.0f} GCUPS billed = "
                f"{rate * 1e9 / LENGTH / LENGTH / 1e6:5.0f} M align/s  "
                f"({rate / chain[base] - 1:+.1%})")
        if kernel:
            line += (f"; kernel alone {statistics.median(result['kernel_ms'][name]):.4f} ms = "
                     f"{kernel[name]:.0f} GCUPS ({kernel[name] / kernel[base] - 1:+.1%})")
        print(f"{line}  [{where}]")
    return chain


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m bgsa_tpu_torch.scripts.exp_banded_packed_pair")
    p.add_argument("kind", nargs="?", default="mix", choices=KINDS)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain torch versions)")
    args = p.parse_args(argv)
    device = script_device(args.device)
    if device is None:
        return 1
    try:
        report(run(args.kind, device))
    except GateFailure as e:
        print(f"MISMATCH: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
