"""Experiment: two queries per banded stream thread, and the column's cost probes.

The twin of ``scripts/exp_banded_pair.py`` on the card. Hypothesis: the
banded stream kernel (``csrc/banded.cu``) is bound by its one serial
dependency chain a column; carrying two queries' band states per thread
(``ops.banded_pair.banded_stream_pair``) doubles the independent work and
lifts its rate. The probes (``banded_probe``: every column, no early exit)
price parts of the column: ``p_full`` - ``p_statc`` is the per-column
query-code read and dynamic plane, ``p_statc`` - ``p_noload`` the funnel
load.

Shape: the experiment's own, the banded bench line:
``filter_mix_dataset(rng(7), 8, 65536, 150)``, k = 8, the stream packed on
the device by ``pack.pack_banded_stream``. Gate: the pair kernel equals
``banded_stream`` bit for bit. Timing: the five variants, each a chain of 24
launches (``benchutil.chain_of``), in 8 interleaved repetitions, each chain
timed by CUDA events; billed GCUPS (full-matrix cells, as the JAX script
bills them), M align/s and the change against ``single``, from the medians.
A chain is dispatched from the host launch by launch (where the JAX chain
is one program), so a kernel shorter than the host's work between launches
reads the host's rate; on the card each variant's kernel is also timed
alone, from the profiler's device time of its launches in one more chain
(``benchutil.kernel_ms``), and reported beside the chain's rate.

    python -m bgsa_tpu_torch.scripts.exp_banded_pair [--device cpu]

Without a GPU and without ``--device cpu`` (the plain versions, timed by the
host clock: not a device time) it exits 1; a failed gate exits 1. The JAX
launchers' ``rows_per_block`` and ``unroll`` have no counterpart.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from .. import pack
from ..benchutil import (GateFailure, chain_of, device_name, elapsed_ms, filter_mix_dataset,
                         kernel_times, median_gcups, script_device)
from ..ops import banded as bo
from ..ops import banded_pair as bpr

# the experiment's shape (module level, so a test can shrink it)
SEED, QUERIES, SUBJECTS, LENGTH, K = 7, 8, 65536, 150, 8
CHAIN, REPS = 24, 8
# variant -> its CUDA kernel's name in the profiler (demangled or mangled)
KERNELS = {"single": r"banded_stream_kernel(<false,|ILb0E)",
           "pair": r"banded_stream_pair_kernel",
           "p_full": r"banded_probe_kernel(<0>|ILi0E)",
           "p_statc": r"banded_probe_kernel(<1>|ILi1E)",
           "p_noload": r"banded_probe_kernel(<2>|ILi2E)"}


def variants(stream, kw) -> dict:
    """name -> run(queries) of the five variants."""
    out = {"single": lambda q: bo.banded_stream(stream, q, **kw),
           "pair": lambda q: bpr.banded_stream_pair(stream, q, **kw)}
    for label, mode in (("p_full", "full"), ("p_statc", "static_c"), ("p_noload", "noload")):
        out[label] = lambda q, mode=mode: bpr.banded_probe(stream, q, mode=mode, **kw)
    return out


def run(device) -> dict:
    """Gate, then time the variants: {"device", "cells" (billed per chain),
    "chain_ms" (name -> the chains' times), "kernel_ms" (name -> the device
    times of one chain's launches; on the card only), "stream", "queries",
    "kw"}. Raises GateFailure when the pair kernel differs from
    banded_stream, or when the profiler does not see every launch."""
    rng = np.random.default_rng(SEED)
    qb, sb = filter_mix_dataset(rng, QUERIES, SUBJECTS, LENGTH)
    queries = torch.from_numpy(qb).to(device)
    stream = pack.pack_banded_stream(torch.from_numpy(sb.astype(np.int32)).to(device), K, LENGTH)
    kw = dict(q_len=LENGTH, s_len=LENGTH, k=K)

    print("bit-exactness check ...", file=sys.stderr)
    want = bo.banded_stream(stream, queries, **kw)
    got = bpr.banded_stream_pair(stream, queries, **kw)
    if not torch.equal(want, got):
        bad = torch.nonzero(want != got)[:5].tolist()
        raise GateFailure(f"banded_stream_pair != banded_stream at {bad}")
    print("bit-exact vs banded_stream", file=sys.stderr)

    samples = {name: chain_of(fn, queries, CHAIN) for name, fn in variants(stream, kw).items()}
    for sample in samples.values():
        sample()  # warm-up
    chain_ms = {name: [] for name in samples}
    for _ in range(REPS):  # interleaved
        for name, sample in samples.items():
            chain_ms[name].append(elapsed_ms(sample, device))
    return {"device": device_name(device), "cells": QUERIES * LENGTH * SUBJECTS * LENGTH * CHAIN,
            "chain_ms": chain_ms, "kernel_ms": kernel_times(samples, KERNELS, device, CHAIN),
            "stream": stream, "queries": queries, "kw": kw}


def report(result: dict, base: str = "single") -> dict:
    """Print each variant's rate from its median chain and, on the card, from
    its kernel's median device time; name -> billed GCUPS of the chains."""
    chain = median_gcups(result["cells"], result["chain_ms"])
    kernel = median_gcups(result["cells"] / CHAIN, result["kernel_ms"])
    where = result["device"] if result["device"] != "cpu" else \
        "cpu, plain torch (host clock, not a device time)"
    for name, rate in chain.items():
        line = (f"{name:8s}: {rate:.0f} GCUPS billed = {rate * 1e9 / LENGTH / LENGTH / 1e6:.0f} M "
                f"align/s  ({rate / chain[base] - 1:+.1%})")
        if kernel:
            line += (f"; kernel alone {statistics.median(result['kernel_ms'][name]):.4f} ms = "
                     f"{kernel[name]:.0f} GCUPS ({kernel[name] / kernel[base] - 1:+.1%})")
        print(f"{line}  [{where}]")
    return chain


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m bgsa_tpu_torch.scripts.exp_banded_pair")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain torch versions)")
    args = p.parse_args(argv)
    device = script_device(args.device)
    if device is None:
        return 1
    try:
        report(run(device))
    except GateFailure as e:
        print(f"MISMATCH: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
