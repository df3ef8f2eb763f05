"""Benchmark workloads and timing chains: the port's own copies of
``bgsa_tpu.benchutil``'s numpy ``filter_mix_dataset`` and ``chain_of``, same
behaviour; ``elapsed_ms``, which times one call by CUDA events,
``kernel_ms`` and ``kernel_times``, which read kernels' device times from
the profiler, and what the hand-run scripts share (``script_device``, their
``--device`` rule; ``device_name``; ``GateFailure``)."""

import re
import statistics
import sys
import time

import numpy as np
import torch


def filter_mix_dataset(rng, n_queries: int, n_subjects: int, length: int,
                       near_frac: float = 0.3):
    """The banded benchmark workload: (queries, subjects) int arrays where
    ``near_frac`` of the subjects are near-duplicates of some query (0-5
    random edits) and the rest random — the realistic read-filter mix."""
    qb = rng.integers(0, 4, size=(n_queries, length)).astype(np.int32)
    sb = rng.integers(0, 4, size=(n_subjects, length))
    for i in range(int(n_subjects * near_frac)):
        s = qb[i % n_queries].copy()
        pos = rng.choice(length, size=rng.integers(0, 6), replace=False)
        s[pos] = rng.integers(0, 4, size=len(pos))
        sb[i] = s
    rng.shuffle(sb, axis=0)
    return qb, sb


def chain_of(run_q, queries, n_chain: int):
    """Zero-argument sampler: ``run_q`` run ``n_chain`` times in a row, on
    the queries' device, ending in one 4-byte fetch (the sampler's return).

    Iteration i + 1's queries add ``|out_i[0, 0]| // 2**30``, always 0 for
    every kernel family's scores (|score| < 2**30). On a TPU that dependency
    is what keeps XLA from merging or parallelising the calls of the one jit
    program; here stream order already makes the launches serial, and it is
    kept so that both chains compute the same thing. It costs one tiny
    elementwise launch or three per iteration.
    """

    def sample() -> int:
        out = run_q(queries)
        for _ in range(n_chain - 1):
            dep = out[0:1, 0:1].abs() // (1 << 30)
            out = run_q(queries + dep)
        return int(out[0, 0] + out[-1, -1])

    return sample


def elapsed_ms(fn, device) -> float:
    """Milliseconds of one ``fn()``: CUDA events on a CUDA device (the call's
    device time, synchronised), the host clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def kernel_ms(fn, kernel: str) -> list:
    """Device milliseconds of each launch, during one ``fn()``, of the CUDA
    kernels whose name matches the regular expression ``kernel``, from
    ``torch.profiler``'s CUDA (CUPTI) events: the kernel's own time, without
    the host's dispatch between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == DeviceType.CUDA and re.search(kernel, e.name)]


class GateFailure(Exception):
    """An experiment's correctness gate failed: it measures nothing."""


# profiled runs of one chain before a launch count that differs is an error
PROFILE_ATTEMPTS = 3


def kernel_times(samples: dict, kernels: dict, device, n_chain: int) -> dict:
    """name -> the device ms of each launch of ``kernels[name]`` (a
    ``kernel_ms`` pattern) in one more run of each ``chain_of`` sample of
    ``n_chain`` launches; {} on the CPU.

    Now and then the profiler's CUPTI trace misses a launch (on an H100 it
    once saw 23 of a chain of 24), so a run whose count is not ``n_chain`` is
    profiled again, up to PROFILE_ATTEMPTS runs. Raises GateFailure when no
    run saw exactly ``n_chain`` launches: a pattern that matches other
    kernels, or misses the chain's, still fails every time."""
    if torch.device(device).type != "cuda":
        return {}
    times = {}
    for name, sample in samples.items():
        counts = []
        for _ in range(PROFILE_ATTEMPTS):
            times[name] = kernel_ms(sample, kernels[name])
            counts.append(len(times[name]))
            if counts[-1] == n_chain:
                break
        else:
            raise GateFailure(f"the profiler saw {counts} launches of {name}'s kernel "
                              f"({kernels[name]}) in {PROFILE_ATTEMPTS} runs of a chain of "
                              f"{n_chain}")
    return times


def median_gcups(cells: float, times_ms: dict) -> dict:
    """name -> billed GCUPS: ``cells`` over the median of each list of times (ms)."""
    return {name: cells / (statistics.median(ms) * 1e-3) / 1e9 for name, ms in times_ms.items()}


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def script_device(name: str):
    """The torch device a script's ``--device`` names, or None (after an
    error line on stderr) for a CUDA device where there is none: the scripts
    then exit 1 and never fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run the plain torch "
              "versions", file=sys.stderr)
        return None
    return device
