"""Benchmark workloads: the port's own copy of ``bgsa_tpu.benchutil``'s
numpy ``filter_mix_dataset``, same behaviour (the JAX module's in-jit timing
chains have no counterpart: the port times with CUDA events)."""

import numpy as np


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
