"""Paired-query packed banded kernel: torch and CUDA.

Counterpart of ``scripts/exp_banded_packed_pair.py``'s Pallas kernel
(``_pair_kernel``): the packed banded kernel (``ops.banded_packed``) with two
queries' packed states per thread, the experiment that asks whether a
second independent chain lifts it. Scores equal ``banded_stream_packed``'s
for every geometry, including q_len < k: the JAX pair kernel takes
``err = q_len - matches`` there (the ``bgsa_tpu`` packed fault that
``ops.banded_packed`` guards against), this one ``max(q_len, k) - matches``
with the latch threshold clamped at 0, as the port's packed kernel does.

``banded_packed_pair_ref`` is the plain torch version, run for a CPU tensor;
a CUDA tensor launches ``csrc/banded_packed_pair.cu`` (a failed build or
launch raises), counted in ``LAUNCHES``. Q must be even. The JAX launcher's
``rows_per_block`` and ``unroll`` have no counterpart.
"""

from __future__ import annotations

import torch

from .banded import _check_queries, _device_of
from .banded_packed import banded_stream_packed_ref, check_streams, launch_packed

# Kernel launches made by ``banded_packed_pair`` (CUDA tensors only).
LAUNCHES = 0


def packed_pair_threads(n_sub: int):
    """The packed pair kernel's threads over (Q, n_sub * S_sub) pairs in
    subject order: two queries x the n_sub chunks' subject s share one,
    which runs until all 2 n_sub are over budget."""

    def threads(dead: torch.Tensor) -> torch.Tensor:
        Q, S = dead.shape
        return dead.reshape(Q // 2, 2, n_sub, S // n_sub).all(dim=1).all(dim=1)

    return threads


def _check_even(queries) -> None:
    if queries.shape[0] % 2:
        raise ValueError(f"banded_packed_pair takes an even query count (pad queries to an "
                         f"even count), got {queries.shape[0]}")


def banded_packed_pair_ref(streams, queries, *, q_len: int, s_len: int, k: int):
    """Plain torch version: the packed recurrence for every query (the pairs
    change the schedule, not the function). streams (n_sub, 5, W, S_sub)
    int32, queries (Q, m), Q even -> (Q, n_sub * S_sub) int32."""
    _check_even(queries)
    return banded_stream_packed_ref(streams, queries, q_len=q_len, s_len=s_len, k=k)


def banded_packed_pair(streams, queries, *, q_len: int, s_len: int, k: int):
    """(n_sub, 5, W, S_sub) int32 chunked streams (``pack_packed_streams``)
    x (Q, q_len) codes, Q even -> (Q, n_sub * S_sub) int32 error counts (127
    = over budget), in original subject order, two queries a thread."""
    global LAUNCHES
    n_sub = check_streams(streams, q_len, s_len, k)
    _check_queries(queries, q_len)
    _check_even(queries)
    if _device_of(streams, "banded_packed_pair") == "cpu":
        return banded_packed_pair_ref(streams, queries, q_len=q_len, s_len=s_len, k=k)
    out = launch_packed("banded_packed_pair", "bgsa_banded_packed_pair", streams, queries, n_sub,
                        q_len=q_len, s_len=s_len, k=k)
    LAUNCHES += 1
    return out
