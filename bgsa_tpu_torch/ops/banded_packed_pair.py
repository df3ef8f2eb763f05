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

``banded_packed_probe`` prices the packed column as ``ops.banded_pair``'s
probes price the stream column: mode ``full`` (the per-column window fold),
``static_c`` (no query-code read: code 0 every column) or ``noload`` (one
fold before the loop: the band update alone), every column run and nothing
latched, beside its plain version ``banded_packed_probe_ref``. No TPU kernel
has this probe; ``scripts/exp_banded_packed_pair.py probe`` drives it.
"""

from __future__ import annotations

import torch

from .banded import _check_queries, _device_of, geometry, launch
from .banded_packed import (banded_stream_packed_ref, check_streams, column_eq, launch_packed,
                            packed_scan, packed_window)

PROBE_MODES = ("full", "static_c", "noload")

# Kernel launches made by ``banded_packed_pair`` (CUDA tensors only).
LAUNCHES = 0
# Kernel launches made by ``banded_packed_probe``, by mode (CUDA tensors only).
PROBE_LAUNCHES = dict.fromkeys(PROBE_MODES, 0)


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


def banded_packed_probe_ref(streams, queries, *, q_len: int, s_len: int, k: int, mode: str):
    """Plain torch version of the packed column's cost probe in ``mode``:
    every column runs and nothing latches (a score is the band's minimum);
    ``full`` folds each column from its own window (``packed_window``),
    ``static_c`` takes code 0 every column, ``noload`` code 0's register at
    column 0 every column."""
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {PROBE_MODES}, got {mode!r}")
    _, band_down, _ = geometry(q_len, s_len, k)
    pitch, wmask = band_down + 2, (1 << (band_down + 1)) - 1

    def eq_at(st, t, q):
        if mode == "full":
            return column_eq(packed_window(st, t, pitch, wmask), q[:, t])
        fields = packed_window(st, 0 if mode == "noload" else t, pitch, wmask)
        return fields[0].expand(q.shape[0], -1)

    return packed_scan(streams, queries, q_len=q_len, s_len=s_len, k=k, eq_at=eq_at, latch=False)


def banded_packed_probe(streams, queries, *, q_len: int, s_len: int, k: int, mode: str):
    """(n_sub, 5, W, S_sub) int32 chunked streams x (Q, q_len) codes -> (Q,
    n_sub * S_sub) int32 band minima of the packed column's cost probe in
    ``mode`` (``PROBE_MODES``): ``csrc/banded_packed_pair.cu``
    ``banded_packed_probe_kernel`` for a CUDA tensor, counted in
    ``PROBE_LAUNCHES[mode]``; the plain version for a CPU tensor."""
    n_sub = check_streams(streams, q_len, s_len, k)
    _check_queries(queries, q_len)
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {PROBE_MODES}, got {mode!r}")
    if _device_of(streams, "banded_packed_probe") == "cpu":
        return banded_packed_probe_ref(streams, queries, q_len=q_len, s_len=s_len, k=k, mode=mode)
    h, band_down, _ = geometry(q_len, s_len, k)
    W, S_sub = streams.shape[2:]
    Q = queries.shape[0]
    out = torch.empty((Q, n_sub * S_sub), dtype=torch.int32, device=streams.device)
    if Q == 0 or S_sub == 0:
        return out
    streams = streams.contiguous()
    q = queries.to(device=streams.device, dtype=torch.uint8).contiguous()
    launch(f"banded_packed_probe_{mode}", "bgsa_banded_packed_probe", out,
           (streams.data_ptr(), q.data_ptr(), out.data_ptr(), Q, q_len, W, S_sub, n_sub, k, h,
            band_down, PROBE_MODES.index(mode)))
    PROBE_LAUNCHES[mode] += 1
    return out
