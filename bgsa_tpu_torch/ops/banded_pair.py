"""Paired-query banded Myers and the banded column's cost probes: torch and CUDA.

Counterparts of the two Pallas kernels of ``scripts/exp_banded_pair.py``,
the experiment that asks whether the banded stream kernel is bound by its
one serial dependency chain a column:

* ``banded_stream_pair``: two queries' band states per thread
  (``_stream_kernel_pair``), equal to ``ops.banded.banded_stream`` bit for
  bit. Q must be even. The kernel runs the stream kernel's schedule (the
  window fold: every code's stream words loaded once per 32 columns into a
  slot both chains read; the query rows staged; over budget latched at the
  batch ends <= the last checkpoint and at the last checkpoint, no
  checkpoint byte read); ``windowed_stream_pair_ref`` is that schedule in
  plain torch, used by the tests only.
* ``banded_probe``: the cost probe (``_probe_kernel``) in mode ``full`` (the
  stream column in its per-column form), ``static_c`` (plane 0 every
  column: no query-code read) or ``noload`` (the subject's stream[0, 0]
  word, read once, as every column's window). Every column runs and no
  checkpoint latches, so a score is the band's minimum, never 127; outside
  ``full`` the scores are the probe's own, as the JAX body defines them.

Both take ``ops.banded.banded_stream``'s stream (``pack.pack_banded_stream``)
and its geometry rule (s_len >= q_len). Each ``*_ref`` is the plain torch
version, run for a CPU tensor; a CUDA tensor launches ``csrc/banded_pair.cu``
(a failed build or launch raises), counted in ``LAUNCHES[name]`` with the
probe's name ``banded_probe_<mode>``. The JAX launchers' ``rows_per_block``
and ``unroll`` have no counterpart: the CUDA kernels run one thread per
subject and query pair (or query), as ``ops.banded``'s do.
"""

from __future__ import annotations

import numpy as np
import torch

from .banded import (_scan, _windowed_scan, banded_stream_ref, check_stream_args, geometry,
                     last_checkpoint, launch, stream_window_at, windowed_stream_columns)

PROBE_MODES = ("full", "static_c", "noload")

# Kernel launches per wrapper (CUDA tensors only).
LAUNCHES = {"banded_stream_pair": 0, **{f"banded_probe_{mode}": 0 for mode in PROBE_MODES}}


def pair_threads(dead: torch.Tensor) -> torch.Tensor:
    """The pair kernel's threads over (Q, S) pairs: rows 2p and 2p + 1 of a
    subject share one, which runs until both are over budget."""
    return dead[0::2] & dead[1::2]


def _check_even(queries) -> None:
    if queries.shape[0] % 2:
        raise ValueError(f"banded_stream_pair takes an even query count (pad queries to an "
                         f"even count), got {queries.shape[0]}")


def banded_stream_pair_ref(stream, queries, *, q_len: int, s_len: int, k: int, live=None):
    """Plain torch version: the stream kernel's recurrence for every query
    (the pairs change the schedule, not the function). ``live`` receives,
    before each column, the (query pair, subject) threads that still run."""
    _check_even(queries)
    return banded_stream_ref(stream, queries, q_len=q_len, s_len=s_len, k=k, live=live,
                             threads=pair_threads)


def windowed_stream_pair_ref(stream, queries, *, q_len: int, s_len: int, k: int, live=None):
    """The pair kernel's schedule end to end: both queries of a pair fold
    every column from one window slot (``windowed_stream_columns``), dead is
    latched at ``kernel_latch_array``, and a thread runs until both its
    pairs are over budget. ``live`` receives, before each column, the
    threads still running under these latches."""
    _check_even(queries)
    columns = windowed_stream_columns(stream, q_len=q_len, s_len=s_len, k=k)
    return _windowed_scan(columns, queries.to(stream.device), stream.shape[-1], q_len=q_len,
                          s_len=s_len, k=k, live=live, threads=pair_threads)


def banded_probe_ref(stream, queries, *, q_len: int, s_len: int, k: int, mode: str):
    """Plain torch version of the probe in ``mode``: every column, no latch."""
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {PROBE_MODES}, got {mode!r}")
    S = stream.shape[-1]
    if mode == "noload":
        eq = stream[0, 0].long() & 0xFFFFFFFF  # unmasked, the high word 0

        def window_at(c, t):
            return eq
    else:
        full = stream_window_at(stream, q_len, s_len, k)

        def window_at(c, t):
            return full(c if mode == "full" else torch.zeros_like(c), t)
    return _scan(queries.to(stream.device), S, window_at, q_len=q_len, s_len=s_len, k=k,
                 chk=np.zeros(q_len, np.int32))  # no latch: no 127


def _launch(name, fn_name, stream, queries, q_len, s_len, k, args):
    """Launch ``fn_name`` on CUDA tensors: args(stream, uint8 queries, out)
    gives its arguments -> out, (Q, S) int32."""
    W, S = stream.shape[-2:]
    out = torch.empty((queries.shape[0], S), dtype=torch.int32, device=stream.device)
    if out.numel() == 0:
        return out
    stream = stream.contiguous()
    q = queries.to(device=stream.device, dtype=torch.uint8).contiguous()
    launch(name, fn_name, out, args(stream, q, out, W, S))
    LAUNCHES[name] += 1
    return out


def banded_stream_pair(stream, queries, *, q_len: int, s_len: int, k: int):
    """(5, W, S) int32 Eq bit-stream x (Q, q_len) codes, Q even -> (Q, S)
    int32 error counts (127 = over budget), two queries a thread."""
    device = check_stream_args(stream, queries, q_len, s_len, k, "banded_stream_pair")
    _check_even(queries)
    if device == "cpu":
        return banded_stream_pair_ref(stream, queries, q_len=q_len, s_len=s_len, k=k)
    h, band_down, max_err = geometry(q_len, s_len, k)

    def args(st, q, out, W, S):
        return (st.data_ptr(), q.data_ptr(), out.data_ptr(), q.shape[0], q_len, W, S, k, h,
                band_down, max_err, last_checkpoint(q_len, s_len, k))

    return _launch("banded_stream_pair", "bgsa_banded_stream_pair", stream, queries, q_len, s_len,
                   k, args)


def banded_probe(stream, queries, *, q_len: int, s_len: int, k: int, mode: str):
    """(5, W, S) int32 Eq bit-stream x (Q, q_len) codes -> (Q, S) int32 band
    minima of the cost probe in ``mode`` (``PROBE_MODES``)."""
    device = check_stream_args(stream, queries, q_len, s_len, k, "banded_probe")
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {PROBE_MODES}, got {mode!r}")
    if device == "cpu":
        return banded_probe_ref(stream, queries, q_len=q_len, s_len=s_len, k=k, mode=mode)
    h, band_down, _ = geometry(q_len, s_len, k)

    def args(st, q, out, W, S):
        return (st.data_ptr(), q.data_ptr(), out.data_ptr(), q.shape[0], q_len, W, S, k, h,
                band_down, PROBE_MODES.index(mode))

    return _launch(f"banded_probe_{mode}", "bgsa_banded_probe", stream, queries, q_len, s_len, k,
                   args)
