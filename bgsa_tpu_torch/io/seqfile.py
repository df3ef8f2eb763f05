"""Readers for BGSA's plain sequence format: fixed-length lines, one per line.

Reproduces the reference's bucketing semantics exactly
(``/root/reference/original/BGSA_CPU/file.c:44-140``):

* the database is read in buckets of ``bucket_size`` bytes; a partial trailing
  line is pushed back, and the bucket's sequence count is trimmed *down* to a
  multiple of ``v_num`` (the vector-lane pad unit), the remainder pushed back
  too;
* the final bucket is padded *up* to a multiple of ``v_num`` with all-'N'
  sequences, and the pad count is reported as ``extra_count`` (recorded in the
  ``.info`` file so the converter can drop the pad scores);
* the query file is loaded whole and mapped to symbol codes.

The reference's V_NUM is 1..16 depending on port; ours is the TPU lane pad
(default 128). Pad choice does not affect converted output.

The port's own copy of ``bgsa_tpu.io.seqfile``, same behaviour. Both
readers check the newline column and encode in one native pass over the raw
line bytes (``native.encode_lines``, the interpreter lock released), or with
numpy where the native library is missing. ``DatabaseReader`` can also bill
its read and encode seconds, and the buckets the native pass encoded, to a
run's ``RunStats``, and can hand out each bucket transport-packed instead
of as codes (``encode_transport``).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from .. import native, pack

DEFAULT_BUCKET_SIZE = 114857600  # READ_BUCKET_SIZE, reference config.h
REF_BUCKET_COUNT = 100  # queries per compute tile, reference config.h


def detect_line_length(path: str) -> int:
    """Length of the first line (bytes before the first newline).

    Refuses CRLF line endings: the '\\r' would otherwise sit inside every
    sequence and score silently as code 0 ('A') — the reference has the
    same corruption (its mapping table reads '\\r' as 'A'); we error
    instead, like the FASTA/FASTQ converters strip it.
    """
    length = 0
    last = b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            pos = chunk.find(b"\n")
            if pos >= 0:
                length += pos
                last = chunk[pos - 1 : pos] if pos else last
                break
            length += len(chunk)
            last = chunk[-1:]
    if last == b"\r":
        raise ValueError(
            f"{path}: CRLF line endings (sequences would silently score the "
            "'\\r' as 'A'); convert to LF line endings first"
        )
    return length


def encode_lines(raw: bytes, rows: int, length: int, pad_rows: int = 0):
    """(codes, bad, native) of the first ``rows`` lines of ``length`` bytes
    in ``raw``, each followed by its newline: ``codes`` the (rows +
    ``pad_rows``, length) symbol codes, the last ``pad_rows`` all 'N';
    ``bad`` the first line whose newline column holds another byte (codes
    then None or incomplete), or -1; ``native`` whether the native library
    did it."""
    buf = np.frombuffer(raw, np.uint8)
    got = native.encode_lines(buf, rows, length, length + 1, pad_rows)
    if got is not None:
        return (*got, True)
    full = buf[: rows * (length + 1)].reshape(rows, length + 1)
    # The size checks are modular arithmetic only — a ragged file whose
    # total size happens to line up (e.g. one long and one short line)
    # would misparse silently, shifting newlines into sequences (code 0).
    # The newline column is dropped anyway; validating it is one compare.
    nl_col = full[:, length]
    if not (nl_col == ord("\n")).all():
        return None, int(np.argmax(nl_col != ord("\n"))), False
    arr = full[:, :length]
    if pad_rows:
        arr = np.concatenate([arr, np.full((pad_rows, length), ord("N"), np.uint8)])
    return pack.encode_ascii(arr), -1, False


def encode_transport(raw: bytes, rows: int, length: int, pad_rows: int = 0, n_shards: int = 1,
                     threads: int = 1):
    """``pack.select_transport(codes, n_shards=n_shards, threads=threads)``
    of the codes ``encode_lines`` gives, as (transport, payload, bad, native,
    packed): the same name, payload bytes and choice; ``bad`` as
    ``encode_lines``'s (transport and payload then None); ``native`` whether
    the native library encoded the bytes; ``packed`` whether its pass went
    from the bytes straight to the payload (``native.encode_transport``: one
    shard, and a "2bit" or "2bitN" payload). Every other case encodes the
    codes, then packs them with ``select_transport``."""
    buf = np.frombuffer(raw, np.uint8)
    got = native.encode_transport(buf, rows, length, length + 1, pad_rows, threads) \
        if n_shards == 1 else None
    if got is not None:
        two_bit, row_n, n_count, bad = got
        if bad >= 0:
            return None, None, bad, True, False
        if n_count == 0:
            return "2bit", two_bit, -1, True, True
        size = pack.sidecar_size(n_count, rows + pad_rows, length)
        if size is not None:
            sidecar = native.list_n(buf, rows, length, length + 1, pad_rows, row_n, size)
            return "2bitN", (two_bit, sidecar), -1, True, True
    codes, bad, native_pass = encode_lines(raw, rows, length, pad_rows)
    if bad >= 0:
        return None, None, bad, native_pass, False
    transport, payload = pack.select_transport(codes, n_shards=n_shards, threads=threads)
    return transport, payload, -1, native_pass, False


@dataclasses.dataclass
class Bucket:
    """One database bucket of equal-length subjects: its symbol codes, or,
    from a reader asked for them, its transport name and payload."""

    codes: np.ndarray | None  # (count, length) uint8 symbol codes (pads included)
    count: int  # sequences including pads
    extra_count: int  # trailing all-'N' pad sequences (final bucket only)
    transport: str | None = None  # pack.select_transport's (name, payload) of the codes
    payload: object = None


class DatabaseReader:
    """Iterates subject buckets with reference-compatible boundaries. Given
    ``transport_shards``, each bucket carries ``select_transport``'s
    payload for that many shards instead of codes (``encode_transport``,
    over ``threads`` threads). Given ``stats`` (a ``RunStats``), iterating
    adds its seconds in file reads to ``stats.reader_read_time``, in the
    newline check, 'N' pads, encoding and packing to
    ``stats.reader_encode_time``, each bucket the native pass encoded to
    ``stats.reader_native_buckets``, and each whose payload it packed to
    ``stats.reader_packed_buckets``."""

    def __init__(self, path: str, bucket_size: int = DEFAULT_BUCKET_SIZE, v_num: int = 128,
                 stats=None, transport_shards: int | None = None, threads: int = 1):
        self.path = path
        self.v_num = v_num
        self.stats = stats
        self.transport_shards = transport_shards
        self.threads = threads
        self.length = detect_line_length(path)
        self.stride = self.length + 1
        self.total_size = os.path.getsize(path)
        if self.length == 0:
            raise ValueError(f"{path}: empty or starts with a blank line")
        # Fixed-length lines are a format requirement (the reference silently
        # corrupts on ragged input; we refuse). Tolerate one missing trailing
        # newline.
        rem = self.total_size % self.stride
        if rem not in (0, self.length):
            raise ValueError(
                f"{path}: not fixed-length lines of {self.length} bp "
                f"(size {self.total_size} % {self.stride} == {rem})"
            )
        # Total sequence count; tolerate a missing trailing newline.
        self.total_count = (self.total_size + self.length) // self.stride
        if bucket_size >= self.total_size:
            self.bucket_count = 1
            self.seqs_per_bucket = self.total_count
        else:
            # Non-final buckets hold floor(bucket_size/stride) sequences,
            # trimmed down to a v_num multiple (file.c:75-94).
            per = bucket_size // self.stride
            per -= per % v_num
            if per <= 0:
                raise ValueError("bucket_size too small for sequence length")
            self.seqs_per_bucket = per
            self.bucket_count = -(-self.total_count // per)

    def bucket_counts(self) -> list[tuple[int, int]]:
        """Deterministic (count_incl_pads, extra_count) per bucket — what
        __iter__ will yield, derivable without reading the data (used by
        shard-mode resume to reconstruct completed-bucket byte offsets)."""
        out = []
        remaining = self.total_count
        for b in range(self.bucket_count):
            take = min(self.seqs_per_bucket, remaining)
            remaining -= take
            extra = 0
            if b == self.bucket_count - 1 and take % self.v_num:
                extra = self.v_num - take % self.v_num
            out.append((take + extra, extra))
        return out

    def __iter__(self):
        remaining = self.total_count
        with open(self.path, "rb") as f:
            for b in range(self.bucket_count):
                t0 = time.perf_counter()
                take = min(self.seqs_per_bucket, remaining)
                remaining -= take
                raw = f.read(take * self.stride)
                if len(raw) < take * self.stride:  # missing final newline
                    raw = raw + b"\n"
                t1 = time.perf_counter()
                extra = 0
                if b == self.bucket_count - 1 and take % self.v_num:
                    extra = self.v_num - take % self.v_num
                packed = False
                if self.transport_shards is None:
                    codes, bad, native_pass = encode_lines(raw, take, self.length, extra)
                    bucket = Bucket(codes, take + extra, extra)
                else:
                    transport, payload, bad, native_pass, packed = encode_transport(
                        raw, take, self.length, extra, self.transport_shards, self.threads)
                    bucket = Bucket(None, take + extra, extra, transport, payload)
                if bad >= 0:
                    raise ValueError(
                        f"{self.path}: not fixed-length lines of "
                        f"{self.length} bp (ragged line near sequence "
                        f"{b * self.seqs_per_bucket + bad})"
                    )
                if self.stats is not None:
                    self.stats.reader_read_time += t1 - t0
                    self.stats.reader_encode_time += time.perf_counter() - t1
                    self.stats.reader_native_buckets += native_pass
                    self.stats.reader_packed_buckets += packed
                yield bucket


def read_queries(path: str) -> np.ndarray:
    """Load the whole query file as (Q, m) symbol codes (file.c:117-140)."""
    length = detect_line_length(path)
    stride = length + 1
    if length == 0:
        raise ValueError(f"{path}: empty or starts with a blank line")
    with open(path, "rb") as f:
        raw = f.read()
    # Tolerate editor-appended blank lines / a missing final newline.
    raw = raw.rstrip(b"\n") + b"\n"
    if len(raw) % stride:
        raise ValueError(f"{path}: not fixed-length lines of {length} bp")
    codes, bad, _ = encode_lines(raw, len(raw) // stride, length)
    if bad >= 0:  # ragged sizes can still line up
        raise ValueError(
            f"{path}: not fixed-length lines of {length} bp "
            f"(ragged line near sequence {bad})"
        )
    return codes


def write_seq_file(path: str, codes_or_ascii: np.ndarray) -> None:
    """Write a (S, L) array of ASCII bytes (or codes 0..4) as fixed-length lines."""
    arr = np.asarray(codes_or_ascii)
    if arr.dtype != np.uint8 or arr.max(initial=0) < 5:
        lut = np.frombuffer(b"ACGTN", np.uint8)
        arr = lut[arr.astype(np.int64)]
    nl = np.full((arr.shape[0], 1), ord("\n"), np.uint8)
    with open(path, "wb") as f:
        f.write(np.concatenate([arr, nl], axis=1).tobytes())
