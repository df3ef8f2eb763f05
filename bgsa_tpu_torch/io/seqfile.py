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

The port's own copy of ``bgsa_tpu.io.seqfile``, same behaviour.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .. import pack

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


@dataclasses.dataclass
class Bucket:
    """One database bucket of equal-length subjects."""

    codes: np.ndarray  # (count, length) uint8 symbol codes (pads included)
    count: int  # sequences including pads
    extra_count: int  # trailing all-'N' pad sequences (final bucket only)


class DatabaseReader:
    """Iterates subject buckets with reference-compatible boundaries."""

    def __init__(self, path: str, bucket_size: int = DEFAULT_BUCKET_SIZE, v_num: int = 128):
        self.path = path
        self.v_num = v_num
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
                take = min(self.seqs_per_bucket, remaining)
                remaining -= take
                raw = f.read(take * self.stride)
                if len(raw) < take * self.stride:  # missing final newline
                    raw = raw + b"\n"
                full = np.frombuffer(raw, np.uint8).reshape(take, self.stride)
                # The size check in __init__ is modular arithmetic only — a
                # ragged file whose total size happens to line up (e.g. one
                # long and one short line) would misparse silently, shifting
                # newlines into sequences (code 0). The newline column is
                # dropped anyway; validating it is one vectorized compare.
                nl_col = full[:, self.length]
                if not (nl_col == ord("\n")).all():
                    bad = int(np.argmax(nl_col != ord("\n")))
                    raise ValueError(
                        f"{self.path}: not fixed-length lines of "
                        f"{self.length} bp (ragged line near sequence "
                        f"{b * self.seqs_per_bucket + bad})"
                    )
                arr = full[:, : self.length]
                extra = 0
                if b == self.bucket_count - 1 and take % self.v_num:
                    extra = self.v_num - take % self.v_num
                    pad = np.full((extra, self.length), ord("N"), np.uint8)
                    arr = np.concatenate([arr, pad])
                yield Bucket(pack.encode_ascii(arr), take + extra, extra)


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
    count = len(raw) // stride
    full = np.frombuffer(raw[: count * stride], np.uint8).reshape(count, stride)
    nl_col = full[:, length]
    if not (nl_col == ord("\n")).all():  # ragged sizes can still line up
        bad = int(np.argmax(nl_col != ord("\n")))
        raise ValueError(
            f"{path}: not fixed-length lines of {length} bp "
            f"(ragged line near sequence {bad})"
        )
    return pack.encode_ascii(full[:, :length])


def write_seq_file(path: str, codes_or_ascii: np.ndarray) -> None:
    """Write a (S, L) array of ASCII bytes (or codes 0..4) as fixed-length lines."""
    arr = np.asarray(codes_or_ascii)
    if arr.dtype != np.uint8 or arr.max(initial=0) < 5:
        lut = np.frombuffer(b"ACGTN", np.uint8)
        arr = lut[arr.astype(np.int64)]
    nl = np.full((arr.shape[0], 1), ord("\n"), np.uint8)
    with open(path, "wb") as f:
        f.write(np.concatenate([arr, nl], axis=1).tobytes())
