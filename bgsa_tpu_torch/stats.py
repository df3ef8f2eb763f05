"""Run statistics and GCUPS accounting, and the spans that bill them.

Mirrors the reference's end-of-run report (``cal_cpu.c:459-475``):
``cal GCUPS`` counts kernel time only, ``Total GCUPS`` is end-to-end, both
with cells = ref_len * ref_count * read_len * subject_count.

The port's own copy of ``bgsa_tpu.stats``: the same fields, JSON and
report, plus nine fields the reference lacks (the reader wait; the reader
thread's read and encode seconds, the buckets its native pass encoded and
those whose transport payload it packed; the rows scored; the BitPAl
launches' word-columns, those on the tiled kernel, and their largest
scratch) and ``Span``, which times a phase on the host clock and names it
in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class RunStats:
    query_len: int = 0
    query_count: int = 0
    subject_len: int = 0
    subject_count: int = 0  # real subjects (pads excluded)
    read_time: float = 0.0
    pack_time: float = 0.0
    cal_time: float = 0.0
    write_time: float = 0.0
    # The kernel library's nvcc build or load and the CUDA contexts (no
    # reference analogue)
    compile_time: float = 0.0
    total_time: float = 0.0
    # Per-bucket kernel+fetch seconds (the reference's use_times matrix,
    # cal_all.c:318-321 — the input to its dynamic load balancer; feed these
    # to parallel.multihost.DynamicBalancer for heterogeneous deployments).
    bucket_cal_times: list = dataclasses.field(default_factory=list)
    # -D mode: the ratio schedule actually used, one row per computed bucket
    # (the reference prints device_compute_ratio per round, global.c:66-68).
    dynamic_ratios: list = dataclasses.field(default_factory=list)
    # The main thread's wait for the reader thread's next bucket.
    read_wait_time: float = 0.0
    # The database reader's wall seconds (waits for the interpreter lock
    # included): file reads; the newline check, 'N' pads, encoding and, where
    # the reader packs, transport packing. The buckets that the native
    # library encoded (the rest took numpy), and those whose transport
    # payload its pass built straight from the file's bytes
    # (native.encode_transport). In run_bucketed only the reader thread
    # writes them, and the main thread reads them after joining it.
    reader_read_time: float = 0.0
    reader_encode_time: float = 0.0
    reader_native_buckets: int = 0
    reader_packed_buckets: int = 0
    # Subject rows handed to the engine, once per database bucket: the real
    # subjects plus the reference's 'N' lane pads (run_bucketed adds no
    # shape pad).
    scored_rows: int = 0
    # BitPAl launches on the card, once a dispatch (ops.bitpal.LaunchCounts):
    # word-columns (Q x m x W x S) in all and on the tiled kernel, and the
    # largest device scratch one launch allocated, in bytes.
    bitpal_word_columns: int = 0
    bitpal_tiled_word_columns: int = 0
    bitpal_scratch_peak_bytes: int = 0

    @property
    def cells(self) -> int:
        return self.query_len * self.query_count * self.subject_len * self.subject_count

    def gcups(self, seconds: float) -> float:
        return self.cells / seconds / 1e9 if seconds > 0 else float("inf")

    def add_bitpal(self, counts) -> None:
        """Add one dispatch's ``ops.bitpal.LaunchCounts``."""
        self.bitpal_word_columns += counts.word_columns
        self.bitpal_tiled_word_columns += counts.tiled_word_columns
        self.bitpal_scratch_peak_bytes = max(self.bitpal_scratch_peak_bytes,
                                             counts.scratch_peak_bytes)

    def to_json(self) -> str:
        import json

        d = dataclasses.asdict(self)
        d["cal_gcups"] = self.gcups(self.cal_time) if self.cal_time > 0 else None
        d["total_gcups"] = (
            self.gcups(self.total_time) if self.total_time > 0 else None
        )
        return json.dumps(d, allow_nan=False)

    def report(self) -> str:
        lines = [
            f"read_total_time  is {self.read_time:.2f}s",
            f"write_total_time is {self.write_time:.2f}s",
            f"mem_total_time is   {self.pack_time:.2f}s",
            "",
            f"query_len    is {self.query_len}",
            f"query_count  is {self.query_count}",
            f"subject_len   is {self.subject_len}",
            f"subject_count is {self.subject_count}",
            "",
            f"compile_time        is {self.compile_time:.2f}s",
            f"cal_total_times     is {self.cal_time:.2f}s",
            f"total time          is {self.total_time:.2f}s",
            f"cal GCUPS is {self.gcups(self.cal_time):.2f}",
            f"Total GCUPS is {self.gcups(self.total_time):.2f}",
        ]
        return "\n".join(lines)


class Span:
    """One phase of a run, named and timed at one boundary: a ``with`` block
    that opens ``torch.profiler.record_function("bgsa.<name>")``, so that a
    profiler trace names the phase on the clock of its device activity, and
    adds the block's host seconds to ``stats.<field>`` where both are given.
    ``ids`` (``bucket=``, ``query_bucket=``) go into the range's ``args``,
    the same for every span of one bucket. ``seconds`` holds the block's
    time once it has exited."""

    __slots__ = ("name", "args", "stats", "field", "seconds", "_range", "_t0")

    def __init__(self, name: str, stats: RunStats | None = None, field: str | None = None,
                 **ids):
        self.name = "bgsa." + name
        self.args = " ".join(f"{k}={v}" for k, v in ids.items()) or None
        self.stats, self.field = stats, field
        self.seconds = 0.0

    def __enter__(self) -> Span:
        self._range = torch.profiler.record_function(self.name, self.args)
        # Read the clock just before the range's enter and exit ops: each
        # takes its time stamp as it drops the interpreter lock, and may wait
        # for the lock on its way back (held by the reader thread, say).
        self._t0 = time.perf_counter()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        if self.stats is not None:
            setattr(self.stats, self.field, getattr(self.stats, self.field) + self.seconds)
