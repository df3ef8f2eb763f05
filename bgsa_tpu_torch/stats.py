"""Run statistics and GCUPS accounting, and the spans that bill them.

Mirrors the reference's end-of-run report (``cal_cpu.c:459-475``):
``cal GCUPS`` counts kernel time only, ``Total GCUPS`` is end-to-end, both
with cells = ref_len * ref_count * read_len * subject_count.

The port's own copy of ``bgsa_tpu.stats``: the same fields, JSON and
report, plus fourteen fields the reference lacks (the reader wait; the
reader thread's read and encode seconds, its wait on a full queue, the
buckets its native pass encoded and those whose transport payload it
packed; the rows scored; the BitPAl launches' word-columns, those on the
tiled kernel, and their largest scratch; the Myers launches' word-columns,
those on the strip kernels, those of them on the wavefront, and their
largest carry buffer),
``LaunchCounts``, which a launcher fills and ``RunStats.add_launches`` adds
to its family's fields, and ``Span``, which times a phase on the host clock
and names it in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import dataclasses
import time

import torch

# The RunStats fields that a kernel family's LaunchCounts add to: its
# word-columns, those past the register bound, those of them on the
# wavefront (None: the family has none), and its largest buffer.
LAUNCH_FIELDS = {
    "bitpal": ("bitpal_word_columns", "bitpal_tiled_word_columns", None,
               "bitpal_scratch_peak_bytes"),
    "myers": ("myers_word_columns", "myers_strip_word_columns", "myers_wave_word_columns",
              "myers_carry_peak_bytes"),
}


@dataclasses.dataclass
class LaunchCounts:
    """What a caller's launches of one kernel family (a key of
    ``LAUNCH_FIELDS``) ran: word-columns (Q x m x W x S) in all and on the
    family's kernel past its register bound (BitPAl's tiled kernel, Myers'
    strips), the largest device buffer that one launch allocated (BitPAl's
    scratch, Myers' carries), in bytes, and the wide word-columns that ran
    as a wavefront (Myers' ``myers_strips_wave``). ``family`` is None until
    a launch is counted."""

    family: str | None = None
    word_columns: int = 0
    wide_word_columns: int = 0
    buffer_peak_bytes: int = 0
    wave_word_columns: int = 0

    def add(self, family: str, word_columns: int, wide: bool, buffer_bytes: int = 0,
            wave: bool = False) -> None:
        """Count one launch of ``family``'s kernels (``wave``: a wide launch
        run as a wavefront)."""
        if self.family not in (None, family):
            raise ValueError(f"a {family} launch counted with {self.family} launches")
        self.family = family
        self.word_columns += word_columns
        self.wide_word_columns += word_columns if wide else 0
        self.wave_word_columns += word_columns if wave else 0
        self.buffer_peak_bytes = max(self.buffer_peak_bytes, buffer_bytes)


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
    # run_bucketed's reader thread blocked in buckets.put() on a full
    # queue (the main thread behind); written and read as the two above.
    reader_put_wait_time: float = 0.0
    reader_native_buckets: int = 0
    reader_packed_buckets: int = 0
    # Subject rows handed to the engine, once per database bucket: the real
    # subjects plus the reference's 'N' lane pads (run_bucketed adds no
    # shape pad).
    scored_rows: int = 0
    # BitPAl launches on the card, once a dispatch (LaunchCounts):
    # word-columns (Q x m x W x S) in all and on the tiled kernel, and the
    # largest device scratch one launch allocated, in bytes.
    bitpal_word_columns: int = 0
    bitpal_tiled_word_columns: int = 0
    bitpal_scratch_peak_bytes: int = 0
    # Myers launches on the card, once a dispatch (LaunchCounts):
    # word-columns (Q x m x W x S) in all and on the strip kernels (either
    # schedule), the largest carry buffer one launch allocated, in bytes,
    # and the strips' word-columns that ran as a wavefront.
    myers_word_columns: int = 0
    myers_strip_word_columns: int = 0
    myers_carry_peak_bytes: int = 0
    myers_wave_word_columns: int = 0

    @property
    def cells(self) -> int:
        return self.query_len * self.query_count * self.subject_len * self.subject_count

    def gcups(self, seconds: float) -> float:
        return self.cells / seconds / 1e9 if seconds > 0 else float("inf")

    def add_launches(self, counts: LaunchCounts) -> None:
        """Add one dispatch's ``LaunchCounts`` to its family's fields (none
        where no launch was counted)."""
        if counts.family is None:
            return
        total, wide, wave, peak = LAUNCH_FIELDS[counts.family]
        setattr(self, total, getattr(self, total) + counts.word_columns)
        setattr(self, wide, getattr(self, wide) + counts.wide_word_columns)
        if wave:
            setattr(self, wave, getattr(self, wave) + counts.wave_word_columns)
        setattr(self, peak, max(getattr(self, peak), counts.buffer_peak_bytes))

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
    The seconds are read inside the range, so the interval billed nests in
    the one the trace records. ``seconds`` holds the block's time once it
    has exited."""

    __slots__ = ("name", "stats", "field", "seconds", "_range", "_t0")

    def __init__(self, name: str, stats: RunStats | None = None, field: str | None = None):
        self.name = "bgsa." + name
        self.stats, self.field = stats, field
        self.seconds = 0.0

    def __enter__(self) -> Span:
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        if self.stats is not None:
            setattr(self.stats, self.field, getattr(self.stats, self.field) + self.seconds)
