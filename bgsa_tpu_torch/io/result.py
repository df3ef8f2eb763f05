"""BGSA-compatible binary result file and ``.info`` manifest.

Formats (reverse-engineered from the writer ``cal_cpu.c:247-351`` and reader
``convert.c:167-277`` in ``/root/reference/original/BGSA_CPU``):

``<result>.info``::

    int32   block_num            # number of database buckets
    int32   total_device_number  # score shards per bucket (1 here)
    int64   ref_count            # total query count
    repeat block_num times:
        int64 device_read_counts[total_device_number]
        int32 extra_count        # all-'N' pad subjects in the last device shard

``<result>`` (binary)::

    for each database bucket j:          # file order
      for each query bucket m (REF_BUCKET_COUNT queries):
        for each device t:
          write_t scores[bucket_query_count][device_read_counts[j][t]]

``write_t`` is int16 for full alignment, int8 for banded (MAX_ERROR=127).

``convert_result`` re-walks that layout and emits one decimal score per line
in (query-major, original subject order), dropping pad subjects — identical
output to the reference ``convert -r``.

The port's own copy of ``bgsa_tpu.io.result``, same behaviour.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .seqfile import REF_BUCKET_COUNT


@dataclasses.dataclass
class InfoData:
    block_num: int
    device_num: int
    ref_count: int
    device_read_counts: list[list[int]]  # [block][device]
    extra_counts: list[int]  # [block]


class ResultWriter:
    """Streams score blocks + manifest, mirroring the reference's write order."""

    def __init__(self, result_path: str, ref_count: int, block_num: int, device_num: int = 1,
                 write_dtype=np.int16, append: bool = False):
        mode = "ab" if append else "wb"
        self.fp = open(result_path, mode)
        self.info_fp = open(result_path + ".info", mode)
        self.write_dtype = write_dtype
        if not append:
            self.info_fp.write(struct.pack("<iiq", block_num, device_num, ref_count))
            self.info_fp.flush()
            # The reference's result/.info pair records no score dtype — an
            # int8 banded file is byte-indistinguishable from a half-done
            # int16 run of double the subjects. This additive sidecar (the
            # reference's tools ignore extra files) lets resume_point refuse
            # to graft a different kernel family's bytes; absent sidecar
            # (reference-written or pre-existing pairs) keeps the documented
            # fallback behavior.
            import json

            with open(result_path + ".run.json", "w") as f:
                json.dump({"write_dtype": np.dtype(write_dtype).name,
                           "ref_count": ref_count,
                           "block_num": block_num}, f)

    def start_bucket(self, device_counts: list[int], extra_count: int) -> None:
        """Record one database bucket's manifest entry (cal_cpu.c:350-352)."""
        self.info_fp.write(struct.pack(f"<{len(device_counts)}qi", *device_counts, extra_count))
        self.info_fp.flush()

    def write_scores(self, scores: np.ndarray) -> None:
        """Append one (query_bucket x subjects) score matrix, query-major."""
        self.fp.write(np.ascontiguousarray(scores, dtype=self.write_dtype).tobytes())

    def close(self) -> None:
        self.fp.close()
        self.info_fp.close()


def resume_point(result_path: str, ref_count: int, device_num: int = 1,
                 write_dtype=np.int16, ref_bucket_count: int = REF_BUCKET_COUNT,
                 expected_buckets=None) -> int:
    """Completed-bucket count for crash recovery; truncates partial tails.

    The result pair is append-only (the reference writes it incrementally but
    has no restart logic — SURVEY §5 checkpoint/resume: none). A bucket is
    complete when all its score bytes exist; the .info record is written
    before the scores, so after a crash the manifest may be one record ahead.
    Truncates both files to the last complete bucket and returns its index+1.

    ``expected_buckets``: the resuming run's (count_incl_pads, extra_count)
    per bucket (seqfile.bucket_counts()). A resume under a different
    ``--bucket-size`` (or a regenerated database) would otherwise count
    completed buckets in the *old* geometry's byte sizes, then skip that
    many *new*-geometry buckets and append a mismatched layout under the
    stale header — silently corrupt. Any geometry disagreement returns 0
    (fresh start; the writer overwrites both files), as does a result file
    larger than this run can produce (a completed int16 file resumed as
    int8 banded) or a ``.run.json`` sidecar recording a different dtype
    (a completed int8 banded file resumed as int16 — byte-indistinguishable
    from a half-done int16 run without the sidecar, which our writer drops
    next to every fresh pair; the reference's pair records no dtype, so for
    pairs without a sidecar that mix-up remains undetectable — don't reuse
    one result path across kernel families with --resume).
    """
    import os

    info_path = result_path + ".info"
    if not (os.path.exists(info_path) and os.path.exists(result_path)):
        return 0
    run_path = result_path + ".run.json"
    if os.path.exists(run_path):
        import json

        try:
            with open(run_path) as f:
                run = json.load(f)
        except (OSError, ValueError):
            run = {}
        if run.get("write_dtype", np.dtype(write_dtype).name) != np.dtype(write_dtype).name:
            return 0
    try:
        # allow_partial: a SIGKILL mid-run leaves fewer manifest records
        # than the header's block_num — the complete-record prefix is still
        # a valid resume point (restarting from scratch would discard every
        # finished bucket of, say, a 53-bucket 10M run).
        info = read_info(info_path, allow_partial=True)
    except Exception:
        return 0
    if info.ref_count != ref_count:
        return 0
    if expected_buckets is not None:
        if info.block_num != len(expected_buckets):
            return 0  # header block_num is kept verbatim in append mode
        if any(
            sum(counts) != exp_count or extra != exp_extra
            for counts, extra, (exp_count, exp_extra)
            in zip(info.device_read_counts, info.extra_counts, expected_buckets)
        ):
            return 0
    itemsize = np.dtype(write_dtype).itemsize
    result_size = os.path.getsize(result_path)
    # A result file larger than the whole run can produce is not a partial
    # run of THIS geometry/dtype — e.g. a completed int16 full-alignment
    # file being resumed as an int8 banded run would otherwise count every
    # bucket done, truncate to half the bytes, and convert to garbage.
    # Size the whole run from the resuming run's own geometry when we have
    # it: after a SIGKILL the manifest is a complete-record *prefix* (scores
    # run ahead of it), so summing its records would under-count and flag a
    # legitimately-ahead result file as oversized, discarding every finished
    # bucket. Without expected_buckets the guard only applies when the
    # manifest is complete.
    if expected_buckets is not None:
        total_need = sum(
            count * ref_count * itemsize for count, _ in expected_buckets
        )
    elif len(info.device_read_counts) == info.block_num:
        total_need = sum(
            sum(counts) * ref_count * itemsize
            for counts in info.device_read_counts
        )
    else:
        total_need = None
    if total_need is not None and result_size > total_need:
        return 0
    done = 0
    offset = 0
    for counts in info.device_read_counts:
        bucket_bytes = sum(counts) * ref_count * itemsize
        if offset + bucket_bytes > result_size:
            break
        offset += bucket_bytes
        done += 1
    with open(result_path, "r+b") as f:
        f.truncate(offset)
    with open(info_path, "r+b") as f:
        f.truncate(16 + done * (8 * info.device_num + 4))
    return done


def read_info(info_path: str, allow_partial: bool = False) -> InfoData:
    """Parse a ``.info`` manifest. With ``allow_partial`` (crash recovery),
    a manifest holding fewer records than the header's block_num yields the
    complete-record prefix instead of raising; a short header still raises."""
    try:
        with open(info_path, "rb") as f:
            block_num, device_num, ref_count = struct.unpack("<iiq", f.read(16))
            if block_num < 0 or device_num < 1 or ref_count < 0:
                raise ValueError(
                    f"{info_path}: implausible header (block_num={block_num}, "
                    f"device_num={device_num}, ref_count={ref_count})")
            counts, extras = [], []
            for _ in range(block_num):
                rec = f.read(8 * device_num + 4)
                if allow_partial and len(rec) < 8 * device_num + 4:
                    break
                row = struct.unpack(f"<{device_num}q", rec[: 8 * device_num])
                (extra,) = struct.unpack("<i", rec[8 * device_num :])
                counts.append(list(row))
                extras.append(extra)
    except struct.error as e:  # short read / truncated record
        raise ValueError(f"{info_path}: truncated or malformed .info ({e})") from e
    return InfoData(block_num, device_num, ref_count, counts, extras)


def infer_write_dtype(result_path: str,
                      ref_bucket_count: int = REF_BUCKET_COUNT):
    """int8 (banded) vs int16 (full) from file size / element count.

    The reference needs separately-compiled converters per family; the .info
    manifest pins the element count, so the byte size decides.
    """
    import os

    info = read_info(result_path + ".info")
    elements = info.ref_count * sum(
        sum(counts) for counts in info.device_read_counts
    )
    size = os.path.getsize(result_path)
    if elements and size == elements:
        return np.int8
    if elements and size == 2 * elements:
        return np.int16
    raise ValueError(
        f"{result_path}: {size} bytes does not match {elements} scores "
        "at int8 or int16 — pass the dtype explicitly"
    )


def convert_result(result_path: str, out_path: str, write_dtype=np.int16,
                   ref_bucket_count: int = REF_BUCKET_COUNT) -> None:
    """Reference-identical ``convert -r``: blocked binary -> text scores.

    Uses the native C++ walker (csrc/bgsa_native.cpp) when available — the
    per-line Python loop is the bottleneck at tens of millions of scores.
    """
    import os

    from .. import native

    if write_dtype is None:
        write_dtype = infer_write_dtype(result_path, ref_bucket_count)

    # Validate BEFORE the native walker: it computes offsets straight from
    # the manifest, so a truncated result file or corrupt .info would
    # SIGSEGV/terminate the process (and the Python memmap path would
    # silently emit fewer lines).
    info = read_info(result_path + ".info")
    itemsize = np.dtype(write_dtype).itemsize
    need = itemsize * info.ref_count * sum(
        sum(counts) for counts in info.device_read_counts
    )
    size = os.path.getsize(result_path)
    if size != need:
        raise ValueError(
            f"{result_path}: holds {size} bytes but the .info manifest "
            f"describes {need} (truncated result, wrong --banded flag, or "
            "mismatched manifest)"
        )

    if native.convert_result(result_path, out_path, itemsize,
                             ref_bucket_count):
        return
    data = np.memmap(result_path, dtype=write_dtype, mode="r")

    # Per-(block, device) matrix offsets in the blocked file layout.
    ref_buckets = []
    start = 0
    while start < info.ref_count:
        end = min(start + ref_bucket_count, info.ref_count)
        ref_buckets.append((start, end))
        start = end
    if not ref_buckets:
        ref_buckets = [(0, 0)]

    # offsets[j][(m, t)] -> element offset of that score matrix
    offsets: dict[tuple[int, int, int], int] = {}
    pos = 0
    for j in range(info.block_num):
        for m, (qs, qe) in enumerate(ref_buckets):
            for t in range(info.device_num):
                offsets[(j, m, t)] = pos
                pos += (qe - qs) * info.device_read_counts[j][t]

    with open(out_path, "w") as out:
        for m, (qs, qe) in enumerate(ref_buckets):
            for i in range(qs, qe):
                for j in range(info.block_num):
                    for t in range(info.device_num):
                        cnt = info.device_read_counts[j][t]
                        keep = cnt
                        if t == info.device_num - 1:
                            keep = cnt - info.extra_counts[j]
                        base = offsets[(j, m, t)] + (i - qs) * cnt
                        row = data[base : base + keep]
                        out.write("\n".join(str(int(v)) for v in row))
                        if keep:
                            out.write("\n")
