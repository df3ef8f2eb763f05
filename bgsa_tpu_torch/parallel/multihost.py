"""Multi-host orchestration: subject sharding and device-block result merge.

The reference's heterogeneous mode splits each subject bucket across CPU + N
Xeon Phis, writes per-device sub-blocks into one result file, and records the
per-device counts in the ``.info`` manifest (``original/BGSA_KNC/cal_all.c``,
``global.c:373-431 dispatch_task``). Our distributed analogue: hosts of a JAX
multi-host runtime play the "devices" role — each host scores a contiguous,
lane-aligned slice of every bucket and writes its own shard file; the merge
step interleaves the shards into the reference's exact blocked layout with
``total_device_number = n_hosts``. On homogeneous TPU hosts the even split
replaces the reference's measured-ratio balancer (R11) — a ratios argument
is still accepted for heterogeneous slices.

Runs without real multi-host hardware too: each "host" role can be executed
sequentially in one process (used by the tests), since the roles only share
files, never device state.

The port's own copy of ``bgsa_tpu.parallel.multihost``, same behaviour
and the same shard and sidecar bytes: the port's bucketed pipeline
(``pipeline.run_bucketed``) runs its shard, ``-D`` and resume branches
(``bgsa-torch-align --host``, ``-R``, ``-D``), ``bgsa-torch-merge`` merges
the shards, and ``parallel.hetero`` shares ``split_counts`` and
``DynamicBalancer``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io import result as result_io


def split_counts(total: int, n_hosts: int, v_num: int = 128, ratios=None) -> list[int]:
    """Per-host subject counts for one bucket: v_num-aligned, ratio-weighted.

    Mirrors dispatch_task (reference global.c:373-431): round each share down
    to a lane multiple, give the remainder to the last host.
    """
    if ratios is None:
        ratios = [1.0] * n_hosts
    weights = np.asarray(ratios, dtype=float)
    weights = weights / weights.sum()
    counts = []
    for h in range(n_hosts - 1):
        c = int(total * weights[h])
        c -= c % v_num
        counts.append(max(c, 0))
    counts.append(total - sum(counts))
    return counts


def host_slice(total: int, n_hosts: int, host_id: int, v_num: int = 128, ratios=None):
    """(start, count) of this host's slice of a bucket."""
    counts = split_counts(total, n_hosts, v_num, ratios)
    start = sum(counts[:host_id])
    return start, counts[host_id]


@dataclasses.dataclass
class ShardMeta:
    """What one host contributes per bucket (host-local manifest)."""

    host_id: int
    n_hosts: int
    ref_count: int
    block_counts: list[int]  # this host's subject count per bucket
    extra_counts: list[int]  # pads (only the last host carries pads)
    dtype: str = "int16"  # score element type of the shard file
    # Run geometry (0 = written by a pre-round-3 sidecar): resuming under a
    # different --bucket-size or a regenerated database would skip
    # done_buckets of the *new* geometry while the recorded splits cover
    # *old*-geometry buckets — shard_resume_point refuses on mismatch.
    seqs_per_bucket: int = 0
    db_subjects: int = 0
    # Normalized split weights of the static -R run (None = legacy sidecar
    # or dynamic mode): a resume under different ratios would compute a
    # different slice of every remaining bucket than the peers did, and the
    # merge would interleave overlapping/gapped slices silently.
    ratios: list | None = None

    def save(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "ShardMeta":
        import json

        with open(path) as f:
            try:
                return cls(**json.load(f))
            except (TypeError, ValueError) as e:
                # wrong JSON shape / missing or unknown keys -> TypeError;
                # surface both as the malformed-sidecar error CLI callers
                # already report cleanly
                raise ValueError(f"{path}: malformed shard sidecar ({e})") from e


def normalized_ratios(ratios, n_hosts: int) -> list[float]:
    """Ratio vector reduced to comparable form (None = even split)."""
    if ratios is None:
        ratios = [1.0] * n_hosts
    total = float(sum(ratios))
    return [float(r) / total for r in ratios]


def shard_resume_point(result_path: str, meta_path: str, ref_count: int,
                       write_dtype, n_hosts: int, host_id: int,
                       seqs_per_bucket: int = 0,
                       db_subjects: int = 0,
                       ratios=None) -> tuple[int, "ShardMeta | None"]:
    """Completed-bucket count for a raw shard file (the --host role's
    crash recovery). The incrementally-saved ShardMeta sidecar records the
    per-bucket split actually used (which may vary under dynamic balancing);
    the file size arbitrates how many of those buckets completed, and the
    file is truncated to that boundary.

    Returns (done_buckets, meta) — meta is None for a fresh start. Refuses
    (ValueError) when the sidecar is missing or disagrees with the resume
    parameters: guessing the split risks appending misaligned data.
    """
    import os

    if not os.path.exists(result_path):
        return 0, None
    if not os.path.exists(meta_path):
        raise ValueError(
            f"cannot resume {result_path}: sidecar {meta_path} is missing, so "
            "the bucket split used by the interrupted run is unknown — delete "
            "the shard file to start over"
        )
    meta = ShardMeta.load(meta_path)
    dtype = np.dtype(write_dtype)
    want_ratios = normalized_ratios(ratios, n_hosts)
    for field, want, got in (
        ("host", host_id, meta.host_id),
        ("host count", n_hosts, meta.n_hosts),
        ("query count", ref_count, meta.ref_count),
        ("dtype", dtype.name, meta.dtype),
        ("bucket size (subjects)",
         seqs_per_bucket, meta.seqs_per_bucket or seqs_per_bucket),
        ("database subject count",
         db_subjects, meta.db_subjects or db_subjects),
        # a resume under different -R ratios would slice every remaining
        # bucket differently than the peers — silently corrupt after merge
        ("split ratios (-R)",
         want_ratios, meta.ratios if meta.ratios is not None else want_ratios),
    ):
        if want != got:
            raise ValueError(
                f"cannot resume {result_path}: {field} mismatch (shard was "
                f"written with {got}, resume requested {want})"
            )
    size = os.path.getsize(result_path)
    off = 0
    done = 0
    for count in meta.block_counts:
        nbytes = count * ref_count * dtype.itemsize
        if off + nbytes <= size:
            off += nbytes
            done += 1
        else:
            break
    del meta.block_counts[done:]
    del meta.extra_counts[done:]
    with open(result_path, "r+b") as f:
        f.truncate(off)
    return done, meta


def read_ratio_file(path: str, n: int) -> list[float]:
    """Reference ``-R`` file: n whitespace-separated positive floats
    (``original/BGSA_KNC/global.c:35-53``)."""
    with open(path) as f:
        vals = [float(tok) for tok in f.read().split()]
    if len(vals) < n:
        raise ValueError(f"ratio file {path}: need {n} values, found {len(vals)}")
    vals = vals[:n]
    if any(v <= 0 for v in vals):
        raise ValueError("device ratio can't be zero or negative")
    return vals


def merge_shards(result_path: str, shard_paths: list[str], metas: list[ShardMeta],
                 write_dtype=np.int16, ref_bucket_count: int = result_io.REF_BUCKET_COUNT):
    """Interleave per-host shard files into the reference's blocked layout.

    Each shard file holds, for every (bucket, query-bucket), a query-major
    score matrix over that host's slice — the merged file holds the same
    matrices interleaved host-by-host, which is exactly the reference's
    multi-device layout (convert.c:228-268).
    """
    if len(shard_paths) != len(metas):
        raise ValueError(
            f"merge: {len(shard_paths)} shard paths but {len(metas)} metas"
        )
    # sort paths WITH their metas — sorting metas alone would silently
    # mispair a caller's out-of-host-order shard list
    order = sorted(range(len(metas)), key=lambda i: metas[i].host_id)
    metas = [metas[i] for i in order]
    shard_paths = [shard_paths[i] for i in order]
    n_hosts = metas[0].n_hosts
    ids = [m.host_id for m in metas]
    if len(metas) != n_hosts or ids != list(range(n_hosts)):
        raise ValueError(
            f"merge: need exactly hosts 0..{n_hosts - 1}, got {ids} — a "
            "duplicated or missing shard would silently corrupt the layout"
        )
    ref_count = metas[0].ref_count
    block_num = len(metas[0].block_counts)
    for m in metas[1:]:
        for field, want, got in (
            ("n_hosts", n_hosts, m.n_hosts),
            ("query count", ref_count, m.ref_count),
            ("bucket count", block_num, len(m.block_counts)),
            ("dtype", metas[0].dtype, m.dtype),
            # run-geometry identity (0/None = legacy sidecar, skip): shards
            # of two different databases or bucket sizes can otherwise agree
            # on every count above and interleave silently wrong
            ("database subject count", metas[0].db_subjects or m.db_subjects,
             m.db_subjects or metas[0].db_subjects),
            ("bucket size (subjects)",
             metas[0].seqs_per_bucket or m.seqs_per_bucket,
             m.seqs_per_bucket or metas[0].seqs_per_bucket),
        ):
            if want != got:
                raise ValueError(
                    f"merge: shard {m.host_id}: {field} {got} != {want} "
                    "(shards from different runs?)"
                )
    itemsize = np.dtype(write_dtype).itemsize

    import os

    for p, m in zip(shard_paths, metas):
        want = sum(m.block_counts) * ref_count * itemsize
        have = os.path.getsize(p)
        if have != want:
            raise ValueError(
                f"shard {p}: {have} bytes but meta implies {want} "
                f"({sum(m.block_counts)} subjects x {ref_count} queries x "
                f"{np.dtype(write_dtype).name}) — wrong dtype or truncated shard"
            )
    shards = [
        np.memmap(p, dtype=write_dtype, mode="r")
        if os.path.getsize(p)
        else np.zeros(0, dtype=write_dtype)  # host contributed no lanes
        for p in shard_paths
    ]
    offsets = [0] * n_hosts

    ref_buckets = []
    start = 0
    while start < ref_count:
        end = min(start + ref_bucket_count, ref_count)
        ref_buckets.append(end - start)
        start = end

    with open(result_path, "wb") as out, open(result_path + ".info", "wb") as info:
        import struct

        info.write(struct.pack("<iiq", block_num, n_hosts, ref_count))
        for j in range(block_num):
            counts = [m.block_counts[j] for m in metas]
            extra = metas[-1].extra_counts[j]
            info.write(struct.pack(f"<{n_hosts}qi", *counts, extra))
        for j in range(block_num):
            for nq in ref_buckets:
                for h in range(n_hosts):
                    cnt = metas[h].block_counts[j] * nq
                    out.write(shards[h][offsets[h] : offsets[h] + cnt].tobytes())
                    offsets[h] += cnt


def run_token(query_path: str, db_path: str, n_hosts: int,
              ratios=None, bucket_size: int | None = None) -> str:
    """Run-identity token namespacing the -D time files.

    Every host must derive the same token for the same run, so it hashes
    the input files' *content fingerprint* (size + head/tail 64 KB), never
    their names or mtimes — hosts may hold per-host copies of the inputs,
    and the CLI's FASTA/FASTQ auto-conversion writes each process its own
    randomly-named temp file (identical bytes on every host). Host count,
    initial ratios, and bucket size join the hash because they change the
    schedule. Stale time files from a *different* previous run in a reused
    sync_dir then never match, so a late-starting host cannot consume a
    dead run's times and fork the schedule. The one residual collision —
    re-running byte-identical inputs into the same sync_dir — needs a
    fresh ``--sync-dir`` (documented on the CLI flag).
    """
    import hashlib
    import os

    h = hashlib.sha1()
    for p in (query_path, db_path):
        size = os.path.getsize(p)
        h.update(f"|{size}|".encode())
        with open(p, "rb") as f:
            h.update(f.read(65536))
            if size > 65536:
                # tail 64 KB (overlaps the head for files under 128 KB, so
                # every byte of small files is covered)
                f.seek(max(size - 65536, 0))
                h.update(f.read(65536))
    # explicit field separators: without them distinct configs concatenate
    # to the same byte stream (e.g. n_hosts=2,bucket=1024 vs ratios=[1024.])
    h.update(f"|{n_hosts}|".encode())
    h.update(",".join(f"{float(r):.17g}" for r in (ratios or [])).encode())
    h.update(f"|{bucket_size if bucket_size is not None else ''}".encode())
    return h.hexdigest()[:12]


def hello_path(sync_dir: str, host_id: int, token: str = "") -> str:
    tag = f".{token}" if token else ""
    return f"{sync_dir}/bgsa{tag}.hello.host{host_id}"


# A hello older than this is treated as stale (a crashed previous run's
# leftover — with content-based tokens, identical re-runs reuse the token):
# hosts refresh their hello's mtime at every bucket-time publish, so a live
# peer's hello is at most one bucket period old plus its initial compile.
HELLO_FRESH_SECS = 3600.0


def write_hello(sync_dir: str, host_id: int, token: str = "") -> None:
    """Announce this role's start (written before any compile work): peers
    use it to distinguish a host that never launched (fail fast) from one
    that is alive but inside a multi-minute compile episode (wait longer).
    Refreshed (mtime) on every bucket-time publish."""
    with open(hello_path(sync_dir, host_id, token), "w") as f:
        f.write("1\n")


def _hello_alive(sync_dir: str, host_id: int, token: str) -> bool:
    import os
    import time as _time

    try:
        return _time.time() - os.path.getmtime(
            hello_path(sync_dir, host_id, token)
        ) < HELLO_FRESH_SECS
    except OSError:
        return False


def bucket_time_path(sync_dir: str, bucket: int, host_id: int,
                     token: str = "") -> str:
    tag = f".{token}" if token else ""
    return f"{sync_dir}/bgsa{tag}.bucket{bucket}.host{host_id}.time"


def write_bucket_time(sync_dir: str, bucket: int, host_id: int, seconds: float,
                      token: str = "") -> None:
    """Publish this host's measured compute time for one bucket (atomic,
    first write wins: a resumed host re-running a bucket must not rewrite a
    time its peers already consumed — the ratio schedule is append-only)."""
    import os

    path = bucket_time_path(sync_dir, bucket, host_id, token)
    try:
        # keep this host's hello fresh (peers gauge liveness by its mtime)
        os.utime(hello_path(sync_dir, host_id, token))
    except OSError:
        pass
    if os.path.exists(path):
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{seconds:.17g}\n")
    os.replace(tmp, path)


def read_bucket_times(sync_dir: str, bucket: int, n_hosts: int,
                      timeout: float = 120.0, poll: float = 0.05,
                      token: str = "", grace_factor: float = 10.0) -> list[float]:
    """Wait for every host's time file for one bucket and return the times.

    The dynamic mode's host synchronization point — the distributed analogue
    of the reference's per-bucket OpenMP join before ``adjust_device_ratio3``
    (``original/BGSA_KNC/cal_all.c:1312-1332``). Full-precision text keeps the
    ratio schedule bit-identical on every host.

    A peer that has announced itself (its hello file exists — write_hello)
    gets ``grace_factor`` times longer: a first nvcc build of the kernel
    library legitimately delays the first bucket's publish, and killing a
    healthy run as a "dead peer" is worse than waiting. A peer with no hello file never launched — that
    fails at the base ``timeout``.
    """
    import os
    import time as _time

    start = _time.monotonic()
    times: list[float] = []
    for h in range(n_hosts):
        path = bucket_time_path(sync_dir, bucket, h, token)
        alive = False  # sticky once observed: hellos are never deleted mid-run
        while not os.path.exists(path):
            alive = alive or _hello_alive(sync_dir, h, token)
            limit = timeout * grace_factor if alive else timeout
            if _time.monotonic() - start >= limit:
                state = ("started but stalled for" if alive
                         else "never announced itself (fresh hello) within")
                raise TimeoutError(
                    f"dynamic balancing: host {h} {state} {limit:.0f}s "
                    f"waiting on its time for bucket {bucket} ({path}) — "
                    "did its role crash? (re-run that role with --resume, "
                    "or restart all roles with a fresh --sync-dir; the "
                    "wait is --sync-timeout, x10 once a host's hello file "
                    "exists)"
                )
            _time.sleep(poll)
        with open(path) as f:
            times.append(float(f.read()))
    return times


def clear_bucket_times(sync_dir: str, host_id: int, token: str = "") -> None:
    """Remove this host's stale time files (fresh, non-resume runs)."""
    import glob
    import os

    tag = f".{token}" if token else ""
    for p in glob.glob(f"{sync_dir}/bgsa{tag}.bucket*.host{host_id}.time"):
        os.unlink(p)


class DynamicBalancer:
    """Measured-time ratio adaptation (the reference's ``-D`` mode).

    Recency-weighted moving average over per-bucket compute times, following
    ``adjust_device_ratio3`` (reference ``original/BGSA_KNC/global.c:120-168``):
    each round, scale every host's ratio by ``t_host0 / t_host``; from round 3
    on, blend with the ratio history from round 2 onward weighted by round
    index (newer rounds count more; the C's history loop starts at slot 1,
    skipping round 1's entry); host 0's ratio is pinned to 1. Bit-exact
    against the compiled C — pinned by ``tests/golden/balancer_trace.json``,
    traces from a harness around the verbatim reference function with the
    driver's zero-initialized history and ``time_index++``-per-call semantics
    (``cal_all.c:971-980,1312,1332``). Even splits are optimal on homogeneous
    TPU slices — this exists for heterogeneous deployments (mixed chip
    generations, or chips sharing hosts with other work).
    """

    def __init__(self, n_hosts: int, initial_ratios=None):
        self.n_hosts = n_hosts
        self.ratios = list(initial_ratios) if initial_ratios else [1.0] * n_hosts
        self.history: list[list[float]] = []

    def update(self, times) -> list[float]:
        """Feed one bucket's per-host compute times; returns the new ratios."""
        times = [max(float(t), 1e-9) for t in times]
        round_idx = len(self.history) + 1
        scaled = [1.0] + [
            self.ratios[i] * times[0] / times[i] for i in range(1, self.n_hosts)
        ]
        if round_idx == 1:
            self.ratios = scaled
        else:
            total = 0
            acc = [0.0] * self.n_hosts
            for i, past in enumerate(self.history[1:], start=1):
                for j in range(1, self.n_hosts):
                    acc[j] += past[j] * (i + 1)
                total += i + 1
            total += round_idx
            self.ratios = [1.0] + [
                (acc[j] + scaled[j] * round_idx) / total for j in range(1, self.n_hosts)
            ]
        self.history.append(list(self.ratios))
        return list(self.ratios)
