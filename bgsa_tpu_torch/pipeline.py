"""Bucketed alignment pipeline on torch devices: read -> pack -> kernel -> result file.

``run_bucketed`` is the port's own copy of ``bgsa_tpu.pipeline.run_bucketed``
(the reader thread, lag-1 drain, the reference-identical result/``.info``
writer, host-role shard files, ``-D`` and resume; each bucket is scored at
its own row count, with no shape pad), with the port's ``PipelineConfig``.
It drives an ``Engine`` (or a subclass such as
``banded_pipeline.BandedEngine``): ``warm`` once before the first bucket,
then ``scores_packed`` and ``take_counts`` for each query bucket.
This module supplies the engine: the host packs each bucket
(``pack.select_transport``), the payload is uploaded, unpacked and
Eq-packed on the device, and the scheme's kernel scores it: the Myers
kernel for unit-cost schemes, a BitPAl kernel (packed or not, built for the
scheme) for general integer scoring.

Local multi-device sharding (``PipelineConfig.local_shards``, or an explicit
``devices=`` list) is the counterpart of ``bgsa_tpu.pipeline._local_mesh``
and ``_shard_map_step``: subjects split into equal row slices, one per
device, queries on every device, unpack, pack and kernel shard-local, no
collectives. A device may repeat in ``devices=``, which runs the split on
one device (the tests' ``[cpu] * 8``, like the JAX tests' 8 virtual CPU
devices).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from . import pack
from .io import result as result_io
from .io import seqfile
from .ops import build
from .ops.bitpal import BitpalParams, bitpal
from .ops.bitpal_packed import bitpal_packed, packed_supported
from .ops.myers_semiglobal import myers_semiglobal
from .schemes import (Algorithm, Mode, NormalizedScheme, Scoring, check_type, normalize)
from .stats import LaunchCounts, RunStats, Span

# Default database bucket: a quarter of the reference's READ_BUCKET_SIZE, as
# in bgsa_tpu, so that result and .info files (whose blocking follows the
# bucket size) are byte-equal to bgsa_tpu's.
BUCKET_SIZE = seqfile.DEFAULT_BUCKET_SIZE // 4


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Run settings: ``bgsa_tpu.pipeline.PipelineConfig`` without
    ``backend``, ``interpret`` and ``rows_per_block``, which pick and size
    the JAX package's Pallas/XLA paths: the port's tensors' device picks
    kernel or plain version, and its kernels take any subject count."""

    bucket_size: int = BUCKET_SIZE
    ref_bucket_count: int = seqfile.REF_BUCKET_COUNT
    v_num: int = 128  # subject pad unit (the .info layout follows it)
    prefetch: int = 2
    local_shards: int = 1  # 1 = single device; 0 = all local devices; n = first n
    # Host packing threads (the reference's -N OpenMP fan-out over
    # handle_reads); 0 = all cores. Only the native packers fan out.
    host_threads: int = 0
    # Dynamic (-D) split granularity: host slices are aligned to
    # seqs_per_bucket/dynamic_grid, so at most dynamic_grid distinct shapes
    # are scored.
    dynamic_grid: int = 8
    # -D: how long to wait for a peer's per-bucket time file before failing
    # the run with a clear error.
    sync_timeout: float = 120.0
    # Packed bit-plane BitPAl (same scores; non-packed where the packed
    # decode does not apply).
    bitpal_packed: bool = True
    # Full 32-bit-word BitPAl with compare-carry adds; None = per route
    # (31-bit packed, 32-bit non-packed), True/False force 32/31 bits.
    bitpal_carry: bool | None = None
    # Subject-interleaved packed banded kernel where the band is narrow
    # enough (same scores; the stream kernel elsewhere).
    banded_packed: bool = True


def _pack_threads(config) -> int:
    """Resolved host packing thread count (-N; 0 = all cores)."""
    import os

    return config.host_threads or (os.cpu_count() or 1)


def local_devices(local_shards: int, device="cuda") -> list[torch.device]:
    """The devices of ``--shards`` (``bgsa_tpu.pipeline._local_mesh``): 1 =
    ``device`` alone; 0 = every local device of its type; n = the first n,
    and more than are visible raises. The CPU counts as one local device."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if local_shards == 1:
        return [device]
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    n = max(visible if local_shards == 0 else local_shards, 1)
    if n > visible:
        # The reference errors when more devices are requested than exist
        # (original/BGSA_KNC/main.c:145-153); truncating while keeping
        # n_shards would mis-place the pre-split sidecar rows.
        raise ValueError(
            f"--shards {n} exceeds the {visible} visible local "
            f"device(s); use --shards 0 for all local devices"
        )
    if device.type == "cpu":
        return [device]
    return [torch.device("cuda", i) for i in range(n)]


class DeviceScores:
    """(Q, S) scores on the device(s), in the shape ``run_bucketed`` drains:
    one tensor per shard, the shards' subjects in order. Indexing stays on
    the device (``[0, 0]`` is the first shard's first score, on its
    device); ``np.asarray`` synchronizes each shard, copies it to the host
    and concatenates them along S (``np.asarray`` on a CUDA tensor itself
    raises)."""

    def __init__(self, shards):
        self.shards = [shards] if isinstance(shards, torch.Tensor) else list(shards)

    def __getitem__(self, index) -> DeviceScores:
        if len(self.shards) == 1:
            return DeviceScores(self.shards[0][index])
        row, col = index  # one score, on its shard's device
        for shard in self.shards:
            if col < shard.shape[1]:
                return DeviceScores(shard[row, col])
            col -= shard.shape[1]
        raise IndexError(f"subject {index[1]} out of range")

    def __array__(self, dtype=None, copy=None):
        hosts = [shard.cpu().numpy() for shard in self.shards]
        host = hosts[0] if len(hosts) == 1 else np.concatenate(hosts, axis=-1)
        return host if dtype is None else host.astype(dtype, copy=False)


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host
    # pinned staging lets the copy queue behind the previous bucket's kernel
    # instead of blocking the host until it finishes
    return host.pin_memory().to(device, non_blocking=True)


def bitpal_packed_route(scheme: NormalizedScheme, bitpal_packed: bool = True) -> bool:
    """Whether a BitPAl run takes the packed kernel: the one predicate behind
    ``Engine.word_bits`` and ``Engine.kernel``, as
    ``bgsa_tpu.pipeline.bitpal_packed_route`` is behind the JAX engine's.
    False: the non-packed kernel (user opt-out, or a scheme the packed
    decode cannot serve, M > 2I - 2G + 1)."""
    if scheme.algorithm is not Algorithm.BITPAL or not bitpal_packed:
        return False
    return packed_supported(BitpalParams(scheme.match, scheme.mismatch, scheme.gap))


class Engine:
    """Scoring step for one Myers or BitPAl scheme on one or more torch devices.

    Counterpart of ``bgsa_tpu.pipeline.Engine``: Myers schemes in full
    32-bit words in both modes; BitPAl schemes on the packed kernel where it
    applies and ``config.bitpal_packed`` allows, else the non-packed one, in
    the word layout ``config.bitpal_carry`` picks. The devices are
    ``local_devices(config.local_shards, device)``, or ``devices`` where it
    is given (repeats allowed); ``n_shards`` is their count. Subclasses
    score other families by overriding ``score_codes`` and ``result_dtype``
    (``banded_pipeline.BandedEngine``).
    """

    result_dtype = torch.int16

    def __init__(self, scheme: NormalizedScheme, config: PipelineConfig = PipelineConfig(),
                 device="cuda", *, devices=None):
        check_type(scheme, NormalizedScheme, "scheme")
        if scheme.algorithm is Algorithm.BITPAL:
            BitpalParams(scheme.match, scheme.mismatch, scheme.gap)  # M > I > 2G
        elif scheme.algorithm is not Algorithm.MYERS:
            raise ValueError(f"{scheme.algorithm.value} schemes run through "
                             "banded_pipeline.BandedEngine, not Engine")
        self.scheme = scheme
        self._set_devices(config, device, devices)

    @property
    def kernel(self) -> str:
        """The kernel that scores this engine's scheme: "myers_semiglobal",
        "bitpal_packed" or "bitpal"."""
        if self.scheme.algorithm is Algorithm.MYERS:
            return "myers_semiglobal"
        return "bitpal_packed" if bitpal_packed_route(
            self.scheme, self.config.bitpal_packed) else "bitpal"

    @property
    def word_bits(self) -> int:
        """Eq word layout: 32 for Myers; for BitPAl 32-bit compare-carry or
        31-bit reserved-carry words, as ``bgsa_tpu.pipeline.Engine.word_bits``
        picks them (``bitpal_carry=None``: 31 on the packed route, 32 on the
        non-packed one; True/False force 32/31)."""
        if self.scheme.algorithm is not Algorithm.BITPAL:
            return 32
        carry = self.config.bitpal_carry
        if carry is None:
            carry = self.kernel == "bitpal"
        return 32 if carry else 31

    def _set_devices(self, config: PipelineConfig, device, devices) -> None:
        check_type(config, PipelineConfig, "config")
        self.config = config
        if devices is None:
            self.devices = local_devices(config.local_shards, device)
        else:
            self.devices = [torch.device(d) for d in devices]
            if not self.devices:
                raise ValueError("devices is empty")
            for d in self.devices:
                if d.type not in ("cpu", "cuda"):
                    raise ValueError(f"unsupported device {d}")
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        self.counts = LaunchCounts()

    def take_counts(self) -> LaunchCounts:
        """The kernel launches' counts since the last call, which resets them."""
        counts, self.counts = self.counts, LaunchCounts()
        return counts

    def warm(self) -> None:
        """Build and load the kernel's library and create each CUDA device's
        context before the first timed bucket, so the nvcc build is billed to
        compile_time, not cal_time. One library serves every geometry (the
        main one for Myers and banded, the scheme's own for BitPAl), so one
        call a run is enough; a CPU engine has nothing to warm."""
        cuda = [d for d in self.devices if d.type == "cuda"]
        if cuda:
            self.load_library()
            for d in dict.fromkeys(cuda):
                torch.empty(0, device=d)  # create each device's CUDA context here too

    def load_library(self) -> build.Kernels:
        """Build (on first use) and load the library of this engine's kernel."""
        if self.kernel == "myers_semiglobal":
            return build.load()
        s = self.scheme
        return build.load_scheme(self.kernel, s.match, s.mismatch, s.gap)

    def score_codes(self, queries: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """(Q, m) query codes x (S, n) subject codes, both on one device ->
        (Q, S) int32 scores."""
        s, word_bits = self.scheme, self.word_bits
        with Span("eq_pack"):
            eq = pack.pack_eq(codes, word_bits)
        with Span("kernel"):
            if s.algorithm is Algorithm.MYERS:
                return myers_semiglobal(
                    eq, queries, read_len=codes.shape[1], factor=s.factor,
                    is_global=s.mode is Mode.GLOBAL, counts=self.counts,
                )
            kernel = bitpal_packed if self.kernel == "bitpal_packed" else bitpal
            return kernel(eq, queries, match=s.match, mismatch=s.mismatch, gap=s.gap,
                          read_len=codes.shape[1], factor=s.factor,
                          semi_global=s.mode is Mode.SEMI_GLOBAL, word_bits=word_bits,
                          counts=self.counts)

    def scores_packed(self, query_codes: np.ndarray, transport: str, payload, s_len: int):
        """Score a transport-packed subject batch (``pack.select_transport``
        with ``n_shards=self.n_shards``) -> DeviceScores of (Q, S)
        ``result_dtype``. Every leaf of the payload (both of a "2bitN" one)
        splits into ``n_shards`` equal row slices, one per device."""
        n = self.n_shards
        leaves = payload if isinstance(payload, tuple) else (payload,)
        for leaf in leaves:
            if leaf.shape[0] % n:
                raise ValueError(f"{leaf.shape[0]} payload rows do not split into "
                                 f"{n} equal shards")
        unpack = pack.transport_unpack(transport)
        queries = np.asarray(query_codes, np.uint8)
        shards = []
        for i, dev in enumerate(self.devices):
            with Span("upload"):
                part = tuple(_upload(leaf[i * (len(leaf) // n):(i + 1) * (len(leaf) // n)], dev)
                             for leaf in leaves)
                dev_queries = _upload(queries, dev)
            with Span("unpack"):
                codes = unpack(part if isinstance(payload, tuple) else part[0], s_len)
            scores = self.score_codes(dev_queries, codes)
            with Span("narrow"):
                shards.append(scores.to(self.result_dtype))
        return DeviceScores(shards)

    def scores(self, query_codes: np.ndarray, subject_codes: np.ndarray):
        """(Q, m) x (S, n) codes -> DeviceScores of (Q, S) ``result_dtype``.
        S must split into ``n_shards`` equal slices."""
        with Span("transport_pack"):
            transport, payload = pack.select_transport(
                subject_codes, n_shards=self.n_shards, threads=_pack_threads(self.config)
            )
        with Span("dispatch"):
            return self.scores_packed(query_codes, transport, payload, subject_codes.shape[1])


def run_alignment(
    query_path: str,
    db_path: str,
    result_path: str,
    scoring: Scoring = Scoring(0, -1, -1),
    mode: Mode = Mode.GLOBAL,
    config: PipelineConfig = PipelineConfig(),
    shard: tuple[int, int] | None = None,
    shard_ratios=None,
    resume: bool = False,
    dynamic: bool = False,
    sync_dir: str | None = None,
    *,
    device="cuda",
    devices=None,
):
    """Full aligner run with the reference's CLI semantics; returns RunStats.

    ``bgsa_tpu.pipeline.run_alignment`` on torch devices: unit-cost
    schemes on the Myers kernel, general integer scoring on BitPAl
    (``config.bitpal_packed``, ``config.bitpal_carry`` as there), over
    ``config.local_shards`` devices or the ``devices`` given.

    With ``shard=(host_id, n_hosts)`` this process plays one host role of a
    multi-host run: it scores its lane-aligned slice of every bucket
    (weighted by ``shard_ratios``, the reference's ``-R``) and writes a raw
    shard file plus a ShardMeta (merge with
    ``parallel.multihost.merge_shards``). Returns (stats, meta) in that case.

    ``dynamic=True`` (the reference's ``-D``) re-splits every bucket from the
    hosts' measured per-bucket times, exchanged through ``sync_dir`` (default:
    the result file's directory); it requires ``shard``.

    ``resume=True`` continues an interrupted run: completed buckets (found in
    the existing result/.info pair or shard and sidecar, partial tails
    truncated) are skipped.
    """
    with Span("engine"):
        engine = Engine(normalize(scoring, mode), config, device, devices=devices)
    return run_bucketed(
        engine, query_path, db_path, result_path, config,
        shard=shard, shard_ratios=shard_ratios, resume=resume,
        write_dtype=np.int16, dynamic=dynamic, sync_dir=sync_dir,
    )


class _ReaderFailed:
    """Queue sentinel: the reader thread died with this exception."""

    def __init__(self, error: BaseException):
        self.error = error


def run_bucketed(
    engine: Engine,
    query_path: str,
    db_path: str,
    result_path: str,
    config: PipelineConfig,
    *,
    shard: tuple[int, int] | None,
    shard_ratios,
    resume: bool,
    write_dtype,
    dynamic: bool = False,
    sync_dir: str | None = None,
):
    """Shared bucketed driver for every kernel family (Myers/BitPAl/banded).

    ``engine`` is an ``Engine`` or a subclass. Where a bucket is left to
    score, its ``warm()`` runs once, billed to compile_time, before the
    reader thread starts; then each bucket (or this host's slice of it) is
    transport-packed once and scored by ``scores_packed`` for each query
    bucket, with ``take_counts()`` added to the stats after each.
    Handles bucketing, the reader prefetch thread, lag-1 result draining,
    reference result/.info writing, host-role shard files, dynamic
    re-splitting (-D), and resume for both modes.
    """
    import os

    if dynamic and shard is None:
        raise ValueError("dynamic balancing requires shard=(host_id, n_hosts)")
    stats = RunStats()
    t_start = time.perf_counter()
    # Test hook: per-host artificial slowdown for dynamic-balancing tests.
    _test_sleep = float(os.environ.get("BGSA_TEST_BUCKET_SLEEP", "0") or 0)

    v_num = config.v_num * engine.n_shards
    with Span("open", stats, "read_time"):
        queries = seqfile.read_queries(query_path)
        # A single host scores whole buckets, so the reader thread packs
        # each one's transport payload; a host role slices the bucket first,
        # and packs its slice on this thread.
        db = seqfile.DatabaseReader(
            db_path, config.bucket_size, v_num, stats,
            transport_shards=engine.n_shards if shard is None else None,
            threads=_pack_threads(config),
        )

    # Everything between the open and the reader thread's start: query
    # buckets, the writer or shard role, the warm-up.
    with Span("setup"):
        stats.query_count, stats.query_len = queries.shape
        stats.subject_len = db.length

        q_buckets = [
            queries[s : s + config.ref_bucket_count]
            for s in range(0, len(queries), config.ref_bucket_count)
        ]

        # No shape pad: each bucket (or host slice) goes to the engine with the
        # rows the reader produced, 'N' lane pads included. The port's kernels
        # take any subject count from one library, so a tail bucket compiles
        # nothing new; rows stay a multiple of v_num (lanes x n_shards), which
        # scores_packed's equal shard split needs.

        meta = None
        meta_path = result_path + ".meta.json"
        done_buckets = 0
        if shard is not None:
            from .parallel.multihost import ShardMeta, host_slice, shard_resume_point

            host_id, n_hosts = shard
            from .parallel.multihost import normalized_ratios

            # Static -R splits are resume-critical (a different ratio vector
            # re-slices every remaining bucket); dynamic mode's schedule is
            # protected by the run token instead, so its sidecar records None.
            static_ratios = None if dynamic else normalized_ratios(shard_ratios, n_hosts)
            if resume:
                done_buckets, meta = shard_resume_point(
                    result_path, meta_path, len(queries),
                    np.dtype(write_dtype), n_hosts, host_id,
                    seqs_per_bucket=db.seqs_per_bucket,
                    db_subjects=db.total_count,
                    ratios=None if dynamic else shard_ratios,
                )
                if meta is not None:
                    stats.subject_count += sum(
                        c - e for c, e in zip(meta.block_counts, meta.extra_counts)
                    )
            if meta is None:
                meta = ShardMeta(
                    host_id, n_hosts, len(queries), [], [],
                    dtype=np.dtype(write_dtype).name,
                    seqs_per_bucket=db.seqs_per_bucket,
                    db_subjects=db.total_count,
                    ratios=static_ratios,
                )
            writer_fp = open(result_path, "ab" if done_buckets else "wb")
            if dynamic:
                # Live re-splitting (the reference's -D, cal_on_all_dynamic,
                # original/BGSA_KNC/cal_all.c:772-1487): each bucket's split comes
                # from the measured per-host times of the previous bucket,
                # exchanged as files in sync_dir; every host replays the same
                # published times, so the ratio schedule is bit-identical on all
                # of them. Slices are aligned to `chunk` (seqs_per_bucket /
                # dynamic_grid lanes), which the schedule and the shard files
                # follow.
                from .parallel import multihost as mh

                sync_dir = sync_dir or (os.path.dirname(result_path) or ".")
                # an explicit --sync-dir need not pre-exist (every host creates
                # it; makedirs is atomic-enough for concurrent roles)
                os.makedirs(sync_dir, exist_ok=True)
                # Time files carry a run-identity token so a reused sync_dir's
                # stale files from a previous (different) run can never be read
                # as this run's times (which would silently fork the schedule
                # across hosts).
                sync_token = mh.run_token(
                    query_path, db_path, n_hosts, shard_ratios, config.bucket_size
                )
                chunk = v_num
                if db.bucket_count > 1:
                    chunk = v_num * max(
                        1, -(-db.seqs_per_bucket // (v_num * config.dynamic_grid))
                    )
                balancer = mh.DynamicBalancer(n_hosts, initial_ratios=shard_ratios)
                # Announce this role before the warm-up: a first nvcc build of
                # the kernel library can outlast the base dead-peer timeout, and
                # peers wait 10x longer for a host that has said hello
                # (read_bucket_times).
                mh.write_hello(sync_dir, host_id, sync_token)
                if done_buckets:
                    for b in range(done_buckets):
                        if not os.path.exists(
                            mh.bucket_time_path(sync_dir, b, host_id, sync_token)
                        ):
                            # Crashed after writing bucket b's scores but before
                            # publishing its time; peers are still blocked on this
                            # file, so a neutral re-publish keeps everyone moving
                            # on one consistent schedule.
                            mh.write_bucket_time(sync_dir, b, host_id, 1.0,
                                                 token=sync_token)
                        balancer.update(mh.read_bucket_times(
                            sync_dir, b, n_hosts, timeout=config.sync_timeout,
                            token=sync_token,
                        ))
                elif not resume:
                    # A resumed role whose shard lost all buckets must still not
                    # delete time files its peers may have consumed already.
                    mh.clear_bucket_times(sync_dir, host_id, token=sync_token)
                dyn_ratios = list(balancer.ratios)
        else:
            if resume:
                done_buckets = result_io.resume_point(
                    result_path, len(queries), write_dtype=write_dtype,
                    expected_buckets=db.bucket_counts(),
                )
            writer = result_io.ResultWriter(
                result_path, ref_count=len(queries), block_num=db.bucket_count,
                device_num=1, write_dtype=write_dtype, append=done_buckets > 0,
            )

        if done_buckets < db.bucket_count:
            # The nvcc build (first use) and the CUDA contexts, outside cal_time
            # and the -D balancer's bucket times; one library serves every
            # bucket's geometry.
            with Span("warm", stats, "compile_time"):
                engine.warm()

        # Reader thread keeps the device fed (the reference's input_task thread).
        buckets: queue.Queue = queue.Queue(maxsize=config.prefetch)
        stop_reader = threading.Event()

        def put(item) -> bool:
            """Hand ``item`` to the main thread; False where the main loop
            stopped first (don't block on a full queue). The wait is billed to
            reader_put_wait_time."""
            t0 = time.perf_counter()
            try:
                while not stop_reader.is_set():
                    try:
                        buckets.put(item, timeout=0.2)
                        return True
                    except queue.Full:
                        continue
                return False
            finally:
                stats.reader_put_wait_time += time.perf_counter() - t0

        def read_all():
            # A mid-run read failure (disk error, database truncated while we
            # run) must surface in the main loop, not silently kill this thread
            # — without the sentinel the main loop would block on buckets.get()
            # forever. The reference's input thread exits the whole process on
            # read errors (file.c:13-16); we raise instead.
            try:
                for bucket in db:
                    if not put(bucket):
                        return
                end = None
            except BaseException as e:  # noqa: BLE001 — forwarded, re-raised below
                # BaseException (not Exception) on purpose: a KeyboardInterrupt/
                # SystemExit landing here would otherwise kill the thread with
                # no sentinel and deadlock the main loop on buckets.get().  The
                # main loop re-raises interrupt-class exceptions as themselves
                # (not wrapped in OSError) to keep signal semantics.
                end = _ReaderFailed(e)
            put(end)

        reader = threading.Thread(target=read_all, daemon=True)
        reader.start()

    # Result events drain with a lag of one scoring step, so the device
    # computes step k+1 while step k's scores download and hit disk (the
    # reference's output thread, without the thread).
    import collections

    events: collections.deque = collections.deque()
    n_pending = 0

    def drain(keep: int):
        nonlocal n_pending
        while n_pending > keep:
            ev = events.popleft()
            if ev[0] == "bucket":
                writer.start_bucket(*ev[1:])
                continue
            _, dev, real, bidx, _ = ev
            # Reference accounting split (cal_sse.c:485 vs its output
            # thread): compute belongs to cal, the result download to
            # write. Fetching one score waits for the bucket's kernels, so
            # their completion is billed to cal_time without the D2H copy
            # of the whole score block.
            with Span("fetch", stats, "cal_time") as fetch:
                np.asarray(dev[0, 0])
            while len(stats.bucket_cal_times) <= bidx:
                stats.bucket_cal_times.append(0.0)
            stats.bucket_cal_times[bidx] += fetch.seconds
            with Span("write", stats, "write_time"):
                with Span("download"):
                    host_scores = np.asarray(dev)[:, :real]
                if shard is not None:
                    writer_fp.write(host_scores.tobytes())
                else:
                    writer.write_scores(host_scores)
            n_pending -= 1

    try:
        bucket_index = -1
        while True:
            with Span("read_wait", stats, "read_wait_time"):
                bucket = buckets.get()
            if bucket is None:
                break
            if isinstance(bucket, _ReaderFailed):
                if not isinstance(bucket.error, Exception):
                    # KeyboardInterrupt / SystemExit keep their own type —
                    # wrapping them in OSError broke Ctrl-C semantics.
                    raise bucket.error
                raise OSError(
                    f"reading {db_path} failed mid-run: {bucket.error}"
                ) from bucket.error
            bucket_index += 1
            if bucket_index < done_buckets:
                continue  # completed before the interruption
            codes = bucket.codes
            if shard is not None:
                if dynamic and bucket_index > done_buckets:
                    # The previous bucket's measured times steer this bucket's
                    # split (adjust_device_ratio3 between buckets, cal_all.c:1332).
                    times = mh.read_bucket_times(
                        sync_dir, bucket_index - 1, n_hosts,
                        timeout=config.sync_timeout, token=sync_token,
                    )
                    dyn_ratios = balancer.update(times)
                if dynamic:
                    stats.dynamic_ratios.append(list(dyn_ratios))
                    start, count = host_slice(bucket.count, n_hosts, host_id, chunk, dyn_ratios)
                else:
                    start, count = host_slice(bucket.count, n_hosts, host_id, v_num, shard_ratios)
                codes = codes[start : start + count]
                real = count
                meta.block_counts.append(count)
                meta.extra_counts.append(bucket.extra_count if host_id == n_hosts - 1 else 0)
                stats.subject_count += count - meta.extra_counts[-1]
                # Persist incrementally so shard resume can trust the recorded
                # split (the file itself arbitrates how many buckets completed).
                meta.save(meta_path)
            else:
                events.append(("bucket", [bucket.count], bucket.extra_count))
                stats.subject_count += bucket.count - bucket.extra_count
                real = bucket.count
            if dynamic:
                t_bucket = time.perf_counter()
            if real == 0 and not dynamic:
                continue
            if real:
                # Host-side transport packing, once per bucket (reused across
                # query buckets): the reader thread packs a whole bucket; a
                # host role's slice is packed here — the analogue of the
                # reference's pack phase, billed to mem_total_time like its
                # *_handle_reads (cal_sse.c:469-487). Under local sharding the
                # sidecar is pre-split into shard-local position lists
                # (pack.sidecar_pack).
                stats.scored_rows += real
                transport, payload = bucket.transport, bucket.payload
                if transport is None:
                    with Span("transport_pack", stats, "pack_time"):
                        transport, payload = pack.select_transport(
                            codes, n_shards=engine.n_shards, threads=_pack_threads(config)
                        )
                for qi, qb in enumerate(q_buckets):
                    # async: drain's fetch waits for the device
                    with Span("dispatch", stats, "cal_time"):
                        dev_scores = engine.scores_packed(qb, transport, payload, db.length)
                    stats.add_launches(engine.take_counts())
                    events.append(("scores", dev_scores, real, bucket_index, qi))
                    n_pending += 1
                    drain(1)
            if dynamic:
                # Per-bucket barrier: the measured wall time (pack + compute +
                # fetch + write) is this host's previous_device_times entry.
                # Floored so a host with an empty slice can't report ~0 time and
                # blow up the next ratio update.
                drain(0)
                if _test_sleep:
                    time.sleep(_test_sleep)  # test hook: artificially slow host
                # Flush the shard bytes to the OS before publishing the time: a
                # published time must imply the bucket's scores survive a crash,
                # or resume's file-size arbitration would replay the bucket and
                # re-publish a different time than the one peers consumed.
                writer_fp.flush()
                mh.write_bucket_time(
                    sync_dir, bucket_index, host_id,
                    max(time.perf_counter() - t_bucket, 1e-3),
                    token=sync_token,
                )
            elif _test_sleep:
                drain(0)
                time.sleep(_test_sleep)  # test hook (SIGKILL-mid-run tests)

        drain(0)
        while events:  # trailing bucket records (empty shard slices)
            ev = events.popleft()
            writer.start_bucket(*ev[1:])
    finally:
        # Release a reader blocked on a full queue: any exception
        # escaping the loop (engine failure, -D dead-peer timeout)
        # must not leak a thread holding the database file open.
        stop_reader.set()
    with Span("close"):
        reader.join()
        (writer_fp if shard is not None else writer).close()
    stats.total_time = time.perf_counter() - t_start
    return (stats, meta) if shard is not None else stats
