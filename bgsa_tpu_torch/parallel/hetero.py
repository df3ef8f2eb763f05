"""In-process heterogeneous co-compute on torch devices: N engines share every bucket.

The port's twin of ``bgsa_tpu.parallel.hetero``, the analogue of the
reference's KNC ``-t MICSSE`` mode (``original/BGSA_KNC/cal_all.c:136-769``
static, ``:772-1487`` dynamic): there, one process drives the host CPU plus
N Xeon Phis, one OpenMP section per device, splitting each subject bucket by
``device_compute_ratio`` (``dispatch_task``, ``global.c:373-431``) and
re-measuring after every bucket in ``-D`` mode. Here, one process drives N
pinned engines (e.g. the CUDA card and the CPU's plain torch path) with one
worker thread per engine, and the per-device wall times feed the same
bit-exact ``DynamicBalancer``.

Device 0 is the pinned-ratio device (the reference's CPU slot); results are
written in device order per query bucket: the reference's multi-device
``.info``/result layout, so ``convert`` output is identical to a
single-device run. The split math is shared with the multi-host path
(``multihost.split_counts``).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .. import pack
from ..io import result as result_io
from ..io import seqfile
from ..stats import RunStats
from .multihost import DynamicBalancer, split_counts


def run_hetero(
    engines,
    query_path: str,
    db_path: str,
    result_path: str,
    config,
    *,
    ratios=None,
    dynamic: bool = False,
    write_dtype=np.int16,
    grid: int | None = None,
):
    """Bucketed run over N per-device engines; returns (stats, per-device times).

    engines: one Engine/BandedEngine per device, each pinned by its
      ``device`` (``hetero_engines`` builds them from a spec).
    ratios: initial split weights (reference ``-R`` / ``mic_cpu_ratio``);
      even when None.
    dynamic: re-split every bucket from measured per-device wall times
      (the reference's ``-D``).

    No resume support, as in the reference's in-process heterogeneous mode
    (it has no restart logic anywhere); use the multi-host roles
    (``--host`` + ``--resume``) for recoverable long runs.
    """
    from ..pipeline import _pack_threads

    n_dev = len(engines)
    stats = RunStats()
    t_start = time.perf_counter()

    v_num = config.v_num
    t0 = time.perf_counter()
    queries = seqfile.read_queries(query_path)
    db = seqfile.DatabaseReader(db_path, config.bucket_size, v_num, stats)
    stats.read_time += time.perf_counter() - t0
    stats.query_count, stats.query_len = queries.shape
    stats.subject_len = db.length

    q_buckets = [
        queries[s : s + config.ref_bucket_count]
        for s in range(0, len(queries), config.ref_bucket_count)
    ]

    # Same slice quantization as the multi-host dynamic mode: slices align to
    # chunk, so at most `grid` distinct slice shapes occur per device.
    grid = grid or config.dynamic_grid
    chunk = v_num
    if db.bucket_count > 1:
        chunk = v_num * max(1, -(-db.seqs_per_bucket // (v_num * grid)))

    balancer = DynamicBalancer(n_dev, initial_ratios=ratios)
    cur_ratios = list(balancer.ratios)

    writer = result_io.ResultWriter(
        result_path, ref_count=len(queries), block_num=db.bucket_count,
        device_num=n_dev, write_dtype=write_dtype,
    )

    # One library serves every geometry of an engine, so each device warms
    # once, on the main thread and billed to compile_time: a small launch
    # builds the library at first use (nvcc), creates the CUDA context and
    # loads the kernel's module. A first launch inside the timed worker
    # would feed the balancer an inflated time for that bucket. The nibble
    # path is warmed too when the tail bucket carries 'N' lane pads.
    warmed = [False] * n_dev
    warm_fills = (0, 4) if db.bucket_counts()[-1][1] else (0,)

    def ensure_warm(dev: int) -> None:
        if warmed[dev]:
            return
        warmed[dev] = True
        t0 = time.perf_counter()
        rows = v_num * engines[dev].n_shards
        for fill in warm_fills:
            dummy = np.full((rows, db.length), fill, np.uint8)
            for nq in sorted({qb.shape[0] for qb in q_buckets}):
                # .cpu() of one score synchronizes the device
                np.asarray(engines[dev].scores(queries[:nq], dummy)[0, 0])
        stats.compile_time += time.perf_counter() - t0

    device_times = [0.0] * n_dev
    slow_hooks = [getattr(e, "test_sleep", 0.0) for e in engines]

    for bucket in db:
        counts = split_counts(bucket.count, n_dev, chunk, cur_ratios)
        if dynamic:
            # Applied ratio schedule (the reference prints its
            # device_compute_ratio per round); also what the tests replay.
            stats.dynamic_ratios.append(list(cur_ratios))
        starts = np.cumsum([0] + counts[:-1])
        pads = [-(-c // chunk) * chunk for c in counts]

        # Pack every device's slice on the main thread (the reference's
        # handle_reads phase runs before its compute section too).
        slices: list = [None] * n_dev
        for d in range(n_dev):
            if not counts[d]:
                continue
            ensure_warm(d)
            t0 = time.perf_counter()
            codes = bucket.codes[starts[d] : starts[d] + counts[d]]
            if counts[d] < pads[d]:
                codes = np.concatenate(
                    [codes, np.zeros((pads[d] - counts[d], codes.shape[1]),
                                     codes.dtype)]
                )
            transport, packed = pack.select_transport(
                codes, n_shards=engines[d].n_shards, threads=_pack_threads(config)
            )
            stats.pack_time += time.perf_counter() - t0
            stats.scored_rows += codes.shape[0]
            slices[d] = (transport, packed, codes.shape[1])

        # One worker per device: the reference's `omp parallel
        # num_threads(devices)` section (cal_all.c:564-606). Each worker
        # dispatches every query bucket and blocks on the fetch; results
        # land in a (device, q_bucket) grid for ordered writing afterwards.
        results: list[list] = [[None] * len(q_buckets) for _ in range(n_dev)]
        times = [1e-3] * n_dev
        errs: list = [None] * n_dev

        def worker(d: int):
            try:
                t0 = time.perf_counter()
                if slices[d] is not None:
                    transport, packed, s_len = slices[d]
                    scores = [
                        engines[d].scores_packed(qb, transport, packed, s_len)
                        for qb in q_buckets
                    ]
                    for i, dv in enumerate(scores):
                        results[d][i] = np.asarray(dv)[:, : counts[d]]
                if slow_hooks[d]:
                    time.sleep(slow_hooks[d])  # test hook
                times[d] = max(time.perf_counter() - t0, 1e-3)
            except BaseException as e:  # propagate to the main thread
                errs[d] = e

        threads = [threading.Thread(target=worker, args=(d,)) for d in range(n_dev)]
        t_cal = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats.cal_time += time.perf_counter() - t_cal
        for e in errs:
            if e is not None:
                raise e
        device_times = [a + b for a, b in zip(device_times, times)]

        writer.start_bucket(counts, bucket.extra_count)
        t0 = time.perf_counter()
        for i in range(len(q_buckets)):
            for d in range(n_dev):
                if results[d][i] is not None:
                    writer.write_scores(results[d][i])
        stats.write_time += time.perf_counter() - t0
        stats.subject_count += bucket.count - bucket.extra_count
        # The reference's use_times row collapses to max over devices (the
        # bucket is done when the slowest device is).
        stats.bucket_cal_times.append(max(times))

        if dynamic:
            cur_ratios = balancer.update(times)

    writer.close()
    stats.total_time = time.perf_counter() - t_start
    return stats, device_times


def hetero_engines(scoring, mode, config, spec: str, threshold: int | None = None):
    """Build one pinned engine per entry of a spec like ``"cuda+cpu"``.

    The first entry is device 0 (ratio pinned to 1, the reference's CPU
    slot). ``cuda`` entries take ``cuda:0``, ``cuda:1``, ... in order, and
    one past ``torch.cuda.device_count()``, or any ``cuda`` entry where no
    CUDA device is visible, is refused: a ``cuda`` entry never runs on the
    CPU. ``cpu`` entries run the plain torch path and may repeat: torch has
    one CPU device over all cores, and each entry is an engine and a worker
    of its own. That is the port's one difference from ``bgsa-align``,
    where each entry takes a device of its platform. Any other name is
    refused. With ``threshold`` set, builds banded engines instead.
    """
    import dataclasses

    import torch

    from ..banded_pipeline import BandedEngine
    from ..pipeline import Engine
    from ..schemes import normalize

    scheme = None if threshold is not None else normalize(scoring, mode)
    cfg = dataclasses.replace(config, local_shards=1)
    n_cuda = 0
    engines = []
    for part in spec.split("+"):
        name = part.strip().lower()
        if name == "cuda":
            if not torch.cuda.is_available():
                raise ValueError(
                    f"device spec {spec!r}: platform 'cuda' is not available (no CUDA "
                    "device is visible; 'cpu' entries run the plain torch path)"
                )
            visible = torch.cuda.device_count()
            if n_cuda >= visible:
                raise ValueError(f"device spec {spec!r}: only {visible} cuda device(s)")
            device = torch.device("cuda", n_cuda)
            n_cuda += 1
        elif name == "cpu":
            device = torch.device("cpu")
        else:
            raise ValueError(
                f"device spec {spec!r}: platform {name!r} is not a torch device type of "
                "the port (cuda or cpu)"
            )
        if threshold is not None:
            engines.append(BandedEngine(threshold, cfg, device))
        else:
            engines.append(Engine(scheme, cfg, device))
    return engines
