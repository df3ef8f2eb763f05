"""The port's spans and run counters on the CPU.

Every phase of the bucketed driver and of the engines appears in a
``torch.profiler`` trace once per run, bucket or query bucket, the engines'
spans inside ``bgsa.dispatch``, the score download inside ``bgsa.write``,
the warm-up inside ``bgsa.setup``; each driver span's summed duration
agrees with the ``RunStats`` field it bills; the reader wait, the reader's
own seconds and its wait on a full queue, the buckets it packed and the
rows scored are counted; a single host's main thread packs nothing, a host
role's packs its slice of each bucket; ``align()`` and the CLI name their
phases.
"""

import gc
import json
import sys
import time

import numpy as np
import pytest
import torch

from bgsa_tpu_torch import Scoring, align
from bgsa_tpu_torch.banded_pipeline import run_banded
from bgsa_tpu_torch.io import result as result_io
from bgsa_tpu_torch.io import seqfile
from bgsa_tpu_torch.pipeline import PipelineConfig, run_alignment
from bgsa_tpu_torch.stats import RunStats, Span

LEN = 24
QUERIES = 150  # two query buckets: 100 (REF_BUCKET_COUNT) and 50
SUBJECTS = 600  # buckets of 256, 256 and 88 + 40 'N' lane pads
CONFIG = PipelineConfig(bucket_size=256 * (LEN + 1))
BUCKETS, QUERY_BUCKETS = 3, 2

RUNS = {
    "myers": lambda q, d, r, **kw: run_alignment(q, d, r, config=CONFIG, device="cpu", **kw),
    "bitpal": lambda q, d, r, **kw: run_alignment(q, d, r, Scoring(2, -3, -5), config=CONFIG,
                                                  device="cpu", **kw),
    "banded": lambda q, d, r, **kw: run_banded(q, d, r, 4, CONFIG, device="cpu", **kw),
}
PACKER = {"myers": "eq_pack", "bitpal": "eq_pack", "banded": "stream_pack"}
ENGINE_SPANS = ("upload", "unpack", "kernel", "narrow")
# driver span -> the RunStats field it bills; a host role's main thread
# also packs its slice of each bucket, in bgsa.transport_pack (pack_time)
BILLS = {"open": "read_time", "warm": "compile_time", "read_wait": "read_wait_time",
         "dispatch": "cal_time", "fetch": "cal_time", "write": "write_time"}


def write_inputs(directory, queries=QUERIES):
    rng = np.random.default_rng(16)
    paths = (str(directory / "q.txt"), str(directory / "d.txt"))
    seqfile.write_seq_file(paths[0], rng.integers(0, 4, (queries, LEN), np.uint8))
    seqfile.write_seq_file(paths[1], rng.integers(0, 4, (SUBJECTS, LEN), np.uint8))
    return paths


def bgsa_events(prof, path) -> list:
    """(name without "bgsa.", start us, end us) of each bgsa span in the trace."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][5:], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("name", "").startswith("bgsa.")]


def traced_run(family, tmp, **kw):
    """(the run's result, spans, database path) of one traced multi-bucket run."""
    q, d = write_inputs(tmp)
    # A span reads the clock a few microseconds before its range's time
    # stamp. A collection of this process's heap (torch and jax loaded), or
    # the interpreter handing its lock to the reader thread for a switch
    # interval, takes milliseconds, and one that lands in between parts the
    # two clocks by that much; neither is what this module tests.
    interval = sys.getswitchinterval()
    gc.disable()
    sys.setswitchinterval(1.0)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = RUNS[family](q, d, str(tmp / "r.bin"), **kw)
    finally:
        sys.setswitchinterval(interval)
        gc.enable()
    return got, bgsa_events(prof, tmp / "trace.json"), d


@pytest.fixture(scope="module", params=sorted(RUNS))
def traced(request, tmp_path_factory):
    """(family, RunStats, spans, database path) of one traced single-host run."""
    stats, spans, d = traced_run(request.param, tmp_path_factory.mktemp(request.param))
    return request.param, stats, spans, d


def test_every_span_once_per_bucket_or_query_bucket(traced):
    family, _, spans, _ = traced
    counts = {}
    for name, _, _ in spans:
        counts[name] = counts.get(name, 0) + 1
    per_dispatch = BUCKETS * QUERY_BUCKETS
    # no bgsa.transport_pack: the reader thread packs every bucket
    want = {"engine": 1, "open": 1, "setup": 1, "warm": 1, "close": 1,
            "read_wait": BUCKETS + 1,  # the last get() takes the end-of-file mark
            "dispatch": per_dispatch, "fetch": per_dispatch, "write": per_dispatch,
            "download": per_dispatch, PACKER[family]: per_dispatch,
            **{n: per_dispatch for n in ENGINE_SPANS}}
    assert counts == want


def inside(spans, child, parent) -> int:
    """How many ``child`` spans lie inside some ``parent`` span."""
    outer = [(t0, t1) for name, t0, t1 in spans if name == parent]
    return sum(any(p0 <= t0 and t1 <= p1 for p0, p1 in outer)
               for name, t0, t1 in spans if name == child)


def test_download_nests_in_each_write(traced):
    _, _, spans, _ = traced
    writes = [(t0, t1) for name, t0, t1 in spans if name == "write"]
    assert inside(spans, "download", "write") == len(writes) == BUCKETS * QUERY_BUCKETS
    for w0, w1 in writes:  # one download a write
        assert sum(w0 <= t0 and t1 <= w1 for name, t0, t1 in spans if name == "download") == 1


def test_setup_holds_the_warm_up_and_no_bucket(traced):
    _, _, spans, _ = traced
    (s0, s1), = [(t0, t1) for name, t0, t1 in spans if name == "setup"]
    assert inside(spans, "warm", "setup") == 1
    (o0, o1), = [(t0, t1) for name, t0, t1 in spans if name == "open"]
    assert o1 <= s0  # after the open, before the first bucket
    assert all(s1 <= t0 for name, t0, _ in spans if name in ("read_wait", "dispatch"))


def test_engine_spans_nest_in_dispatch(traced):
    family, _, spans, _ = traced
    dispatches = [(t0, t1) for name, t0, t1 in spans if name == "dispatch"]
    inner = [(t0, t1) for name, t0, t1 in spans if name in ENGINE_SPANS + (PACKER[family],)]
    assert len(inner) == 5 * len(dispatches)
    for t0, t1 in inner:
        assert any(d0 <= t0 and t1 <= d1 for d0, d1 in dispatches)


def test_driver_spans_match_their_run_stats_fields(traced):
    _, stats, spans, _ = traced
    for field in set(BILLS.values()):
        mine = [(t1 - t0) * 1e-6 for name, t0, t1 in spans if BILLS.get(name) == field]
        assert mine, field
        assert abs(sum(mine) - getattr(stats, field)) <= 2e-3 * len(mine), field
    assert stats.pack_time == 0  # the main thread packed nothing


@pytest.mark.parametrize("family", sorted(RUNS))
def test_a_host_role_packs_each_slice_on_the_main_thread(tmp_path, family):
    """A ``--host`` role slices each bucket after the reader hands it over,
    so the reader encodes codes, and the main thread packs the slice in one
    bgsa.transport_pack a bucket, billed to pack_time."""
    (stats, meta), spans, _ = traced_run(family, tmp_path, shard=(1, 2))
    packs = [(t1 - t0) * 1e-6 for name, t0, t1 in spans if name == "transport_pack"]
    assert meta.block_counts == [128, 128, 128] and meta.extra_counts == [0, 0, 40]
    assert len(packs) == BUCKETS and stats.pack_time > 0
    assert abs(sum(packs) - stats.pack_time) <= 2e-3 * len(packs)
    assert stats.reader_packed_buckets == 0 and stats.reader_native_buckets == BUCKETS
    assert stats.scored_rows == 3 * 128 and stats.subject_count == 128 + 128 + 88


def test_scored_rows_match_the_bucket_layout(traced):
    _, stats, _, d = traced
    db = seqfile.DatabaseReader(d, CONFIG.bucket_size, CONFIG.v_num)
    assert db.bucket_counts() == [(256, 0), (256, 0), (128, 40)]
    assert stats.subject_count == SUBJECTS
    # the tail reaches the engine as its 88 subjects and 40 'N' lane pads
    assert stats.scored_rows == sum(c for c, _ in db.bucket_counts()) == 256 + 256 + 128
    assert stats.reader_read_time > 0 and stats.reader_encode_time > 0
    assert stats.reader_read_time + stats.reader_encode_time < stats.total_time
    # the reader's native pass packed the two full buckets ("2bit"); the
    # tail's 40 'N' lane pads are too many for a sidecar at 24 bp, so the
    # reader encoded its codes and packed them "nib" (select_transport)
    assert stats.reader_native_buckets == BUCKETS and stats.reader_packed_buckets == BUCKETS - 1
    written = json.loads(stats.to_json())  # what --stats-json writes
    for key in ("read_wait_time", "reader_read_time", "reader_encode_time", "scored_rows",
                "reader_packed_buckets"):
        assert written[key] == getattr(stats, key)


@pytest.mark.parametrize("family", sorted(RUNS))
def test_read_wait_bills_a_slow_reader(tmp_path, monkeypatch, family):
    """With the reader slowed by 50 ms a bucket, the main thread waits for
    what its own work does not cover: the first bucket whole, each later one
    less the main thread's work on the bucket before."""
    q, d = write_inputs(tmp_path, queries=1)
    iterate = seqfile.DatabaseReader.__iter__

    def slow(self):
        for bucket in iterate(self):
            time.sleep(0.05)
            yield bucket

    monkeypatch.setattr(seqfile.DatabaseReader, "__iter__", slow)
    stats = RUNS[family](q, d, str(tmp_path / "r.bin"))
    own = stats.pack_time + stats.cal_time + stats.write_time + stats.compile_time
    assert stats.read_wait_time >= 0.05 * BUCKETS - own - 0.01
    assert stats.read_time + stats.read_wait_time + own <= stats.total_time
    if family == "myers":  # a few ms of the main thread's work a bucket
        assert stats.read_wait_time >= 0.04 * (BUCKETS - 1)


@pytest.mark.parametrize("family", sorted(RUNS))
def test_put_wait_bills_a_slow_main_thread(tmp_path, monkeypatch, family):
    """With each score block's file write slowed by 50 ms, the reader fills
    the queue (two buckets) and waits on it: its end-of-file mark goes in
    only once the main thread takes the second bucket, after the first
    bucket's second query bucket has drained its first (a write)."""
    q, d = write_inputs(tmp_path)
    write = result_io.ResultWriter.write_scores

    def slow(self, scores):
        time.sleep(0.05)
        return write(self, scores)

    monkeypatch.setattr(result_io.ResultWriter, "write_scores", slow)
    stats = RUNS[family](q, d, str(tmp_path / "r.bin"))
    assert stats.write_time >= 0.05 * BUCKETS * QUERY_BUCKETS
    assert stats.reader_put_wait_time >= 0.04
    assert stats.reader_put_wait_time < stats.total_time
    assert json.loads(stats.to_json())["reader_put_wait_time"] == stats.reader_put_wait_time


@pytest.mark.parametrize("k", [None, 3], ids=["myers", "banded"])
def test_align_names_its_phases(tmp_path, k):
    rng = np.random.default_rng(3)
    subjects = rng.integers(0, 4, (70, 20)).astype(np.int32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = align(subjects[:3], subjects, k=k, device="cpu")
    names = [name for name, _, _ in bgsa_events(prof, tmp_path / "trace.json")]
    assert got.shape == (3, 70)
    assert names.count("encode") == 2
    for name in ("transport_pack", "dispatch", "fetch", "upload", "unpack", "kernel", "narrow"):
        assert names.count(name) == 1, name
    assert names.count("stream_pack" if k else "eq_pack") == 1


def test_span_adds_its_seconds_to_its_field(tmp_path):
    stats = RunStats(pack_time=1.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with Span("transport_pack", stats, "pack_time") as span:
            time.sleep(0.01)
    assert span.name == "bgsa.transport_pack" and not hasattr(span, "args")
    assert span.seconds >= 0.01 and stats.pack_time == 1.0 + span.seconds
    # the billed interval is read inside the traced range
    (name, t0, t1), = bgsa_events(prof, tmp_path / "trace.json")
    assert name == "transport_pack" and (t1 - t0) * 1e-6 >= span.seconds - 1e-6
    with Span("close") as bare:
        pass
    assert bare.name == "bgsa.close" and bare.seconds >= 0


def test_cli_spans_its_head_and_tail_and_no_run(tmp_path):
    """``bgsa.cli`` twice a CLI run: the checks and probes before the run,
    the stats and report after it; no span holds the run's own spans."""
    from bgsa_tpu_torch import cli

    q, d = write_inputs(tmp_path)
    argv = ["-q", q, "-d", d, "-f", str(tmp_path / "r.bin"), "--stats-json",
            str(tmp_path / "s.json"), "--quiet", "--device", "cpu"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert cli.align_main(argv) == 0
    spans = bgsa_events(prof, tmp_path / "trace.json")
    heads = sorted((t0, t1) for name, t0, t1 in spans if name == "cli")
    run = {name: (t0, t1) for name, t0, t1 in spans if name in ("engine", "open", "setup", "close")}
    assert len(heads) == 2 and len(run) == 4
    assert heads[0][1] <= run["engine"][0] and run["close"][1] <= heads[1][0]
    for name, t0, t1 in spans:  # no span holds the bucket loop
        assert not (t0 <= run["setup"][1] and run["close"][0] <= t1), name
    assert "reader_put_wait_time" in json.loads((tmp_path / "s.json").read_text())
