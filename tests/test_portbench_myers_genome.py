"""The benchmark's whole-genome Myers configuration, ``myers_unit_global_genome``
(24 x 29,903 bp SARS-CoV-2 genomes against 2,000 x 29,903 bp), and the
port's count of the word-columns that run on the strips' wavefront.

On the CPU: the route and bucket arithmetic at the cell's sizes; a small
run of the cell through its path past one strip; its ``hamming`` control;
the wave counter's way from a launch through the engine to ``RunStats`` and
``--stats-json``; ``engine.myers_wave_share`` and the roofline's floor on
synthetic records; the configuration, workload and ``BENCHMARK.json``
entries against each other. On the card (marker ``cuda``): four genomes
against 64 on the wavefront, held to the reference, with its counters and
its profiler range.

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_portbench_myers_genome.py
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from bgsa_tpu_torch import cli, pipeline
from bgsa_tpu_torch.io import seqfile
from bgsa_tpu_torch.ops import myers_semiglobal as sg
from bgsa_tpu_torch.pipeline import Engine, PipelineConfig, run_alignment
from bgsa_tpu_torch.schemes import Mode, Scoring, normalize
from bgsa_tpu_torch.stats import LaunchCounts, RunStats
from portbench import check, control, core, reference, roofline_counts
from portbench.trace import JOB_SPAN, Trace

CELL = "myers_unit_global_genome.cli_29903bp_q24_mix30"
LONG = "myers_unit_global_long.cli_5kbp_q20_mix30"
GENOME = 29903
H100_SMS = 132
# past one strip (35 words), as the 5 kbp cell's tests run it
SMALL = {"queries": 3, "query_len": 1100, "subjects": 200, "subject_len": 1100,
         "near_edits": [0, 6], "check_subjects": 60}
WAVE = "myers_wave_word_columns"
# the cell's metrics besides its own: every one whose layer it runs
SHARED = ("driver.unbilled_share", "driver.pack_s", "driver.read_wait_s", "driver.reader_read_s",
          "driver.reader_encode_s", "driver.native_encode_share", "driver.reader_pack_share",
          "engine.cal_gcups", "engine.pad_share", "engine.myers_strip_share",
          "engine.myers_carry_gib", "device.torch_ops_ms", "device.idle_share",
          "kernel.myers_roofline")


# -- the cell's route and buckets ------------------------------------------------


# (Q, S, m, wave): the cell's full bucket and padded tail, the 5 kbp cell's bucket
@pytest.mark.parametrize("Q, S, m, wave", [(24, 896, GENOME, True), (24, 256, GENOME, True),
                                           (20, 5632, 5000, False)])
def test_route_at_the_cells_launches(Q, S, m, wave):
    assert sg.strip_wave(Q, S, m, H100_SMS) is wave


def test_bucket_arithmetic_at_29904_byte_lines(tmp_path):
    """2,000 genomes at the default bucket: two of 896 and a tail of 208
    padded to 256; the reader's own arithmetic over a sparse file of the
    cell's size (one line written)."""
    path = tmp_path / "subject.txt"
    with open(path, "wb") as f:
        f.write(b"A" * GENOME + b"\n")
        f.truncate(2000 * (GENOME + 1))
    config = PipelineConfig()
    reader = seqfile.DatabaseReader(str(path), config.bucket_size, config.v_num)
    assert config.bucket_size == 28_714_400 and reader.stride == 29_904
    assert reader.seqs_per_bucket == 896
    assert reader.bucket_counts() == [(896, 0), (896, 0), (256, 48)]
    # the carries of a full bucket: 2 planes x 935 words x 24 x 896 int32
    assert 2 * sg.carry_words(GENOME) * 24 * 896 * 4 == 160_849_920


# -- the cell on the CPU -------------------------------------------------------


def test_sound_run_is_correct():
    result = core.run(CELL, 2**31 + 11, 0.3, False, device="cpu", overrides=SMALL)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["answers_compared"] == SMALL["queries"] * SMALL["check_subjects"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert set(result["checks"]) == {"layout_errors", "score_mismatches"}


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_control_fails(seed):
    got = control.readings(CELL, seed, "cpu", SMALL)
    assert got["control"] == "hamming" and not got["correct"]
    assert got["checks"]["score_mismatches"]["value"] >= got["answers_compared"] // 2


# -- the wave counter's way to the stats -----------------------------------------


def test_wave_counts_reach_run_stats(tmp_path, monkeypatch):
    """A launch counted as a wavefront reaches ``RunStats`` and
    ``--stats-json`` beside the strips' count, which holds both schedules."""
    rng = np.random.default_rng(25)
    q, d = str(tmp_path / "q.txt"), str(tmp_path / "d.txt")
    seqfile.write_seq_file(q, rng.integers(0, 4, (6, 40), np.uint8))
    seqfile.write_seq_file(d, rng.integers(0, 4, (600, 40), np.uint8))
    config = PipelineConfig(bucket_size=256 * 41)  # 3 buckets
    plain, calls = pipeline.myers_semiglobal, []

    def launch(eq, queries, *, counts, **kw):  # strips, every other launch as a wavefront
        (Q, m), (_, W, S) = queries.shape, eq.shape
        calls.append(Q * m * W * S)
        counts.add("myers", calls[-1], True, 2 * sg.carry_words(m) * Q * S * 4,
                   len(calls) % 2 == 1)
        return plain(eq, queries, **kw)

    monkeypatch.setattr(pipeline, "myers_semiglobal", launch)
    stats = run_alignment(q, d, str(tmp_path / "r.bin"), config=config, device="cpu")
    assert len(calls) == 3
    want = {"myers_word_columns": sum(calls), "myers_strip_word_columns": sum(calls),
            WAVE: sum(calls[0::2])}
    assert {k: getattr(stats, k) for k in want} == want
    assert {k: json.loads(stats.to_json())[k] for k in want} == want

    calls.clear()
    out = tmp_path / "stats.json"
    assert cli.align_main(["-q", q, "-d", d, "-f", str(tmp_path / "c.bin"), "--stats-json",
                           str(out), "--quiet", "--device", "cpu"]) == 0
    written = json.loads(out.read_text())
    assert written[WAVE] == sum(calls[0::2]) > 0
    assert written["myers_strip_word_columns"] == written["myers_word_columns"] == sum(calls)

    # a dispatch's wave and strip launches add up in one count
    counts = LaunchCounts()
    counts.add("myers", 7, True, 0, True)
    counts.add("myers", 5, True)
    assert counts == LaunchCounts("myers", 12, 12, 0, 7)
    stats = RunStats()
    stats.add_launches(counts)
    assert (stats.myers_strip_word_columns, stats.myers_wave_word_columns) == (12, 7)


# -- the readers ---------------------------------------------------------------


def rec(jobs=(), trace=None, card=None, launches=(), cell=CELL):
    workload, config = core.cell(core.benchmark(), cell)
    return types.SimpleNamespace(
        workload=workload, config=config, jobs=list(jobs), window_s=0.0, setup_s=0.0,
        cells_per_job=core.cells(workload), trace=trace, kernels=core.port_kernels(), card=card,
        launches_per_job=list(launches))


def counters(total, strips, wave):
    return {"ok": True, "stats": {"myers_word_columns": total,
                                  "myers_strip_word_columns": strips, WAVE: wave}}


def test_wave_share_on_synthetic_records():
    read = core.reader("engine.myers_wave_share")
    assert read(rec([counters(400, 400, 400), counters(100, 100, 100)])) == pytest.approx(100.0)
    assert read(rec([counters(400, 400, 0)], cell=LONG)) == 0.0  # the strips alone
    assert read(rec([counters(300, 200, 100), counters(100, 100, 0)])) == pytest.approx(25.0)
    # older stats (no wave counter), no stats, a run that launched no Myers kernel
    older = json.loads(RunStats(subject_count=5, scored_rows=8).to_json())
    del older[WAVE]
    assert read(rec([{"ok": True, "stats": older}])) is None
    assert read(rec([counters(400, 400, 400), {"ok": True, "stats": older}])) is None
    assert read(rec()) is None
    assert read(rec([{"ok": True, "stats": json.loads(RunStats().to_json())}])) is None


def test_roofline_reads_the_wavefront():
    """kernel.myers_roofline on the cell: the wave kernel is a Myers kernel of
    the port's list, and the floor is (11 x 935 + 2) ALU a column-pair."""
    def event(name, dur, cat="kernel"):
        return {"ph": "X", "name": name, "ts": 10, "dur": dur, "cat": cat}

    trace = Trace([event(JOB_SPAN, 10_000_000, "user_annotation"),
                   event("void (anonymous namespace)::myers_strips_wave(unsigned int const*)",
                         3_000_000), event("banded_packed_kernel<3>", 7_000)])
    card = {"sms": H100_SMS, "clock_mhz": 1980.0}
    launches = [(24, 896)] * 2 + [(24, 256)]
    got = core.reader("kernel.myers_roofline")(rec(trace=trace, card=card, launches=launches))
    floor = (11 * 935 + 2) * GENOME * 24 * 2000 / (64 * H100_SMS * 1980e6)
    assert floor == pytest.approx(roofline_counts.myers_floor_s(
        24, GENOME, 2000, GENOME, launches, H100_SMS, 1980.0))
    assert floor == pytest.approx(0.8828, abs=1e-4)
    assert got == pytest.approx(100.0 * floor / 3.0)


# -- the entries -----------------------------------------------------------------


def test_configuration_workload_and_benchmark_agree():
    bench = core.benchmark()
    workload, config = core.cell(bench, CELL)
    entry = next(c for c in bench["configs"] if c["name"] == "myers_unit_global_genome")
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert entry["file"] == "portbench/configs/myers_unit_global_genome.json"
    assert config["source"] == entry["source"] and len(entry["source"]) <= 200
    assert config["reduced"] == entry["reduced"] == []
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "myers_unit_global_genome", "cli_29903bp_q24_mix30", 1)
    assert check.kind_of(config) == "myers" and config["control"] == "hamming"
    assert tuple(config["read_lengths"]) == (workload["query_len"], workload["subject_len"]) \
        == (GENOME, GENOME)
    assert (workload["queries"], workload["subjects"], workload["pool"], workload["path"]) == (
        24, 2000, 1, "cli")
    assert (workload["near_frac"], workload["near_edits"], workload["check_subjects"]) == (
        0.3, [0, 150], 16)
    assert os.path.exists(os.path.join(core.HERE, "metrics", "engine.myers_wave_share.py"))
    metrics = {m["name"]: m for m in bench["per_layer"]}
    wave = metrics["engine.myers_wave_share"]
    assert (wave["unit"], wave["better"], wave["source"], wave["layer"], wave["moves"]) == (
        "%", "lower", "program_counter", "engine", "total_gcups")
    assert set(wave["workloads"]) == {CELL, LONG}
    reported = {m["name"] for m in core.metrics_for(bench, CELL, True)}
    assert reported == set(SHARED) | {"engine.myers_wave_share"}
    assert {m["name"] for m in core.metrics_for(bench, CELL, False)} == {"total_gcups", "setup_s"}


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_genomes_on_the_wavefront(cuda, tmp_path):
    """Four genomes against 64 through the engine on the wavefront, held to
    the reference on every pair; the counters and the route's range."""
    from bgsa_tpu_torch import roofline

    Q, S, n = 4, 64, GENOME
    rng = np.random.default_rng(2025)
    queries = rng.integers(0, 4, size=(Q, n), dtype=np.uint8)
    subjects = rng.integers(0, 4, size=(S, n), dtype=np.uint8)
    subjects[::3] = queries[np.arange(len(subjects[::3])) % Q]  # near copies
    near = np.flatnonzero(np.arange(S) % 3 == 0)
    pos = rng.integers(0, n, size=(len(near), 150))
    subjects[near[:, None], pos] = rng.integers(0, 4, size=pos.shape)
    W = -(-n // 32)
    assert sg.strip_wave(Q, S, n, roofline.sm_count(cuda))
    engine = Engine(normalize(Scoring(0, -1, -1), Mode.GLOBAL), PipelineConfig(), cuda)
    np.asarray(engine.scores(queries[:1], subjects[:8]))  # the library built and warm
    engine.take_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = np.asarray(engine.scores(queries, subjects))
    counts = engine.take_counts()
    assert counts.family == "myers"
    assert counts.word_columns == counts.wide_word_columns == counts.wave_word_columns \
        == Q * n * W * S
    assert counts.buffer_peak_bytes == 2 * sg.carry_words(n) * Q * S * 4

    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    assert names.count("bgsa.myers_strips_wave") == 1
    assert "bgsa.myers_strips" not in names and "bgsa.myers_regs" not in names

    qi, si = np.repeat(np.arange(Q), S), np.tile(np.arange(S), Q)
    want = reference.global_scores(torch.from_numpy(queries[qi]).to(cuda),
                                   torch.from_numpy(subjects[si]).to(cuda))
    np.testing.assert_array_equal(got[qi, si], want.cpu().numpy())
    assert got.min() < -15_000 and got.max() > -150  # far and near pairs, both in int16
