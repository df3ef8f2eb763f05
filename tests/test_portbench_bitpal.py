"""The benchmark's BitPAl configuration, ``bitpal_2_3_5``, and the port's
BitPAl launch counters.

On the CPU: the plain general-scoring reference (``portbench.reference_scored``)
against the port's numpy oracle; a small run of the cell through its path
(``paths/cli_scored.py``); its ``ungapped`` control; the faults a run must
catch; the three new metrics' readers; and the counters' way from the
engine to ``RunStats``. On the card (marker ``cuda``): one 960 bp bucket
slice of the packed (2, -3, -5) route against the reference, its tiled
share, scratch and profiler range, and a 640 bp slice on the register path.

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_portbench_bitpal.py
"""

import json
import types

import numpy as np
import pytest
import torch

from bgsa_tpu_torch import cli, oracle
from bgsa_tpu_torch.pipeline import Engine, PipelineConfig, run_alignment
from bgsa_tpu_torch.schemes import Mode, Scoring, normalize
from bgsa_tpu_torch.stats import LaunchCounts, RunStats
from portbench import control, core, reference_scored, roofline_bitpal
from portbench.tests.test_portbench_control import altered, half_left_out
from portbench.trace import JOB_SPAN, Trace

CELL = "bitpal_2_3_5.cli_960bp_q200"
SMALL = {"queries": 3, "query_len": 64, "subjects": 400, "subject_len": 64,
         "check_subjects": 60}
SCHEMES = [(2, -3, -5), (1, -1, -2), (5, -4, -11)]
COUNTERS = ("bitpal_word_columns", "bitpal_tiled_word_columns", "bitpal_scratch_peak_bytes")
READERS = ("engine.bitpal_tiled_share", "engine.bitpal_scratch_gib", "kernel.bitpal_roofline")


def run(seed=3, seconds=0.3):
    return core.run(CELL, seed, seconds, False, device="cpu", overrides=SMALL)


@pytest.mark.parametrize("scheme", SCHEMES, ids=str)
@pytest.mark.parametrize("lengths", [(1, 1), (1, 130), (130, 1), (37, 64), (130, 130), None])
def test_reference_matches_the_oracle(scheme, lengths):
    rng = np.random.default_rng([abs(v) for v in scheme] + [len(str(lengths))])
    m, n = lengths or rng.integers(1, 131, size=2)
    queries = rng.integers(0, 4, size=(8, m))
    subjects = rng.integers(0, 4, size=(8, n))
    got = reference_scored.global_scores(torch.from_numpy(queries), torch.from_numpy(subjects),
                                         *scheme)
    want = [oracle.align_scores(q, s[None], Scoring(*scheme))[0]
            for q, s in zip(queries, subjects)]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ungapped_is_the_substitution_score():
    q = torch.tensor([[0, 1, 2, 3], [0, 0, 0, 0]])
    s = torch.tensor([[0, 1, 3, 3], [1, 1, 1, 1]])
    assert reference_scored.ungapped(q, s, 2, -3).tolist() == [3, -12]
    with pytest.raises(ValueError):
        reference_scored.ungapped(q, s[:, :3], 2, -3)


def test_sound_run_is_correct():
    result = run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["answers_compared"] == SMALL["queries"] * SMALL["check_subjects"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert set(result["checks"]) == {"layout_errors", "score_mismatches"}


def test_path_runs_the_scheme_through_the_cli(tmp_path):
    from portbench import paths, traffic

    workload, config = core.cell(core.benchmark(), CELL)
    workload = {**workload, **SMALL}
    path = paths.load(workload["path"]).Path(workload, config, traffic.draw(workload, 5),
                                             str(tmp_path), "cpu")
    assert path.argv[-6:] == ["-M", "2", "-I", "-3", "-G", "-5"]
    stats = path.job(0)["stats"]
    assert stats["subject_count"] == SMALL["subjects"]
    assert all(stats[c] == 0 for c in COUNTERS)  # the CPU runs the plain version


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_control_fails(seed):
    got = control.readings(CELL, seed, "cpu", SMALL)
    assert got["control"] == "ungapped" and not got["correct"]
    assert got["checks"]["score_mismatches"]["value"] >= got["answers_compared"] // 2


@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_broken_kernel_output_is_caught(fault, monkeypatch):
    monkeypatch.setattr(Engine, "score_codes", fault(Engine.score_codes))
    assert not run()["correct"]


def test_cli_job_that_leaves_its_result_unchanged_is_caught(monkeypatch):
    real, calls = cli.align_main, []

    def lazy(argv):
        calls.append(argv)
        return real(argv) if len(calls) == 1 else 0

    monkeypatch.setattr(cli, "align_main", lazy)
    assert not run()["correct"]


def rec(jobs=(), trace=None, card=None, launches=()):
    workload, config = core.cell(core.benchmark(), CELL)
    return types.SimpleNamespace(
        workload=workload, config=config, jobs=list(jobs), window_s=0.0, setup_s=0.0,
        cells_per_job=core.cells(workload), trace=trace, kernels=core.port_kernels(), card=card,
        launches_per_job=list(launches))


def test_readers_find_nothing_in_older_stats():
    older = json.loads(RunStats(subject_count=5, scored_rows=8).to_json())
    for key in COUNTERS:
        del older[key]
    for name in READERS:
        assert core.reader(name)(rec(jobs=[{"ok": True, "stats": older}])) is None
        assert core.reader(name)(rec()) is None
    zero = json.loads(RunStats().to_json())  # a run that launched no BitPAl kernel
    for name in READERS[:2]:
        assert core.reader(name)(rec(jobs=[{"ok": True, "stats": zero}])) is None


def test_readers_on_a_synthetic_record():
    jobs = [{"ok": True, "stats": {"bitpal_word_columns": 400, "bitpal_tiled_word_columns": 300,
                                   "bitpal_scratch_peak_bytes": 3 << 29}},
            {"ok": True, "stats": {"bitpal_word_columns": 100, "bitpal_tiled_word_columns": 100,
                                   "bitpal_scratch_peak_bytes": 1 << 30}}]
    assert core.reader("engine.bitpal_tiled_share")(rec(jobs)) == pytest.approx(80.0)
    assert core.reader("engine.bitpal_scratch_gib")(rec(jobs)) == pytest.approx(1.5)

    kernel = "void bitpal::(anonymous namespace)::bitpal_tiled_kernel<Packed<2, -3, -5, 31>, 31>"
    trace = Trace([{"ph": "X", "name": JOB_SPAN, "ts": 0, "dur": 10_000_000,
                    "cat": "user_annotation"},
                   {"ph": "X", "name": kernel, "ts": 10, "dur": 4_000_000, "cat": "kernel"},
                   {"ph": "X", "name": "bitpal_kernel_other", "ts": 10, "dur": 9, "cat": "kernel"}])
    card = {"sms": 132, "clock_mhz": 1980.0}
    launches = [(100, 29_824)] * 8
    got = core.reader("kernel.bitpal_roofline")(rec(trace=trace, card=card, launches=launches))
    floor = roofline_bitpal.floor_s((2, -3, -5), 200, 960, 100_000, 960, launches, 132, 1980.0)
    assert got == pytest.approx(100.0 * floor / 4.0)
    # 89 ALU ops a word-column, 31 words, at 64 x 132 x 1,980 MHz: the ops bound it
    assert floor == pytest.approx(89 * 31 * 960 * 200 * 100_000 / (64 * 132 * 1980e6))


def test_frozen_count():
    assert roofline_bitpal.alu_per_word_column((2, -3, -5)) == 89
    assert sum(n for _, n, pipe, _ in roofline_bitpal.PACKED_WORD_OPS if pipe == "add") == 5
    assert all(src for *_, src in roofline_bitpal.PACKED_WORD_OPS)
    with pytest.raises(ValueError):
        roofline_bitpal.alu_per_word_column((1, -1, -2))


def test_launch_counts_reach_run_stats(tmp_path, monkeypatch):
    """Each dispatch's counts are added once (the peak is the largest), and a
    Myers run leaves them at 0."""
    rng = np.random.default_rng(18)
    q, d = str(tmp_path / "q.txt"), str(tmp_path / "d.txt")
    from bgsa_tpu_torch.io import seqfile

    seqfile.write_seq_file(q, rng.integers(0, 4, (150, 24), np.uint8))
    seqfile.write_seq_file(d, rng.integers(0, 4, (600, 24), np.uint8))
    config = PipelineConfig(bucket_size=256 * 25)  # 3 buckets x 2 query buckets
    score_codes, calls = Engine.score_codes, []

    def counting(self, queries, codes):
        calls.append(len(calls))
        self.counts.add("bitpal", 4, True, 100 * len(calls))
        self.counts.add("bitpal", 6, False)
        return score_codes(self, queries, codes)

    myers = run_alignment(q, d, str(tmp_path / "m.bin"), config=config, device="cpu")
    assert [getattr(myers, c) for c in COUNTERS] == [0, 0, 0]
    monkeypatch.setattr(Engine, "score_codes", counting)
    stats = run_alignment(q, d, str(tmp_path / "r.bin"), Scoring(2, -3, -5), config=config,
                          device="cpu")
    assert len(calls) == 6
    assert (stats.bitpal_word_columns, stats.bitpal_tiled_word_columns,
            stats.bitpal_scratch_peak_bytes) == (60, 24, 600)
    written = json.loads(stats.to_json())  # what --stats-json writes
    assert [written[c] for c in COUNTERS] == [60, 24, 600]


def test_run_stats_add_bitpal():
    stats = RunStats()
    stats.add_launches(LaunchCounts("bitpal", 7, 3, 500))
    stats.add_launches(LaunchCounts("bitpal", 5, 0, 200))
    stats.add_launches(LaunchCounts())  # a dispatch that launched nothing
    assert (stats.bitpal_word_columns, stats.bitpal_tiled_word_columns,
            stats.bitpal_scratch_peak_bytes) == (12, 3, 500)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n, words, tiled", [(960, 31, True), (640, 21, False)])
def test_packed_route_on_the_card(cuda, tmp_path, n, words, tiled):
    """A slice of a 960 bp bucket (Q = 3 queries of n bases, past one tile of
    32 columns, against S = 2,048 subjects) through the engine's packed
    route, held to the reference; the counters and the route's range."""
    rng = np.random.default_rng(n)
    Q, S = 3, 2048
    queries = rng.integers(0, 4, size=(Q, n), dtype=np.uint8)
    subjects = rng.integers(0, 4, size=(S, n), dtype=np.uint8)
    engine = Engine(normalize(Scoring(2, -3, -5), Mode.GLOBAL), PipelineConfig(), cuda)
    assert engine.kernel == "bitpal_packed" and engine.word_bits == 31
    np.asarray(engine.scores(queries, subjects))  # the library built and warm
    engine.take_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = np.asarray(engine.scores(queries, subjects))
    counts = engine.take_counts()
    assert counts.family == "bitpal"
    assert counts.word_columns == Q * n * words * S
    assert counts.wide_word_columns == (counts.word_columns if tiled else 0)
    assert counts.buffer_peak_bytes == (5 * words * Q * S * 4 if tiled else 0)

    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name]
             for name in ("bgsa.kernel", "bgsa.bitpal_tiled", "bgsa.bitpal_regs")}
    route = spans["bgsa.bitpal_tiled" if tiled else "bgsa.bitpal_regs"]
    assert len(spans["bgsa.kernel"]) == 1 and len(route) == 1
    assert not spans["bgsa.bitpal_regs" if tiled else "bgsa.bitpal_tiled"]
    (k0, k1), (r0, r1) = spans["bgsa.kernel"][0], route[0]
    assert k0 <= r0 and r1 <= k1

    q = np.repeat(np.arange(Q), S)
    s = np.tile(np.arange(S), Q)
    want = reference_scored.global_scores(torch.from_numpy(queries[q]).to(cuda),
                                          torch.from_numpy(subjects[s]).to(cuda), 2, -3, -5)
    np.testing.assert_array_equal(got.reshape(-1), want.cpu().numpy())
