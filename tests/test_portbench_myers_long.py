"""The benchmark's long-subject Myers configuration, ``myers_unit_global_long``
(20 x 5,000 bp against 20,000 x 5,000 bp), and the port's Myers launch
counters.

On the CPU: the plain reference (``portbench.reference``) against the
port's numpy oracle across the strip kernel's 1,024 bp boundaries; the
plain model of the strips' schedule past 32 words against that reference;
a small run of the cell through its path at 1,100 bp; its ``hamming``
control; the faults a run must catch; its metrics' readers; and the
counters' way from the engine to ``RunStats`` and ``--stats-json``. On
the card (marker ``cuda``): a 5 kbp bucket on the strips, a slice on the
wavefront and one on the register route, each held to the reference, with
its counters and its profiler range.

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_portbench_myers_long.py
"""

import json
import types

import numpy as np
import pytest
import torch

from bgsa_tpu_torch import cli, oracle, pack
from bgsa_tpu_torch.io import seqfile
from bgsa_tpu_torch.ops import myers_semiglobal as sg
from bgsa_tpu_torch.pipeline import Engine, PipelineConfig, run_alignment
from bgsa_tpu_torch.schemes import Mode, Scoring, normalize
from bgsa_tpu_torch.stats import LaunchCounts, RunStats
from portbench import control, core, reference, roofline_counts
from portbench.tests.test_portbench_control import altered, half_left_out
from portbench.trace import JOB_SPAN, Trace

CELL = "myers_unit_global_long.cli_5kbp_q20_mix30"
SMALL = {"queries": 3, "query_len": 1100, "subjects": 200, "subject_len": 1100,
         "near_edits": [0, 11], "check_subjects": 60}
# the faults need a run each: two strips still (33 words), two queries; 200
# subjects and their 56 'N' pads, so that half the rows holds real subjects
FAULT = {**SMALL, "queries": 2, "query_len": 1056, "subject_len": 1056, "check_subjects": 40}
COUNTERS = ("myers_word_columns", "myers_strip_word_columns", "myers_carry_peak_bytes")
READERS = ("engine.myers_strip_share", "engine.myers_carry_gib")


def run(overrides=SMALL, seed=2**31 + 7, seconds=0.3):
    return core.run(CELL, seed, seconds, False, device="cpu", overrides=overrides)


def near_pairs(rng, P, m, n):
    """(P, m) and (P, n) codes: uniform, but for a copy of the query's first
    bases with a few substitutions in every other pair."""
    q = rng.integers(0, 4, size=(P, m))
    s = rng.integers(0, 4, size=(P, n))
    k = min(m, n)
    s[::2, :k] = q[::2, :k]
    pos = rng.integers(0, k, size=(P, 8))
    s[np.arange(P)[::2, None], pos[::2]] = rng.integers(0, 4, size=pos[::2].shape)
    return q, s


def skewed(rng, shape):
    """(S, n) subjects, A but for a share of C, G and T of each subject's own
    (log-uniform from 0.0003 to 0.75): against a query much shorter than the
    subject, the carries between strips then differ from pair to pair."""
    miss = np.exp(rng.uniform(np.log(3e-4), np.log(0.75), size=(shape[0], 1)))
    return np.where(rng.random(shape) < miss, rng.integers(1, 4, size=shape), 0)


# -- the reference past the register bound -------------------------------------


# one and several 1,024 bp strips: 1,025 and 1,100 two strips (the last of one
# and three words), 2,049 a third strip of one word; m = n and m != n
@pytest.mark.parametrize("m, n", [(1025, 1025), (1100, 1100), (2049, 2049), (1100, 2049),
                                  (2049, 1025), (70, 1100), (1, 1025)])
def test_reference_matches_the_oracle(m, n):
    rng = np.random.default_rng(m * 7 + n)
    q, s = near_pairs(rng, 6, m, n)
    got = reference.global_scores(torch.from_numpy(q), torch.from_numpy(s))
    want = [oracle.align_scores(qq, ss[None], Scoring(0, -1, -1))[0] for qq, ss in zip(q, s)]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# W = 33 and 35 words (1,025 and 1,100 bp) in strips of 1-4 words; queries of
# 40 and 70 columns (two and three carry words); and the kernel's own strip
# of 32 words at 1,056 bp, query and subject as long
@pytest.mark.parametrize("n, m, strip", [(n, m, strip) for n, m in ((1025, 70), (1100, 40))
                                         for strip in (1, 2, 3, 4)] + [(1056, 1056, 32)])
def test_strip_model_matches_the_reference(n, m, strip):
    rng = np.random.default_rng(n + m + strip)
    Q, S = 2, 5
    q = rng.integers(0, 4, size=(Q, m))
    s = skewed(rng, (S, n)) if m < n else rng.integers(0, 4, size=(S, n))
    s[0, :m] = q[0]  # one subject starts with the query: an all-ones carry chain
    eq = pack.pack_eq(torch.from_numpy(s.astype(np.uint8)), 32)
    assert eq.shape[1] == -(-n // 32) > 32
    got = sg.myers_strip_ref(eq, torch.from_numpy(q), read_len=n, is_global=True, strip=strip)
    qi, si = np.repeat(np.arange(Q), S), np.tile(np.arange(S), Q)
    want = reference.global_scores(torch.from_numpy(q[qi]), torch.from_numpy(s[si]))
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want.numpy())


# -- the cell on the CPU -------------------------------------------------------


def test_sound_run_is_correct():
    result = run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["answers_compared"] == SMALL["queries"] * SMALL["check_subjects"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert set(result["checks"]) == {"layout_errors", "score_mismatches"}


def test_path_runs_the_cell_through_the_cli(tmp_path):
    from portbench import paths, traffic

    workload, config = core.cell(core.benchmark(), CELL)
    assert (workload["query_len"], workload["subject_len"]) == tuple(config["read_lengths"])
    workload = {**workload, **SMALL}
    inputs = traffic.draw(workload, 5)
    path = paths.load(workload["path"]).Path(workload, config, inputs, str(tmp_path), "cpu")
    assert path.argv[-6:] == ["-M", "0", "-I", "-1", "-G", "-1"]
    assert "--semi-global" not in path.argv
    stats = path.job(0)["stats"]
    assert stats["subject_count"] == SMALL["subjects"] and stats["subject_len"] == 1100
    assert all(stats[c] == 0 for c in COUNTERS)  # the CPU runs the plain version
    # 30 % of the reads copy a query with at most 11 substitutions
    near = (inputs.pool[0][:, None, :] != inputs.queries[None]).sum(-1).min(1) <= 11
    assert near.sum() >= int(0.3 * SMALL["subjects"])


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_control_fails(seed):
    got = control.readings(CELL, seed, "cpu", SMALL)
    assert got["control"] == "hamming" and not got["correct"]
    assert got["checks"]["score_mismatches"]["value"] >= got["answers_compared"] // 2


@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_broken_kernel_output_is_caught(fault, monkeypatch):
    monkeypatch.setattr(Engine, "score_codes", fault(Engine.score_codes))
    assert not run(FAULT)["correct"]


def test_cli_job_that_leaves_its_result_unchanged_is_caught(monkeypatch):
    real, calls = cli.align_main, []

    def lazy(argv):
        calls.append(argv)
        return real(argv) if len(calls) == 1 else 0

    monkeypatch.setattr(cli, "align_main", lazy)
    assert not run(FAULT)["correct"]


# -- the readers ---------------------------------------------------------------


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
    zero = json.loads(RunStats().to_json())  # a run that launched no Myers kernel
    for name in READERS:
        assert core.reader(name)(rec(jobs=[{"ok": True, "stats": zero}])) is None
    card = {"sms": 132, "clock_mhz": 1980.0}  # no kernel in the trace
    trace = Trace([{"ph": "X", "name": JOB_SPAN, "ts": 0, "dur": 10, "cat": "user_annotation"}])
    assert core.reader("kernel.myers_roofline")(rec(trace=trace, card=card,
                                                    launches=[(20, 5632)])) is None


def test_readers_on_a_synthetic_record():
    jobs = [{"ok": True, "stats": {"myers_word_columns": 400, "myers_strip_word_columns": 300,
                                   "myers_carry_peak_bytes": 141_475_840}},
            {"ok": True, "stats": {"myers_word_columns": 100, "myers_strip_word_columns": 100,
                                   "myers_carry_peak_bytes": 1 << 20}}]
    assert core.reader("engine.myers_strip_share")(rec(jobs)) == pytest.approx(80.0)
    assert core.reader("engine.myers_carry_gib")(rec(jobs)) == pytest.approx(0.131759, abs=1e-6)

    def kernel(name, dur):
        return {"ph": "X", "name": f"void (anonymous namespace)::{name}(int const*, int)",
                "ts": 10, "dur": dur, "cat": "kernel"}

    # kernel.myers_roofline on the cell: the strip kernels are Myers kernels
    # of the port's list; the 31-bit kernels are too, the banded one is not
    trace = Trace([{"ph": "X", "name": JOB_SPAN, "ts": 0, "dur": 10_000_000,
                    "cat": "user_annotation"},
                   kernel("myers_strips", 400_000), kernel("myers_strips_wave", 90_000),
                   kernel("global31_strips", 10_000), kernel("banded_packed_kernel<3>", 7_000)])
    card = {"sms": 132, "clock_mhz": 1980.0}
    launches = [(20, 5632)] * 3 + [(20, 3200)]
    got = core.reader("kernel.myers_roofline")(rec(trace=trace, card=card, launches=launches))
    floor = roofline_counts.myers_floor_s(20, 5000, 20_000, 5000, launches, 132, 1980.0)
    assert got == pytest.approx(100.0 * floor / 0.5)
    # 11 ALU ops a word-column and 2 a column, 157 words, at 64 x 132 x 1,980 MHz
    assert floor == pytest.approx((11 * 157 + 2) * 5000 * 20 * 20_000 / (64 * 132 * 1980e6))


# -- the counters' way to the stats --------------------------------------------


def test_launch_counts_reach_run_stats(tmp_path, monkeypatch):
    """The engine hands its counts to every Myers launch; each dispatch's
    counts are added once (the peak is the largest) and reach
    ``--stats-json``; a BitPAl run leaves them at 0."""
    from bgsa_tpu_torch import pipeline

    rng = np.random.default_rng(22)
    q, d = str(tmp_path / "q.txt"), str(tmp_path / "d.txt")
    seqfile.write_seq_file(q, rng.integers(0, 4, (150, 40), np.uint8))
    seqfile.write_seq_file(d, rng.integers(0, 4, (600, 40), np.uint8))
    config = PipelineConfig(bucket_size=256 * 41)  # 3 buckets x 2 query buckets
    plain, calls = pipeline.myers_semiglobal, []

    def launch(eq, queries, *, counts, **kw):  # the card's launcher, counting as it does
        (Q, m), (_, W, S) = queries.shape, eq.shape
        calls.append((Q, S))
        strips = len(calls) % 2 == 1
        counts.add("myers", Q * m * W * S, strips, 2 * sg.carry_words(m) * Q * S * 4 * strips)
        return plain(eq, queries, **kw)

    bitpal = run_alignment(q, d, str(tmp_path / "b.bin"), Scoring(2, -3, -5), config=config,
                           device="cpu")
    assert [getattr(bitpal, c) for c in COUNTERS] == [0, 0, 0]
    monkeypatch.setattr(pipeline, "myers_semiglobal", launch)
    stats = run_alignment(q, d, str(tmp_path / "r.bin"), config=config, device="cpu")
    assert len(calls) == 6  # 3 buckets x 2 query buckets, one launch each
    words = 2  # 40 bp
    columns = [Q * 40 * words * S for Q, S in calls]
    want = [sum(columns), sum(columns[0::2]), max(2 * 2 * Q * S * 4 for Q, S in calls)]
    assert [getattr(stats, c) for c in COUNTERS] == want
    assert [json.loads(stats.to_json())[c] for c in COUNTERS] == want

    calls.clear()
    out = tmp_path / "stats.json"
    assert cli.align_main(["-q", q, "-d", d, "-f", str(tmp_path / "c.bin"), "--stats-json",
                           str(out), "--quiet", "--device", "cpu"]) == 0
    written = json.loads(out.read_text())
    columns = [Q * 40 * words * S for Q, S in calls]
    assert written["myers_word_columns"] == sum(columns) > 0
    assert written["myers_strip_word_columns"] == sum(columns[0::2])

    # an engine hands its counts over once and starts afresh; a dispatch
    # that launched nothing adds nothing
    engine = Engine(normalize(Scoring(0, -1, -1), Mode.GLOBAL), PipelineConfig(), "cpu")
    engine.counts.add("myers", 9, False)
    assert engine.take_counts() == LaunchCounts("myers", 9, 0, 0)
    assert engine.take_counts() == LaunchCounts()
    before = [getattr(stats, c) for c in COUNTERS]
    stats.add_launches(engine.take_counts())
    assert [getattr(stats, c) for c in COUNTERS] == before
    with pytest.raises(ValueError, match="bitpal launch counted with myers"):
        LaunchCounts("myers", 1).add("bitpal", 1, False)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (route, Q, m, n, S): a 5 kbp bucket of 5,632 subjects (6 x 176 groups: the
# strips on one warp a group), a slice of few pairs (the wavefront), and
# 960 bp (30 words: the register kernel)
ROUTES = [("myers_strips", 6, 5000, 5000, 5632), ("myers_strips_wave", 2, 200, 5000, 300),
          ("myers_regs", 3, 100, 960, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("route, Q, m, n, S", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_on_the_card(cuda, tmp_path, route, Q, m, n, S):
    """One slice through the engine's Myers route, held to the reference on
    sampled subjects; the counters and the route's range."""
    from bgsa_tpu_torch import roofline
    from bgsa_tpu_torch.ops import build

    rng = np.random.default_rng(n + m)
    queries = rng.integers(0, 4, size=(Q, m), dtype=np.uint8)
    subjects = (skewed(rng, (S, n)) if m < n else rng.integers(0, 4, size=(S, n))).astype(np.uint8)
    if m == n:  # near copies, so the scores spread
        near = rng.random(S) < 0.3
        subjects[near] = queries[np.arange(near.sum()) % Q]
        pos = rng.integers(0, n, size=(int(near.sum()), 50))
        subjects[np.flatnonzero(near)[:, None], pos] = rng.integers(0, 4, size=pos.shape)
    W = -(-n // 32)
    strips = W > build.load().reg_words
    wave = strips and sg.strip_wave(Q, S, m, roofline.sm_count(cuda))
    assert route == ("myers_strips_wave" if wave else "myers_strips" if strips else "myers_regs")
    engine = Engine(normalize(Scoring(0, -1, -1), Mode.GLOBAL), PipelineConfig(), cuda)
    np.asarray(engine.scores(queries, subjects))  # the library built and warm
    engine.take_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = np.asarray(engine.scores(queries, subjects))
    counts = engine.take_counts()
    assert counts.family == "myers"
    assert counts.word_columns == Q * m * W * S
    assert counts.wide_word_columns == (counts.word_columns if strips else 0)
    assert counts.buffer_peak_bytes == (2 * sg.carry_words(m) * Q * S * 4 if strips else 0)

    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    names = ("bgsa.kernel",) + tuple(f"bgsa.{r}" for r, *_ in ROUTES)
    spans = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name]
             for name in names}
    assert len(spans["bgsa.kernel"]) == 1 and len(spans[f"bgsa.{route}"]) == 1
    assert sum(len(v) for v in spans.values()) == 2
    (k0, k1), (r0, r1) = spans["bgsa.kernel"][0], spans[f"bgsa.{route}"][0]
    assert k0 <= r0 and r1 <= k1

    picked = np.sort(rng.choice(S, size=min(S, 128), replace=False))
    qi, si = np.repeat(np.arange(Q), len(picked)), np.tile(picked, Q)
    want = reference.global_scores(torch.from_numpy(queries[qi]).to(cuda),
                                   torch.from_numpy(subjects[si]).to(cuda))
    np.testing.assert_array_equal(got[qi, si], want.cpu().numpy())
