"""The device's idle time split by innermost ``bgsa.*`` span
(``portbench.spans``) and the three metrics that read it or the reader's
queue wait, on hand-built traces and records."""

import json

import pytest

from portbench import spans
from portbench.tests.test_portbench_metrics import metric, rec, stats
from portbench.trace import JOB_SPAN, Trace


def event(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def kernel(ts, dur):
    return event("void myers_regs<5>(unsigned int const*)", ts, dur, "kernel")


def deep_eq_pack():
    """bgsa.eq_pack over 100..4900 us inside bgsa.dispatch, holding 1,000
    one-microsecond torch ops and their launches, the device busy 0..2000:
    the gap after the ops lies 2,000 host ranges past the span's start."""
    ops = [event("aten::bitwise_or", t, 1, "cpu_op") for t in range(100, 1100)]
    launches = [event("cudaLaunchKernel", t + 0.5, 0.25, "cuda_runtime")
                for t in range(100, 1100)]
    return [event(JOB_SPAN, 0, 6000), event("bgsa.dispatch", 0, 5000),
            event("bgsa.eq_pack", 100, 4800), *ops, *launches, kernel(0, 2000)]


# (events, want: span -> idle us); each job window 0..the job's end
CASES = {
    "nested": ([event(JOB_SPAN, 0, 1000), event("bgsa.write", 100, 400),
                event("bgsa.download", 200, 100), event("aten::copy_", 210, 80, "cpu_op"),
                kernel(0, 100), kernel(500, 500)],
               {"bgsa.write": 300, "bgsa.download": 100, spans.NONE: 0}),
    "straddles-two": ([event(JOB_SPAN, 0, 1000), event("bgsa.open", 0, 300),
                       event("bgsa.setup", 300, 300), event("bgsa.warm", 350, 50),
                       kernel(0, 100), kernel(370, 10), kernel(600, 400)],
                      {"bgsa.open": 200, "bgsa.setup": 250, "bgsa.warm": 40, spans.NONE: 0}),
    "deep-inside-eq_pack": (deep_eq_pack(), {"bgsa.eq_pack": 2900, "bgsa.dispatch": 100,
                                           spans.NONE: 1000}),
    "under-no-span": ([event(JOB_SPAN, 0, 500), event(JOB_SPAN, 500, 500),
                       event("bgsa.cli", 0, 200), event("bgsa.cli", 600, 100),
                       event("aten::empty", 300, 50, "cpu_op"), kernel(400, 100)],
                      {"bgsa.cli": 300, spans.NONE: 600}),
    "busy-throughout": ([event(JOB_SPAN, 0, 100), event("bgsa.kernel", 10, 50),
                         kernel(0, 60), kernel(50, 50)], {spans.NONE: 0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_idle_split_by_innermost_span(case):
    events, want = CASES[case]
    trace = Trace(events)
    split = spans.idle_by_span(trace)
    assert split == pytest.approx({k: v * 1e-6 for k, v in want.items()}, abs=1e-12)
    # the parts sum to the window's idle seconds
    assert sum(split.values()) == pytest.approx(trace.window_s - trace.busy_s, abs=1e-12)


def test_innermost_cuts_a_child_at_its_parent_end():
    host = [(0, 100, "bgsa.write"), (50, 150, "bgsa.download"), (120, 130, "aten::copy_"),
            (200, 300, "bgsa.cli")]
    assert spans.innermost(host) == [(0, 50, "bgsa.write"), (50, 100, "bgsa.download"),
                                     (200, 300, "bgsa.cli")]


def traced(with_download=True):
    events = [event(JOB_SPAN, 0, 1000), event(JOB_SPAN, 1000, 1000),
              event("bgsa.write", 100, 400), event("bgsa.fetch", 1100, 100),
              kernel(0, 100), kernel(500, 600), kernel(1200, 700)]
    if with_download:
        events.append(event("bgsa.download", 200, 200))
    return Trace(events)


def test_span_idle_metrics():
    # idle: 100..500 (write 200 us, download 200 us), 1100..1200 (fetch) and
    # 1900..2000 (none) of two jobs
    t = traced()
    assert metric("device.idle_unspanned_share")(rec(trace=t)) == pytest.approx(100 / 6)
    assert metric("driver.download_idle_s")(rec(trace=t)) == pytest.approx(100e-6)
    assert metric("driver.download_idle_s")(rec(trace=traced(False))) is None  # no such span
    for name in ("device.idle_unspanned_share", "driver.download_idle_s"):
        assert metric(name)(rec()) is None


def test_reader_put_wait_per_job():
    jobs = [{"ok": True, "stats": {**stats(0.1, 0, 0.1, 0.05, 0, 1.0), "reader_put_wait_time": w}}
            for w in (0.3, 0.1)]
    name = "driver.reader_put_wait_s"
    assert metric(name)(rec(jobs=jobs + [{"ok": False}])) == pytest.approx(0.2)
    older = {"ok": True, "stats": stats(0.1, 0, 0.1, 0.05, 0, 1.0)}  # a tree without the field
    assert metric(name)(rec(jobs=jobs + [older])) is None
    assert metric(name)(rec()) is None


def test_split_of_a_trace_file(tmp_path, capsys):
    """A file's window runs from its first bgsa.* range to its last."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        event("bgsa.cli", 100, 100), event("bgsa.open", 300, 100),
        kernel(0, 150), kernel(350, 20)]}))
    trace = spans.from_file(str(path))
    assert trace.window == (100, 400) and trace.busy_s == pytest.approx(70e-6)
    assert spans.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "idle 0.000230 s" in out and "bgsa.cli" in out and "(none)" in out
    assert spans.main([]) == 2
