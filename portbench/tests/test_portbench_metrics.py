"""The metric arithmetic on synthetic records."""

import types

import pytest

from portbench import core, roofline_counts
from portbench.trace import JOB_SPAN, Trace


def rec(**kw):
    base = dict(workload={"queries": 2, "query_len": 10, "subjects": 100, "subject_len": 10},
                config={}, jobs=[], window_s=0.0, setup_s=0.0, cells_per_job=0, trace=None,
                kernels=core.port_kernels(), card=None, launches_per_job=[])
    base.update(kw)
    return types.SimpleNamespace(**base)


def metric(name):
    return core.reader(name)


def test_total_gcups_over_the_whole_window():
    jobs = [{"ok": True, "latency_s": 0.5}] * 3 + [{"ok": False, "latency_s": 0.5}]
    r = rec(jobs=jobs, window_s=2.0, cells_per_job=4e9)
    assert metric("total_gcups")(r) == pytest.approx(3 * 4e9 / 2.0 / 1e9)
    assert metric("total_gcups")(rec()) is None


def test_p95_over_all_calls():
    jobs = [{"ok": True, "latency_s": i / 1000} for i in range(1, 101)]
    assert metric("call_ms.p95")(rec(jobs=jobs)) == pytest.approx(95.05)


def stats(read, pack, cal, write, compile_, total):
    return {"read_time": read, "pack_time": pack, "cal_time": cal, "write_time": write,
            "compile_time": compile_, "total_time": total}


def test_driver_shares():
    jobs = [{"ok": True, "stats": stats(0.1, 0.2, 0.1, 0.05, 0.05, 1.0)},
            {"ok": True, "stats": stats(0.1, 0.2, 0.3, 0.05, 0.05, 1.0)}]
    r = rec(jobs=jobs, cells_per_job=2e9)
    assert metric("driver.unbilled_share")(r) == pytest.approx(100 * (1 - 1.2 / 2.0))
    assert metric("driver.pack_s")(r) == pytest.approx(0.2)
    assert metric("engine.cal_gcups")(r) == pytest.approx(2 * 2e9 / 0.4 / 1e9)
    assert metric("driver.unbilled_share")(rec(jobs=[{"ok": True}])) is None


def span(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def timeline():
    """Two jobs over 0..1000 us; the device busy 100..300 (two overlapping
    kernels), 400..450 (a copy) and 600..700 (a torch kernel)."""
    return Trace([
        span(JOB_SPAN, 0, 500, "user_annotation"), span(JOB_SPAN, 500, 500, "user_annotation"),
        span("aten::copy_", 310, 80, "cpu_op"),
        span("void (anonymous namespace)::myers_regs<32>(unsigned int const*)", 100, 150, "kernel"),
        span("void (anonymous namespace)::myers_regs<32>(unsigned int const*)", 200, 100, "kernel"),
        span("Memcpy HtoD (Pinned -> Device)", 400, 50, "gpu_memcpy"),
        span("void at::native::elementwise_kernel<128, 2>(int)", 600, 100, "kernel"),
    ])


def test_idle_share_and_busy():
    t = timeline()
    assert t.jobs == 2 and t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx(350e-6)
    assert metric("device.idle_share")(rec(trace=t)) == pytest.approx(65.0)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert sum(gaps.values()) == pytest.approx(650e-6)


def test_kernel_times():
    t = timeline()
    assert t.kernel_seconds(["myers_regs"]) == pytest.approx(250e-6)
    assert t.kernel_seconds(["myers_strips"]) == 0
    r = rec(trace=t)
    assert metric("device.torch_ops_ms")(r) == pytest.approx(100e-6 / 2 * 1e3)
    assert metric("kernel.banded_ms")(r) is None
    ops = dict(t.device_ops())
    assert ops["void myers_regs<32>"] == pytest.approx(250e-6)


def test_myers_roofline():
    t = timeline()
    card = {"sms": 132, "clock_mhz": 1980.0}
    r = rec(trace=t, card=card, launches_per_job=[(2, 100)])
    floor = 2 * roofline_counts.myers_floor_s(2, 10, 100, 10, [(2, 100)], 132, 1980.0)
    assert metric("kernel.myers_roofline")(r) == pytest.approx(100 * floor / 250e-6)
    assert metric("kernel.myers_roofline")(rec(trace=t)) is None


def test_roofline_counts():
    assert roofline_counts.alu_ops(roofline_counts.MYERS_WORD_OPS) == 11
    assert roofline_counts.all_ops(roofline_counts.MYERS_WORD_OPS) == 12
    assert roofline_counts.alu_ops(roofline_counts.MYERS_COLUMN_OPS) == 2
    assert roofline_counts.words(960) == 30 and roofline_counts.words(150) == 5
    assert roofline_counts.myers_alu_ops(200, 960, 100_000, 960) == (11 * 30 + 2) * 960 * 200 * 100_000
    assert roofline_counts.alu_peak(132, 1980.0) == 64 * 132 * 1980e6
