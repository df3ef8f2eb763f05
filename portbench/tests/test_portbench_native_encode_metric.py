"""driver.native_encode_share on synthetic records."""

import pytest

from portbench.tests.test_portbench_metrics import metric, rec, stats

NAME = "driver.native_encode_share"


def job(native_buckets, buckets, ok=True):
    return {"ok": ok, "stats": {**stats(0.1, 0.2, 0.1, 0.05, 0.05, 1.0),
                                "reader_native_buckets": native_buckets,
                                "bucket_cal_times": [0.01] * buckets}}


def test_share_of_the_buckets_read():
    assert metric(NAME)(rec(jobs=[job(6, 6), job(6, 6)])) == pytest.approx(100.0)
    assert metric(NAME)(rec(jobs=[job(6, 6), job(0, 6)])) == pytest.approx(50.0)
    assert metric(NAME)(rec(jobs=[job(3, 4), {"ok": False}])) == pytest.approx(75.0)


def test_nothing_to_read_gives_none():
    """Stats from before the counter existed, no stats, or no bucket read."""
    old = stats(0.1, 0.2, 0.1, 0.05, 0.05, 1.0)
    assert metric(NAME)(rec(jobs=[{"ok": True, "stats": {**old, "bucket_cal_times": [0.1]}}])) \
        is None
    assert metric(NAME)(rec(jobs=[job(4, 4), {"stats": {**old, "bucket_cal_times": [0.1]}}])) \
        is None
    assert metric(NAME)(rec()) is None
    assert metric(NAME)(rec(jobs=[job(0, 0)])) is None
