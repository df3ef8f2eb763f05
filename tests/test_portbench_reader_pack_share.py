"""driver.reader_pack_share on synthetic records: 100 where the reader
packed every bucket the jobs read, None where a job's stats lack the
counter, its buckets or the stats."""

import pytest

from portbench.tests.test_portbench_metrics import metric, rec, stats

NAME = "driver.reader_pack_share"


def job(packed_buckets, buckets, ok=True):
    return {"ok": ok, "stats": {**stats(0.1, 0.0, 0.1, 0.05, 0.05, 1.0),
                                "reader_native_buckets": buckets,
                                "reader_packed_buckets": packed_buckets,
                                "bucket_cal_times": [0.01] * buckets}}


def test_share_of_the_buckets_read():
    assert metric(NAME)(rec(jobs=[job(6, 6), job(6, 6)])) == pytest.approx(100.0)
    assert metric(NAME)(rec(jobs=[job(6, 6), job(0, 6)])) == pytest.approx(50.0)
    assert metric(NAME)(rec(jobs=[job(3, 4), {"ok": False}])) == pytest.approx(75.0)


@pytest.mark.parametrize("jobs", [
    [{"ok": True, "stats": {**stats(0.1, 0.2, 0.1, 0.05, 0.05, 1.0), "reader_native_buckets": 6,
                            "bucket_cal_times": [0.1] * 6}}],  # a tree without the counter
    [job(6, 6), {"stats": {**stats(0.1, 0.2, 0.1, 0.05, 0.05, 1.0), "bucket_cal_times": [0.1]}}],
    [],
    [job(0, 0)],
], ids=["older-stats", "one-job-lacks-it", "no-stats", "no-bucket"])
def test_nothing_to_read_gives_none(jobs):
    assert metric(NAME)(rec(jobs=jobs)) is None
