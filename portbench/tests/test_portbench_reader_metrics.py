"""The reader-thread, read-wait and padding metrics on synthetic records."""

import pytest

from portbench.tests.test_portbench_metrics import metric, rec, stats


def test_reader_and_pad_readers():
    new = {"read_wait_time": 0.4, "reader_read_time": 0.1, "reader_encode_time": 0.2,
           "scored_rows": 1_140_480, "subject_count": 1_000_000}
    jobs = [{"ok": True, "stats": {**stats(0.1, 0.2, 0.1, 0.05, 0.05, 1.0), **new}},
            {"ok": True, "stats": {**stats(0.1, 0.2, 0.1, 0.05, 0.05, 1.0), **new,
                                   "read_wait_time": 0.2, "reader_read_time": 0.3}},
            {"ok": False}]
    r = rec(jobs=jobs)
    assert metric("driver.read_wait_s")(r) == pytest.approx(0.3)
    assert metric("driver.reader_read_s")(r) == pytest.approx(0.2)
    assert metric("driver.reader_encode_s")(r) == pytest.approx(0.2)
    assert metric("engine.pad_share")(r) == pytest.approx(100 * (1 - 1_000_000 / 1_140_480))
    assert round(metric("engine.pad_share")(r), 2) == 12.32  # the 150 bp cells' layout
    # the 960 bp cell's: four buckets of 29,824 rows for 100,000 subjects
    nine_sixty = {**new, "scored_rows": 119_296, "subject_count": 100_000}
    assert round(metric("engine.pad_share")(rec(jobs=[{"stats": nine_sixty}])), 4) == 16.1749


@pytest.mark.parametrize("name,key", [
    ("driver.read_wait_s", "read_wait_time"), ("driver.reader_read_s", "reader_read_time"),
    ("driver.reader_encode_s", "reader_encode_time"), ("engine.pad_share", "scored_rows")])
def test_new_readers_find_nothing_in_older_stats(name, key):
    """Stats from before these four fields existed: no value, no error."""
    old = stats(0.1, 0.2, 0.1, 0.05, 0.05, 1.0)
    assert metric(name)(rec(jobs=[{"ok": True, "stats": {**old, "subject_count": 10}}])) is None
    full = {**old, "subject_count": 10, "read_wait_time": 0.1, "reader_read_time": 0.1,
            "reader_encode_time": 0.1, "scored_rows": 20}
    partial = {k: v for k, v in full.items() if k != key}
    assert metric(name)(rec(jobs=[{"stats": full}, {"stats": partial}])) is None
    assert metric(name)(rec(jobs=[{"stats": full}])) is not None
    assert metric(name)(rec()) is None
