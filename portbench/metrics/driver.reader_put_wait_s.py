"""run_bucketed's reader thread blocked on a full queue
(RunStats.reader_put_wait_time: the reader at buckets.put(), the main
thread behind) per traced job, in seconds; None where a job's stats lack
the field."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    if not stats or any("reader_put_wait_time" not in s for s in stats):
        return None
    return sum(s["reader_put_wait_time"] for s in stats) / len(stats)
