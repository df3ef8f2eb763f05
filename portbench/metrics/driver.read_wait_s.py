"""run_bucketed's wait for its reader thread (RunStats.read_wait_time:
the main thread at buckets.get()) per traced job, in seconds; None where a
job's stats lack the field."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    if not stats or any("read_wait_time" not in s for s in stats):
        return None
    return sum(s["read_wait_time"] for s in stats) / len(stats)
