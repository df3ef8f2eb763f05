"""The share of the database buckets whose transport payload the reader
thread's native pass built straight from the file's bytes
(RunStats.reader_packed_buckets) over the buckets the traced jobs read (one
entry of bucket_cal_times each), in percent; None where a job's stats lack
the counter."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    if not stats or any("reader_packed_buckets" not in s for s in stats):
        return None
    buckets = sum(len(s["bucket_cal_times"]) for s in stats)
    if buckets <= 0:
        return None
    return 100.0 * sum(s["reader_packed_buckets"] for s in stats) / buckets
