"""The reader thread's file reads and newline checks
(RunStats.reader_read_time, wall seconds) per traced job; None where a
job's stats lack the field."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    if not stats or any("reader_read_time" not in s for s in stats):
        return None
    return sum(s["reader_read_time"] for s in stats) / len(stats)
