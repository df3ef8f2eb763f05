"""The share of the traced jobs' total time that no RunStats phase bills:
1 - (read + pack + cal + write + compile) / total, summed over the jobs.
The bucketed driver's wait for its reader thread hides here."""

PHASES = ("read_time", "pack_time", "cal_time", "write_time", "compile_time")


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    total = sum(s["total_time"] for s in stats)
    if not stats or total <= 0:
        return None
    return 100.0 * (1.0 - sum(s[p] for s in stats for p in PHASES) / total)
