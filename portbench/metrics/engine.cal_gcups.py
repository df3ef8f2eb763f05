"""The reference's cal GCUPS over the traced jobs: cells over
RunStats.cal_time (the engine's dispatch and each bucket's 4-byte fetch)."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    cal = sum(s["cal_time"] for s in stats)
    return len(stats) * rec.cells_per_job / cal / 1e9 if stats and cal > 0 else None
