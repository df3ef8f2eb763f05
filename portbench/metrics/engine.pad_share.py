"""The share of the subject rows handed to the engine that no user asked
for: 100 x (1 - subject_count / scored_rows) over the traced jobs, in %
(the 'N' lane pads and run_bucketed's shape pad); None where a job's stats
lack scored_rows."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    rows = sum(s.get("scored_rows", 0) for s in stats)
    if not stats or any("scored_rows" not in s for s in stats) or rows <= 0:
        return None
    return 100.0 * (1.0 - sum(s["subject_count"] for s in stats) / rows)
