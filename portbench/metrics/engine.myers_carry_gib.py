"""The largest carry buffer that one Myers strip launch allocated, in GiB:
myers_carry_peak_bytes / 2^30, the largest over the traced jobs; None where
a job's stats lack the counters or no Myers launch ran."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    if not stats or any("myers_carry_peak_bytes" not in s for s in stats):
        return None
    if sum(s.get("myers_word_columns", 0) for s in stats) <= 0:
        return None
    return max(s["myers_carry_peak_bytes"] for s in stats) / 2**30
