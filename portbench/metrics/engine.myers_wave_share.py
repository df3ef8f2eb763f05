"""The share of the Myers word-columns that ran on the strips' wavefront
(``myers_strips_wave``): 100 x myers_wave_word_columns / myers_word_columns
over the traced jobs, in %; None where a job's stats lack the counters or
no Myers launch ran."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    if not stats or any("myers_wave_word_columns" not in s or "myers_word_columns" not in s
                        for s in stats):
        return None
    total = sum(s["myers_word_columns"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * sum(s["myers_wave_word_columns"] for s in stats) / total
