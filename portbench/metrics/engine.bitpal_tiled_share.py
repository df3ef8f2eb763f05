"""The share of the BitPAl word-columns that ran on the tiled kernel:
100 x bitpal_tiled_word_columns / bitpal_word_columns over the traced jobs,
in %; None where a job's stats lack the counters or no BitPAl launch ran."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    if not stats or any("bitpal_word_columns" not in s for s in stats):
        return None
    total = sum(s["bitpal_word_columns"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * sum(s["bitpal_tiled_word_columns"] for s in stats) / total
