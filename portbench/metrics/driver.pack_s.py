"""Host transport packing (RunStats.pack_time: pack.select_transport) per
traced job, in seconds."""


def read(rec):
    stats = [j["stats"] for j in rec.jobs if j.get("stats")]
    return sum(s["pack_time"] for s in stats) / len(stats) if stats else None
