"""Cells billed as the reference bills them (query_len x query_count x
subject_len x subject_count a job or call; the banded filter full-matrix),
over every job or call completed in the window, per second of the window's
wall time."""


def read(rec):
    done = [j for j in rec.jobs if j["ok"]]
    if not done or rec.window_s <= 0:
        return None
    return len(done) * rec.cells_per_job / rec.window_s / 1e9
