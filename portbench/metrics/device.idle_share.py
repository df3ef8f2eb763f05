"""The share of the traced window in which no operation ran on the
device: 1 - (the union of its kernels', copies' and fills' intervals) /
the window, in %."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0 or not rec.trace.device:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
