"""Device time of the port's banded kernels per job or call, in ms."""


def read(rec):
    if rec.trace is None or not rec.trace.jobs:
        return None
    seconds = rec.trace.kernel_seconds(rec.kernels["banded"])
    return seconds / rec.trace.jobs * 1e3 if seconds > 0 else None
