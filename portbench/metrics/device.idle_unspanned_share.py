"""The share of the device's idle seconds in the traced window that no
``bgsa.*`` range of the program covers (``portbench.spans``), in %: the
idle that no span of the program names."""

from portbench import spans


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0 or not rec.trace.device:
        return None
    split = spans.idle_by_span(rec.trace)
    idle = sum(split.values())
    return 100.0 * split[spans.NONE] / idle if idle > 0 else 0.0
