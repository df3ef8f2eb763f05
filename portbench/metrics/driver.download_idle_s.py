"""The device's idle seconds whose innermost ``bgsa.*`` range is
``bgsa.download`` (the score block's copy to the host in run_bucketed's
write; ``portbench.spans``) per traced job; None where the trace has no
such range."""

from portbench import spans

SPAN = "bgsa.download"


def read(rec):
    if rec.trace is None or not rec.trace.jobs or not rec.trace.device:
        return None
    if not any(name == SPAN for _, _, name in rec.trace.host):
        return None
    return spans.idle_by_span(rec.trace).get(SPAN, 0.0) / rec.trace.jobs
