"""Seconds from the harness's first statement (the interpreter's own start
is before it) to the start of the first timed job: imports, the kernel
library's build or load, the inputs drawn and written, one warm job."""


def read(rec):
    return rec.setup_s
