"""Device time of every kernel that is none of the port's own CUDA kernels
(the lists under kernels/), per job or call, in ms: the plain-torch
unpacking, Eq and stream packing, narrowing and the like."""


def read(rec):
    if rec.trace is None or not rec.trace.jobs or not rec.trace.device:
        return None
    names = [n for family in rec.kernels.values() for n in family]
    return rec.trace.other_kernel_seconds(names) / rec.trace.jobs * 1e3
