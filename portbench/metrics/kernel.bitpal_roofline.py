"""The BitPAl kernels' share of their roofline: the least time the traced
jobs' pairs need (roofline_bitpal: the frozen ALU count of the packed
network at 64 x SMs x the maximum SM clock, or the launches' bytes at
3.35 TB/s, the larger) over the profiler's device time of the BitPAl
kernels, in %."""

from portbench import roofline_bitpal


def read(rec):
    if rec.trace is None or rec.card is None or not rec.trace.jobs:
        return None
    seconds = rec.trace.kernel_seconds(rec.kernels["bitpal"])
    if seconds <= 0:
        return None
    w, sc = rec.workload, rec.config["scoring"]
    floor = rec.trace.jobs * roofline_bitpal.floor_s(
        (sc["match"], sc["mismatch"], sc["gap"]), w["queries"], w["query_len"], w["subjects"],
        w["subject_len"], rec.launches_per_job, rec.card["sms"], rec.card["clock_mhz"])
    return 100.0 * floor / seconds
