"""The traced run's device record: ``torch.profiler`` over the whole window
(CPU and CUDA activity; ``portbench.job`` marks each job), read back from
its Chrome trace.

``Trace`` holds the device's activity (kernels, copies, fills), the host's
ranges, the window, and what the result line's ``device`` and
``breakdown`` report: the busy seconds (the union of the device's
intervals), the device operations that took most time, and the idle gaps
named by the innermost host range that covers each.
"""

from __future__ import annotations

import bisect
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
JOB_SPAN = "portbench.job"
TOP = 10
LOOKBACK = 256  # host ranges scanned back from a gap for the innermost one


def start(device: str):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def stop(prof, path: str) -> "Trace":
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return Trace([e for e in events if e.get("ph") == "X" and "dur" in e])


def short_name(name: str) -> str:
    """A kernel's name without its argument list and anonymous namespace:
    the function and its template arguments."""
    return name.replace("(anonymous namespace)::", "").split("(", 1)[0][:160]


class Trace:
    def __init__(self, events: list):
        # (start us, end us, name) of each device operation and host range
        self.device = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e.get("cat"))
                             for e in events if e.get("cat") in DEVICE_CATS)
        self.host = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                           for e in events if e.get("cat") in HOST_CATS)
        jobs = [h for h in self.host if h[2] == JOB_SPAN]
        self.jobs = len(jobs)
        self.window = (jobs[0][0], jobs[-1][1]) if jobs else (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> list:
        """The union of the device's intervals inside the window."""
        w0, w1 = self.window
        merged = []
        for t0, t1, _, _ in self.device:
            t0, t1 = max(t0, w0), min(t1, w1)
            if t1 <= t0:
                continue
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy()) * 1e-6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose function is one of ``names``."""
        pattern = re.compile(r"(?<![A-Za-z0-9_])(%s)(?![A-Za-z0-9_])" % "|".join(
            re.escape(n) for n in names)) if names else None
        return sum(t1 - t0 for t0, t1, name, cat in self.device
                   if cat == "kernel" and pattern and pattern.search(name)) * 1e-6

    def other_kernel_seconds(self, names) -> float:
        """Device seconds of every kernel whose function is none of ``names``."""
        total = sum(t1 - t0 for t0, t1, _, cat in self.device if cat == "kernel") * 1e-6
        return total - self.kernel_seconds(names)

    def device_ops(self) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = {}
        for t0, t1, name, _ in self.device:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (t1 - t0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[host range, idle seconds]: the device's idle time inside the
        window, each gap named by the innermost host range (other than the
        job's own) that covers its middle, summed by name."""
        busy = self.busy()
        gaps, cursor = [], self.window[0]
        for t0, t1 in busy:
            if t0 > cursor:
                gaps.append((cursor, t0))
            cursor = max(cursor, t1)
        if self.window[1] > cursor:
            gaps.append((cursor, self.window[1]))
        starts = [h[0] for h in self.host]
        by = {}
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            i = bisect.bisect_right(starts, mid)
            name = "no host range (Python, numpy or native code)"
            for h0, h1, hname in reversed(self.host[max(0, i - LOOKBACK):i]):
                if h1 >= mid and hname != JOB_SPAN:
                    name = hname
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
