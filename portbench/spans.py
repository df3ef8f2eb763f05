"""The device's idle seconds in a traced window, split by the program's
innermost ``bgsa.*`` span.

The program's ``bgsa.*`` ranges (``bgsa_tpu_torch.stats.Span``, on the
main thread) nest; a sweep over them alone, with every other host range
(``aten::*``, ``cuda*``, ``portbench.job``) left out, gives the innermost
span at each instant. Each idle interval of the device is cut at those
spans' boundaries and each piece billed to its span, the rest to
``(none)``, so the parts sum to the window's idle seconds.

    python3 -m portbench.spans TRACE.json

prints the split of a Chrome trace: the benchmark's, or one that
``bgsa-torch-align --profile DIR`` wrote. The window of a file runs from
its first ``bgsa.*`` range to its last.
"""

from __future__ import annotations

import json
import sys

PREFIX = "bgsa."
NONE = "(none)"


def innermost(host) -> list:
    """(start, end, name) of each stretch under one innermost ``bgsa.*``
    range, in order and disjoint, from ``Trace.host``. A range that
    outlasts its parent is cut at the parent's end."""
    ranges = sorted((t0, -t1, name) for t0, t1, name in host if name.startswith(PREFIX))
    pieces, stack, cursor = [], [], 0.0

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, name))
                cursor = end

    for t0, neg_t1, name in ranges:
        close_until(t0)
        if stack and t0 > cursor:
            pieces.append((cursor, t0, stack[-1][1]))
        cursor = t0
        stack.append((min(-neg_t1, stack[-1][0]) if stack else -neg_t1, name))
    close_until(float("inf"))
    return pieces


def idle(trace) -> list:
    """(start, end) of each stretch of ``trace.window`` with no device
    operation."""
    gaps, cursor = [], trace.window[0]
    for t0, t1 in trace.busy():
        if t0 > cursor:
            gaps.append((cursor, t0))
        cursor = max(cursor, t1)
    if trace.window[1] > cursor:
        gaps.append((cursor, trace.window[1]))
    return gaps


def idle_by_span(trace) -> dict:
    """Span name -> the device's idle seconds in ``trace.window`` under
    that innermost ``bgsa.*`` range; ``(none)`` -> those under none."""
    pieces, by, j = innermost(trace.host), {}, 0
    gaps = idle(trace)
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            t0, t1, name = pieces[k]
            part = min(g1, t1) - max(g0, t0)
            if part > 0:
                by[name] = by.get(name, 0.0) + part * 1e-6
            k += 1
    total = sum(g1 - g0 for g0, g1 in gaps) * 1e-6
    by[NONE] = max(total - sum(by.values()), 0.0)
    return by


def from_file(path: str):
    """The ``Trace`` of a Chrome trace file, its window from the first
    ``bgsa.*`` range to the last."""
    from portbench.trace import Trace

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    trace = Trace([e for e in events if e.get("ph") == "X" and "dur" in e])
    spans = [(t0, t1) for t0, t1, name in trace.host if name.startswith(PREFIX)]
    if not spans:
        raise ValueError(f"{path}: no {PREFIX}* range")
    trace.window = (min(t0 for t0, _ in spans), max(t1 for _, t1 in spans))
    return trace


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python3 -m portbench.spans TRACE.json", file=sys.stderr)
        return 2
    trace = from_file(argv[0])
    split = idle_by_span(trace)
    idle_s = sum(split.values())
    print(f"window {trace.window_s:.6f} s, device busy {trace.busy_s:.6f} s, "
          f"idle {idle_s:.6f} s")
    for name, seconds in sorted(split.items(), key=lambda kv: -kv[1]):
        share = 100.0 * seconds / idle_s if idle_s > 0 else 0.0
        print(f"{name:32s} {seconds:12.6f} s {share:7.2f} %")
    return 0


if __name__ == "__main__":
    sys.exit(main())
