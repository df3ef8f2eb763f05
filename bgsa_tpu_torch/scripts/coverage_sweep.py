"""Line coverage of the test suite over bgsa_tpu_torch/ (sys.monitoring).

The twin of ``scripts/coverage_sweep.py``, pointed at the port. It runs
pytest in this process under a PEP 669 LINE monitor restricted to the
package, then prints every executable line that no test ran, with its
source: the worklist of a code audit (an unhit branch is where a silent
fault lives).

    python -m bgsa_tpu_torch.scripts.coverage_sweep [pytest args...]
    # on the CPU:  ... -m "not slow" tests/test_torch_*.py
    # on a card:   ... --noconftest -m cuda tests/test_torch_cuda.py

It exits with pytest's code. Each line location is recorded at its first
hit and then switched off (``sys.monitoring.DISABLE``), so a hot loop costs
one callback, not one a trip. ``python -m`` imports the package (and what
its ``__init__`` imports) before the monitor starts: those modules' top-level
lines ran at that import and count as hit. Needs Python 3.12
(``sys.monitoring``).

Caveats: lines run only in child processes (the CLI and role subprocess
tests, the demo) show as unhit, and so do the CUDA launchers on a machine
without a card; read the listing with that in mind rather than chasing
100 %. Two runs (the CPU's and the card's) are read side by side: a line
unhit in both is the worklist.
"""

from __future__ import annotations

import dis
import inspect
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = os.path.basename(PKG)
TOOL = 3  # a free PEP 669 tool id

hit: set = set()


def _on_line(code, line):
    if code.co_filename.startswith(PKG):
        hit.add((code.co_filename, line))
    return sys.monitoring.DISABLE


def _compiled(path: str):
    with open(path) as f:
        src = f.read()
    return src, compile(src, path, "exec")


def top_level_lines(path: str) -> set:
    """What the module's import runs: the lines of its own code object and
    of its class bodies (code objects that are not functions)."""
    lines: set = set()

    def walk(code):
        lines.update(line for _off, line in dis.findlinestarts(code) if line)
        for const in code.co_consts:
            if hasattr(const, "co_code") and not const.co_flags & inspect.CO_OPTIMIZED:
                walk(const)

    walk(_compiled(path)[1])
    return lines


def executable_lines(path: str) -> set:
    """Lines holding bytecode in any code object of the file, less the
    structural ones (a ``def``/``class``/decorator/docstring line runs at
    import, not when its body does)."""
    src, code = _compiled(path)
    lines: set = set()

    def walk(code):
        for _off, line in dis.findlinestarts(code):
            if line:
                lines.add(line)
        for const in code.co_consts:
            if hasattr(const, "co_code"):
                walk(const)

    walk(code)
    src_lines = src.splitlines()
    return {ln for ln in lines if ln <= len(src_lines) and not src_lines[ln - 1].lstrip()
            .startswith(("def ", "class ", "@", '"""', "'''"))}


def report(hits: set, out=sys.stdout) -> None:
    """The listing: the package's total, then each file's unhit lines."""
    missing: dict[str, list[int]] = {}
    total = hit_count = 0
    for root, dirs, files in os.walk(PKG):
        dirs.sort()
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            lines = executable_lines(path)
            total += len(lines)
            got = {ln for (f, ln) in hits if f == path}
            hit_count += len(lines & got)
            if lines - got:
                missing[path] = sorted(lines - got)
    print(f"\n=== {NAME} line coverage: {hit_count}/{total} "
          f"({100.0 * hit_count / max(total, 1):.1f}%) ===", file=out)
    for path, miss in sorted(missing.items()):
        print(f"\n{os.path.relpath(path, os.path.dirname(PKG))}: {len(miss)} unhit", file=out)
        with open(path) as f:
            src_lines = f.read().splitlines()
        for ln in miss:
            print(f"  {ln:5d}: {src_lines[ln - 1].rstrip()[:100]}", file=out)


def main(argv=None) -> int:
    import pytest

    for module in list(sys.modules.values()):  # imported before the monitor started
        path = getattr(module, "__file__", None) or ""
        if path.startswith(PKG) and path.endswith(".py"):
            hit.update((path, line) for line in top_level_lines(path))
    mon = sys.monitoring
    mon.use_tool_id(TOOL, "bgsa-torch-cov")
    mon.register_callback(TOOL, mon.events.LINE, _on_line)
    mon.set_events(TOOL, mon.events.LINE)
    try:
        rc = pytest.main(list(sys.argv[1:] if argv is None else argv) or ["-q", "tests/"])
    finally:
        mon.set_events(TOOL, 0)
        mon.register_callback(TOOL, mon.events.LINE, None)
        mon.free_tool_id(TOOL)
    report(hit)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
