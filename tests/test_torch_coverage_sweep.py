"""bgsa_tpu_torch.scripts.coverage_sweep over a tiny pytest target.

The sweep runs pytest in a child process on a test file in ``tmp_path``
that calls one function of the port (``debug.format_binary``): its listing
shows a line of that module no test ran (``format_lanes``' body) and not
the line that ran, and it exits with pytest's code.
"""

import os
import re
import subprocess
import sys

import pytest

from bgsa_tpu_torch import debug
from bgsa_tpu_torch.scripts import coverage_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = """from bgsa_tpu_torch import debug


def test_one():
    assert debug.format_binary(5, 4) == {want!r}
"""


def line_of(text: str) -> int:
    with open(debug.__file__) as f:
        lines = f.read().splitlines()
    return next(i for i, line in enumerate(lines, 1) if line.strip() == text)


@pytest.mark.parametrize("want,rc", [("1010", 0), ("0000", 1)], ids=["passes", "fails"])
def test_the_sweep_lists_unhit_lines_and_exits_with_pytests_code(tmp_path, want, rc):
    (tmp_path / "test_tiny.py").write_text(TARGET.format(want=want))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "bgsa_tpu_torch.scripts.coverage_sweep", "-q",
         "-p", "no:cacheprovider", str(tmp_path / "test_tiny.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == rc, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    total = re.search(r"=== bgsa_tpu_torch line coverage: (\d+)/(\d+) \(([\d.]+)%\) ===", out)
    assert total and 0 < int(total.group(1)) < int(total.group(2))
    listing = out.split("\nbgsa_tpu_torch/debug.py: ", 1)[1].split("\n\n", 1)[0]
    unhit = {int(m) for m in re.findall(r"^\s+(\d+): ", listing, re.M)}
    hit = line_of('s = "".join("1" if (w >> b) & 1 else "0" for b in range(bits))')
    assert hit not in unhit
    assert line_of("flat = np.asarray(arr).reshape(-1)") in unhit  # format_lanes
    assert line_of("LAUNCHES = 0") not in unhit  # the import ran it
    # a module the package imports before the monitor starts (through -m):
    # its top level and class bodies ran then
    from bgsa_tpu_torch import schemes

    with open(schemes.__file__) as f:
        src = f.read().splitlines()
    member = next(i for i, line in enumerate(src, 1) if line.strip() == 'MYERS = "myers"')
    schemes_listing = out.split("\nbgsa_tpu_torch/schemes.py: ", 1)
    assert len(schemes_listing) == 1 or f"{member:5d}: " not in schemes_listing[1].split(
        "\n\n", 1)[0]


def test_executable_lines_leave_out_structure():
    lines = coverage_sweep.executable_lines(debug.__file__)
    with open(debug.__file__) as f:
        src = f.read().splitlines()
    assert line_of("flat = np.asarray(arr).reshape(-1)") in lines
    assert not any(src[ln - 1].lstrip().startswith(("def ", "class ", "@")) for ln in lines)
