"""On the card (marker ``cuda``; skips without one): a short run of each
cell through ``python3 -m portbench.run``, in a child process, prints a
correct result."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import core

CELLS = [w["name"] for w in core.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "0"], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert {"setup_s", "total_gcups"} <= set(result["metrics"])
