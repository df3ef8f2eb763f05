"""The port imports torch and never jax: the GPU machines have no jax at all."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = """
import sys
import bgsa_tpu_torch, bgsa_tpu_torch.cli, bgsa_tpu_torch.pipeline
import bgsa_tpu_torch.banded_pipeline
from bgsa_tpu_torch.ops import banded, banded_packed, bitpal, bitpal_packed, build
scores = bgsa_tpu_torch.align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"], device="cpu")
assert scores.tolist() == [0, -1, -2, -3], scores
scores = bgsa_tpu_torch.align("ACGTACGT", ["ACGTACGT", "ACGTACGA", "TTTTTTTT"], k=2,
                              device="cpu")
assert scores.tolist() == [0, 1, 127], scores
from bgsa_tpu.schemes import Scoring
for packed in (True, False):  # the packed and non-packed BitPAl kernels
    config = bgsa_tpu_torch.pipeline.PipelineConfig(bitpal_packed=packed)
    scores = bgsa_tpu_torch.align("ACGT", ["ACGT", "ACGA", "TTTT"], scoring=Scoring(2, -3, -5),
                                  config=config, device="cpu")
    assert scores.tolist() == [8, 3, -7], scores
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert build._kernels is None and not build._scheme_kernels, "a CPU run built CUDA kernels"
print("ok")
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
