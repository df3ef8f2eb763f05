"""The port stands alone: it imports nothing of bgsa_tpu and never jax.

An AST scan of every module of the port and of chip_smoke.py finds no
import of bgsa_tpu (lazy imports inside functions included); a fresh
interpreter imports every module of the port and chip_smoke, runs each
family through ``align()`` on the CPU, on one device and on shards, and has
loaded no jax and no bgsa_tpu module; and the port refuses bgsa_tpu's
look-alike types instead of misrouting them.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

from bgsa_tpu import pipeline as jax_pipeline
from bgsa_tpu import schemes as jax_schemes
from bgsa_tpu_torch import align
from bgsa_tpu_torch import pipeline as port
from bgsa_tpu_torch.banded_pipeline import BandedEngine
from bgsa_tpu_torch.schemes import Mode, Scoring, normalize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(os.path.join(REPO, "bgsa_tpu_torch", "**", "*.py"), recursive=True))
SOURCES.append("chip_smoke.py")


def jax_package_imports(tree):
    """(line, name) of every import of bgsa_tpu or bgsa_tpu.* in the tree."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "bgsa_tpu" or n.startswith("bgsa_tpu.")]
    return found


@pytest.mark.parametrize("path", SOURCES)
def test_no_module_imports_bgsa_tpu(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    assert jax_package_imports(tree) == []


def test_the_scan_sees_lazy_imports():
    tree = ast.parse("def f():\n    from bgsa_tpu.pack import x\n    import bgsa_tpu\n"
                     "import bgsa_tpu_torch\nfrom . import pack\n")
    assert jax_package_imports(tree) == [(2, "bgsa_tpu.pack"), (3, "bgsa_tpu")]


PROGRAM = r"""
import importlib, pkgutil, sys
import bgsa_tpu_torch
for info in pkgutil.walk_packages(bgsa_tpu_torch.__path__, "bgsa_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
from bgsa_tpu_torch import Mode, Scoring, align
from bgsa_tpu_torch.pipeline import PipelineConfig
q, s = "ACGTACGT", ["ACGTACGT", "ACGTACGA", "TTTTTTTT", "ACGAACGT", "ACGTTCGT"]
for devices in (None, ["cpu"] * 2):
    kw = dict(device="cpu", devices=devices)
    assert align(q, s, **kw).tolist() == [0, -1, -6, -1, -1]
    assert align(q, s, mode=Mode.SEMI_GLOBAL, **kw).tolist() == [0, -1, -6, -1, -1]
    for packed in (True, False):  # the packed and non-packed BitPAl kernels
        got = align(q, s, scoring=Scoring(2, -3, -5), config=PipelineConfig(bitpal_packed=packed),
                    **kw)
        assert got.tolist() == [16, 11, -14, 11, 11], got
    assert align(q, s, k=2, **kw).tolist() == [0, 1, 127, 1, 1]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bgsa_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_port_and_chip_smoke_load_no_jax_and_no_bgsa_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def foreign(kind):
    return {"mode": dict(mode=jax_schemes.Mode.SEMI_GLOBAL),
            "scoring": dict(scoring=jax_schemes.Scoring(2, -3, -5))}[kind]


@pytest.mark.parametrize("kind", ["mode", "scoring"])
def test_foreign_scheme_types_raise(kind):
    with pytest.raises(TypeError, match="bgsa_tpu_torch's"):
        normalize(**{"scoring": Scoring(), "mode": Mode.GLOBAL, **foreign(kind)})
    with pytest.raises(TypeError, match="bgsa_tpu_torch's"):
        align("ACGT", ["ACGT"], device="cpu", **foreign(kind))
    with pytest.raises(TypeError, match="bgsa_tpu_torch's"):
        port.run_alignment("q", "d", "unused.bin", device="cpu", **foreign(kind))


def test_a_jax_mode_would_have_scored_as_global():
    # why the port refuses: identity checks against its own enum would take
    # a foreign SEMI_GLOBAL for GLOBAL without a word
    assert jax_schemes.Mode.SEMI_GLOBAL is not Mode.SEMI_GLOBAL
    assert jax_schemes.Mode.SEMI_GLOBAL.value == Mode.SEMI_GLOBAL.value


@pytest.mark.parametrize("what", ["scheme", "config", "banded-config"])
def test_engines_refuse_foreign_schemes_and_configs(what):
    with pytest.raises(TypeError, match="bgsa_tpu_torch's"):
        if what == "scheme":
            port.Engine(jax_schemes.normalize(jax_schemes.Scoring()), port.PipelineConfig(), "cpu")
        elif what == "config":
            port.Engine(normalize(Scoring()), jax_pipeline.PipelineConfig(), "cpu")
        else:
            BandedEngine(4, jax_pipeline.PipelineConfig(), "cpu")
