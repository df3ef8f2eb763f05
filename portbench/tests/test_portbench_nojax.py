"""No JAX: a CPU run of the harness and the reference load neither JAX nor
the JAX package (top-level module names compared whole: ``bgsa_tpu_torch``
is the port), and the reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from portbench import core

CODE = """
import json, sys
from portbench import core, reference, control
import torch
result = core.run("banded_k8.cli_150bp_1M_mix30", 9, 0.2, False, device="cpu",
                  overrides={"queries": 2, "subjects": 200, "check_subjects": 20})
control.readings("myers_unit_global.cli_150bp_1M", 9, "cpu",
                 {"queries": 2, "subjects": 200, "query_len": 30, "subject_len": 30,
                  "check_subjects": 20})
reference.global_scores(torch.zeros((2, 5), dtype=torch.uint8), torch.ones((2, 5), dtype=torch.uint8))
print(json.dumps({"correct": result["correct"], "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_runs_load_no_jax():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "bgsa_tpu_torch" in got["tops"]  # the port, which the check must not confuse
    assert not set(got["tops"]) & set(core.FORBIDDEN)


def imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_sources_import_no_jax():
    for dirpath, _, files in os.walk(core.HERE):
        for name in files:
            if name.endswith(".py"):
                found = imports(os.path.join(dirpath, name)) & set(core.FORBIDDEN)
                assert not found, (name, found)


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(core.HERE, "reference.py")
    assert imports(path) <= {"__future__", "torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bgsa_tpu_torch_lookalike", sys)
    assert core.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in core.forbidden_modules()
