"""BENCHMARK.json against the rules it is checked by, and the harness's
lookup by name: a configuration, a workload and a metric added as new files
are found without an edit to any file that is there."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return core.benchmark()


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s, each cell 2 x 90 s
    # more to compile, and 1200 s spare, inside 43200 s
    assert 24 * (14 * (bench["run_seconds"] + 60) + 180) + 2 * (bench["run_seconds"] + 60) \
        + 1200 <= 43200


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    for w in bench["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in bench["configs"]:
        names += c["reduced"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = core.load_json(core.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        workload, config = core.cell(bench, w["name"])  # the files, found by name
        assert config["name"] == w["config"]
        assert os.path.exists(os.path.join(core.HERE, "paths", workload["path"] + ".py"))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_workload_files_name_existing_configs():
    for name in os.listdir(os.path.join(core.HERE, "workloads")):
        workload = core.load_json(core.HERE, "workloads", name)
        assert os.path.exists(os.path.join(core.HERE, "configs", workload["config"] + ".json"))
        assert name == f"{workload['config']}.{workload['traffic']}.json"


def test_metrics(bench):
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    names = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", names)) <= names
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and set(m["workloads"]) <= names
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in core.metrics_for(bench, cell, False)}
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(core.HERE, "metrics", m["name"] + ".py"))
    for cell in names:  # setup_s, another end-to-end metric and a per-layer one
        e2e = {m["name"] for m in core.metrics_for(bench, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.metrics_for(bench, cell, True)


def test_new_files_are_found_without_edits(tmp_path):
    """A copy of the checkout's benchmark gains a configuration, a workload
    and a metric as new files (and entries in BENCHMARK.json); a CPU run of
    the new cell finds all three, and no file of the copy changed."""
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(core.ROOT, "bgsa_tpu_torch"), root / "bgsa_tpu_torch")
    bench = core.benchmark()
    before = {p: open(p, "rb").read() for p in map(str, (root / "portbench").rglob("*"))
              if os.path.isfile(p)}
    cfg = core.load_json(core.HERE, "configs", "banded_k8.json")
    cfg.update(name="banded_k5", k=5, source="https://example.org/k5")
    (root / "portbench/configs/banded_k5.json").write_text(json.dumps(cfg))
    wl = core.load_json(core.HERE, "workloads", "banded_k8.cli_150bp_1M_mix30.json")
    wl.update(config="banded_k5", traffic="tiny", queries=2, subjects=300, check_subjects=30)
    (root / "portbench/workloads/banded_k5.tiny.json").write_text(json.dumps(wl))
    (root / "portbench/metrics/jobs_done.py").write_text(
        "def read(rec):\n    return float(len(rec.jobs))\n")
    bench["configs"].append({"name": "banded_k5", "source": cfg["source"],
                             "file": "portbench/configs/banded_k5.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "banded_k5.tiny", "config": "banded_k5",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "total_gcups",
                               "workloads": ["banded_k5.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from portbench import core; "
            "print(json.dumps(core.run('banded_k5.tiny', 5, 0.3, True, device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["jobs_done"]["value"] >= 1
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
