"""bgsa_tpu_torch.scripts.multihost_demo on the CPU.

The demo (two ``--host`` roles, merge and convert, for Myers and the banded
filter) reports both families byte-equal to the single-host run, and that
single-host text equals ``bgsa_tpu``'s ``run_alignment`` / ``run_banded``
(XLA backend) result, converted, on the same files. Each step runs as a
child process in one test; the others run the module's own functions with
its ``sh`` calling ``cli.main`` in this process. With the single-host text
altered before the compare, or a role failing, it exits 1.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bgsa_tpu.banded_pipeline import run_banded as jax_run_banded
from bgsa_tpu.io.result import convert_result as jax_convert
from bgsa_tpu.pipeline import PipelineConfig as JaxConfig
from bgsa_tpu.pipeline import run_alignment as jax_run_alignment
from bgsa_tpu_torch import cli
from bgsa_tpu_torch.scripts import multihost_demo as demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--device", "cpu", "--subjects", "2000", "--hosts", "2", "--banded"]


def test_the_demo_runs_its_steps_as_child_processes(tmp_path):
    # Myers only: each step is a child process that imports torch (~3 s
    # here); concurrent roles (OMP_NUM_THREADS=2); the tests below run the
    # demo in-process, the roles in turn
    out = tmp_path / "demo"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "bgsa_tpu_torch.scripts.multihost_demo", str(out), "--device",
         "cpu", "--subjects", "600", "--hosts", "2", "--concurrent"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads((out / "report.json").read_text())
    assert json.loads(proc.stdout.splitlines()[-1]) == report
    assert list(report["families"]) == ["myers"]
    stats = report["families"]["myers"]
    assert stats["byte_equal_vs_single_host"] is True and len(stats["roles_s"]) == 2


def test_the_demo_merges_both_families_byte_equal_to_bgsa_tpu(tmp_path, monkeypatch):
    out = tmp_path / "demo"
    monkeypatch.setattr(demo, "sh", in_process_sh(lambda path: None))
    assert demo.main([str(out), *FLAGS]) == 0
    report = json.loads((out / "report.json").read_text())
    assert set(report["families"]) == {"myers", "banded"}
    for name, stats in report["families"].items():
        assert stats["byte_equal_vs_single_host"] is True, name
        assert len(stats["roles_s"]) == 2
    qp, sp = str(out / "query20_150bp.txt"), str(out / "subj2000_150bp.txt")
    with open(sp, "rb") as f:
        assert f.read().count(b"\n") == 2000
    xla = JaxConfig(backend="xla")
    for name, run, dtype in (
            ("myers", lambda res: jax_run_alignment(qp, sp, res, config=xla), np.int16),
            ("banded", lambda res: jax_run_banded(qp, sp, res, 8, xla), np.int8)):
        res = str(tmp_path / f"{name}_jax.bin")
        run(res)
        jax_convert(res, res + ".txt", write_dtype=dtype)
        with open(res + ".txt", "rb") as f, open(out / name / "single.txt", "rb") as g:
            assert f.read() == g.read(), name


def in_process_sh(alter_single):
    """``demo.sh`` running ``python -m bgsa_tpu_torch.cli ...`` in this
    process; after the Myers single-host convert, ``alter_single(path)``."""

    def sh(args, env_extra=None, tag=""):
        assert args[1:3] == ["-m", demo.CLI], args
        if cli.main(args[3:]) != 0:
            demo.fail(f"FAILED ({tag})")
        if tag == "myers convert single":
            alter_single(args[args.index("-o") + 1])
        return 0.0

    return sh


def test_an_altered_single_host_text_exits_1(tmp_path, monkeypatch, capsys):
    def alter(path):
        with open(path, "ab") as f:
            f.write(b"0\n")

    monkeypatch.setattr(demo, "sh", in_process_sh(alter))
    with pytest.raises(SystemExit) as err:
        demo.main([str(tmp_path), "--device", "cpu", "--subjects", "600", "--hosts", "2"])
    assert err.value.code == 1
    assert "myers: merged output != single-host output" in capsys.readouterr().err
    assert not (tmp_path / "report.json").exists()


def test_in_process_roles_in_turn_are_byte_equal(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(demo, "sh", in_process_sh(lambda path: None))
    assert demo.main([str(tmp_path), "--device", "cpu", "--subjects", "600", "--hosts", "3",
                      "--banded", "--k", "4"]) == 0
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["hosts"] == 3 and report["device"] == "cpu"
    for stats in report["families"].values():
        assert stats["byte_equal_vs_single_host"] is True and len(stats["roles_s"]) == 3


def test_without_a_card_the_demo_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert demo.main([str(tmp_path / "x")]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


def test_a_failed_concurrent_role_exits_1(tmp_path, monkeypatch, capsys):
    popen = subprocess.Popen

    def failing_role(args, **kw):  # each role's child exits 3
        return popen([sys.executable, "-c", "import sys; sys.exit(3)"])

    monkeypatch.setattr(demo, "sh", in_process_sh(lambda path: None))
    monkeypatch.setattr(demo.subprocess, "Popen", failing_role)
    with pytest.raises(SystemExit) as err:
        demo.main([str(tmp_path), "--device", "cpu", "--subjects", "300", "--concurrent"])
    assert err.value.code == 1 and "role 0 failed" in capsys.readouterr().err


def test_a_relative_outdir_works_from_any_directory(tmp_path, monkeypatch):
    # the children run from the repository's root: every path they get is
    # absolute (scripts/multihost_demo.py passes the caller's relative ones)
    seen = []
    run = in_process_sh(lambda path: None)

    def sh(args, env_extra=None, tag=""):
        seen.extend(a for a in args[3:] if "demo_out" in a)
        return run(args, env_extra, tag)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(demo, "sh", sh)
    assert demo.main(["demo_out", "--device", "cpu", "--subjects", "300"]) == 0
    assert seen and all(os.path.isabs(a) for a in seen)
    assert json.loads((tmp_path / "demo_out" / "report.json").read_text())["families"]
