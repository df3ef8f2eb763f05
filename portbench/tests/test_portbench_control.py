"""What ``correct`` has to catch, on the CPU at small sizes: each
configuration's control, and the timed path broken underneath a whole run
(an answer altered where it is produced, half of the subjects left out, a
job that leaves its result unchanged). Also the no-card refusal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import control, core

SMALL = {
    "myers_unit_global.cli_960bp_q200": {"queries": 3, "query_len": 64, "subjects": 400,
                                         "subject_len": 64, "check_subjects": 60},
    "banded_k8.api_q8_s65k_mix30": {"subjects": 256, "pool": 2},
    "myers_unit_global.cli_150bp_1M": {"queries": 3, "subjects": 400, "check_subjects": 60},
    "banded_k8.cli_150bp_1M_mix30": {"queries": 3, "subjects": 400, "check_subjects": 60},
}


def run(cell, seed=3, seconds=0.3):
    return core.run(cell, seed, seconds, False, device="cpu", overrides=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert all(c["value"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_control_fails(cell, seed):
    got = control.readings(cell, seed, "cpu", SMALL[cell])
    assert not got["correct"]
    assert got["checks"]["score_mismatches"]["value"] >= got["answers_compared"] // 2


def altered(score_codes):
    """An answer altered where it is produced: query 0's answers + 1."""
    def wrapper(self, queries, codes):
        out = score_codes(self, queries, codes).clone()
        out[0] += 1
        return out
    return wrapper


def half_left_out(score_codes):
    """Half of the subjects left out: their answers stay 0."""
    def wrapper(self, queries, codes):
        half = codes.shape[0] // 2
        out = torch.zeros((queries.shape[0], codes.shape[0]), dtype=torch.int32)
        out[:, :half] = score_codes(self, queries, codes[:half])
        return out
    return wrapper


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_broken_kernel_output_is_caught(cell, fault, monkeypatch):
    from bgsa_tpu_torch.banded_pipeline import BandedEngine
    from bgsa_tpu_torch.pipeline import Engine

    for cls in (Engine, BandedEngine):
        monkeypatch.setattr(cls, "score_codes", fault(cls.score_codes))
    assert not run(cell)["correct"]


def test_cli_job_that_leaves_its_result_unchanged_is_caught(monkeypatch):
    """After the warm job, every job returns without running: the result the
    window leaves is not the last job's, and nothing is read."""
    from bgsa_tpu_torch import cli

    real, calls = cli.align_main, []

    def lazy(argv):
        calls.append(argv)
        return real(argv) if len(calls) == 1 else 0

    monkeypatch.setattr(cli, "align_main", lazy)
    result = run("myers_unit_global.cli_150bp_1M")
    assert not result["correct"]


def test_api_call_that_returns_its_last_answer_is_caught(monkeypatch):
    import bgsa_tpu_torch

    real, last = bgsa_tpu_torch.align, []

    def stale(*args, **kwargs):
        if not last:
            last.append(real(*args, **kwargs))
        return last[0]

    monkeypatch.setattr(bgsa_tpu_torch, "align", stale)
    assert not run("banded_k8.api_q8_s65k_mix30")["correct"]


def test_no_card_no_result():
    """Where no CUDA device is visible the harness exits non-zero and prints
    no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "banded_k8.api_q8_s65k_mix30", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_result_reader_counts_layout_errors(tmp_path):
    from portbench import check

    path = str(tmp_path / "r.bin")
    assert check.read_result(path, 2, 10, np.int16) == (1, None)
    with open(path + ".info", "wb") as f:
        f.write(np.array([1, 1], np.int32).tobytes() + np.array([2], np.int64).tobytes())
        f.write(np.array([128], np.int64).tobytes() + np.array([118], np.int32).tobytes())
    np.arange(2 * 128, dtype=np.int16).tofile(path)
    errors, result = check.read_result(path, 2, 10, np.int16)
    assert errors == 0
    assert result.scores(np.array([0, 1]), np.array([3, 9])).tolist() == [3, 128 + 9]
    assert check.read_result(path, 2, 11, np.int16)[0] == 1  # a subject missing
    assert check.read_result(path, 3, 10, np.int16)[0] >= 1  # another query count
