"""The port's hand-run tools on the CPU: gpu_parity and the two paired-query
experiments with ``--device cpu`` at shrunken sizes, gpu_parity's checks
against scripts/tpu_parity.py's, and the timing chain of benchutil."""

import ast
import os
import re

import numpy as np
import pytest
import torch

from bgsa_tpu_torch import benchutil
from bgsa_tpu_torch.scripts import exp_banded_packed_pair, exp_banded_pair, gpu_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def small_parity(monkeypatch):
    for name, value in dict(Q=2, M=37, S=48, N=45, BANDED_M=70, BANDED_S=24, BANDED_NEAR=8,
                            PACKED_LANES=4, PACKED_NEAR=3).items():
        monkeypatch.setattr(gpu_parity, name, value)


def tpu_parity_checks():
    """The names tpu_parity.py checks, each formatted field as ``{}``."""
    with open(os.path.join(REPO, "scripts", "tpu_parity.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "check":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value)
            else:  # an f-string
                names.add("".join(v.value if isinstance(v, ast.Constant) else "{}"
                                  for v in arg.values))
    return names


def as_template(name):
    """A gpu_parity check name with tpu_parity's formatted fields as ``{}``."""
    name = re.sub(r"banded (stream|peq-carry) (s>q|s==q|s<q)", r"banded \1 {}", name)
    return re.sub(r"n_sub=\d+ \(k=\d+\)", "n_sub={} (k={})", name)


def test_gpu_parity_passes_on_the_cpu_and_checks_what_tpu_parity_checks(small_parity, capsys):
    assert gpu_parity.main(["7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    ran = [line[4:] for line in out.splitlines() if line.startswith("ok  ")]
    assert not [line for line in out.splitlines() if line.startswith("FAIL")]
    assert len(ran) == len(set(ran)) == 22
    skipped = {name.replace("{label}", "{}") for name in gpu_parity.SKIPPED}
    assert {as_template(name) for name in ran} | skipped == tpu_parity_checks()
    assert skipped == {"banded stream {} (no block exit)"}
    # the packed banded fields the CPU suite cannot run in interpret mode
    assert {"banded packed n_sub=5 (k=5)", "banded packed n_sub=6 (k=4)"} <= set(ran)


def test_gpu_parity_fails_on_a_wrong_score(small_parity, monkeypatch, capsys):
    from bgsa_tpu_torch.ops import myers_pallas

    real = myers_pallas.myers_global
    monkeypatch.setattr(myers_pallas, "myers_global", lambda *a, **kw: real(*a, **kw) + 1)
    assert gpu_parity.main(["--device", "cpu"]) == 1
    assert "FAIL myers_pallas 31-bit global" in capsys.readouterr().out


def test_tools_without_a_gpu_exit_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (gpu_parity.main, exp_banded_pair.main, exp_banded_packed_pair.main):
        assert main([]) == 1


@pytest.fixture
def small_experiments(monkeypatch):
    for mod, subjects in ((exp_banded_pair, 300), (exp_banded_packed_pair, 768)):
        for name, value in dict(QUERIES=4, SUBJECTS=subjects, CHAIN=2, REPS=2).items():
            monkeypatch.setattr(mod, name, value)


def test_exp_banded_pair_on_the_cpu(small_experiments, capsys):
    assert exp_banded_pair.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0].strip() for line in lines] == [
        "single", "pair", "p_full", "p_statc", "p_noload"]
    assert all("not a device time" in line for line in lines)


@pytest.mark.parametrize("kind", ["mix", "garbage"])
def test_exp_banded_packed_pair_on_the_cpu(small_experiments, capsys, kind):
    assert exp_banded_packed_pair.main([kind, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sorted(line.split(":")[0].strip() for line in lines) == [
        f"[{kind}] {name}" for name in ("p_full", "p_noload", "p_statc", "packed", "pair")]


def test_experiment_gates_fail_loudly(small_experiments, monkeypatch, capsys):
    from bgsa_tpu_torch.ops import banded_pair

    real = banded_pair.banded_stream_pair
    monkeypatch.setattr(banded_pair, "banded_stream_pair", lambda *a, **kw: real(*a, **kw) * 0)
    assert exp_banded_pair.main(["--device", "cpu"]) == 1
    assert "MISMATCH" in capsys.readouterr().err


@pytest.mark.parametrize("what", ["pair", "probe"])
def test_packed_experiment_gates_fail_loudly(small_experiments, monkeypatch, capsys, what):
    from bgsa_tpu_torch.ops import banded_packed_pair

    name = "banded_packed_pair" if what == "pair" else "banded_packed_probe"
    real = getattr(banded_packed_pair, name)
    monkeypatch.setattr(banded_packed_pair, name, lambda *a, **kw: real(*a, **kw) + 1)
    assert exp_banded_packed_pair.main(["mix", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "MISMATCH" in err and (name + (" " if what == "probe" else " != ")) in err


def test_experiment_shapes_are_the_jax_scripts():
    # scripts/exp_banded_pair.py:210-216 and exp_banded_packed_pair.py:158-162
    assert (exp_banded_pair.SEED, exp_banded_pair.QUERIES, exp_banded_pair.SUBJECTS,
            exp_banded_pair.LENGTH, exp_banded_pair.K) == (7, 8, 65536, 150, 8)
    assert (exp_banded_packed_pair.SEED, exp_banded_packed_pair.QUERIES,
            exp_banded_packed_pair.LENGTH, exp_banded_packed_pair.K) == (13, 8, 150, 8)
    q, s = exp_banded_packed_pair.inputs("garbage")
    assert q.shape == (8, 150) and s.shape == (65280, 150)  # n_sub = 3
    assert (exp_banded_pair.CHAIN, exp_banded_pair.REPS) == (24, 8)


def test_experiment_kernel_patterns_find_their_kernels_only():
    # the profiler reports demangled or mangled names; each variant's pattern
    # must find its own kernel's instances (the stream kernel's are
    # banded_stream_kernel<Dual, Wide>: the single variant runs <false, *>)
    # and no other kernel of the chain
    demangled = {
        "single": ["banded_stream_kernel<false, false>", "banded_stream_kernel<false, true>"],
        "pair": ["banded_stream_pair_kernel"],
        "p_full": ["banded_probe_kernel<0>"], "p_statc": ["banded_probe_kernel<1>"],
        "p_noload": ["banded_probe_kernel<2>"],
        "packed": ["banded_packed_kernel<3>"], "p_pair": ["banded_packed_pair_kernel<3>"],
    }
    mangled = {
        "single": ["20banded_stream_kernelILb0ELb0EEEvPKjPKhPi",
                   "20banded_stream_kernelILb0ELb1EEEvPKjPKhPi"],
        "pair": ["25banded_stream_pair_kernelEPKjPKhS4_Pi"],
        "p_full": ["19banded_probe_kernelILi0EEvPKj"],
        "p_statc": ["19banded_probe_kernelILi1EEvPKj"],
        "p_noload": ["19banded_probe_kernelILi2EEvPKj"],
        "packed": ["20banded_packed_kernelILi3EEvPKj"],
        "p_pair": ["25banded_packed_pair_kernelILi3EEvPKj"],
    }
    others = ["banded_stream_kernel<true, false>", "20banded_stream_kernelILb1ELb1EEEv"]
    patterns = {**exp_banded_pair.KERNELS, "packed": exp_banded_packed_pair.KERNELS["packed"],
                "p_pair": exp_banded_packed_pair.KERNELS["pair"]}
    names = {v: [f"(anonymous namespace)::{n}(unsigned int const*, int)" for n in demangled[v]]
             + [f"_ZN41_GLOBAL__N__5899619a_9_banded_cu_7b921b5d{n}" for n in mangled[v]]
             for v in demangled}
    for variant, pattern in patterns.items():
        for other, listed in names.items():
            for name in listed:
                assert bool(re.search(pattern, name)) == (other == variant), (variant, name)
        assert not any(re.search(pattern, name) for name in others), variant


def test_chain_of_runs_serially_with_a_zero_dependency():
    calls = []

    def run_q(q):
        calls.append(q.clone())
        return torch.full((2, 3), -(len(calls) * 1000), dtype=torch.int32)

    queries = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    sample = benchutil.chain_of(run_q, queries, 5)
    assert sample() == -10000  # out[0, 0] + out[-1, -1] of the last run
    assert len(calls) == 5 and all(torch.equal(c, queries) for c in calls)
    # the dependency is |out[0, 0]| // 2**30: a score of 2**30 would add 1
    seen = []

    def big(q):
        seen.append(q.clone())
        return torch.full((1, 1), 1 << 30, dtype=torch.int32)

    benchutil.chain_of(big, queries, 2)()
    assert torch.equal(seen[1], queries + 1)


def test_elapsed_ms_on_the_cpu_is_the_host_clock():
    assert benchutil.elapsed_ms(lambda: np.zeros(10).sum(), "cpu") >= 0.0


def test_kernel_times_and_rates():
    # the profiler's kernel times exist on the card only; the billed rate is
    # cells over the median time
    assert benchutil.kernel_times({"a": lambda: 0}, {"a": "k"}, "cpu", 24) == {}
    assert benchutil.median_gcups(1e9, {"a": [1.0, 2.0, 30.0]}) == {"a": 500.0}
    assert benchutil.device_name("cpu") == "cpu"


@pytest.mark.parametrize("counts, attempts", [([24], 1), ([23, 24], 2), ([23, 22, 24], 3)])
def test_kernel_times_profiles_again_when_a_launch_goes_unseen(monkeypatch, counts, attempts):
    # a run whose profiler count differs from the chain's is taken again; the
    # first run that sees every launch gives the times
    seen = iter(counts)
    calls = []

    def fake_kernel_ms(fn, kernel):
        calls.append(kernel)
        return [0.5] * next(seen)

    monkeypatch.setattr(benchutil, "kernel_ms", fake_kernel_ms)
    times = benchutil.kernel_times({"a": lambda: 0}, {"a": "k"}, "cuda", 24)
    assert times == {"a": [0.5] * 24} and calls == ["k"] * attempts


@pytest.mark.parametrize("count", [23, 25, 0])
def test_kernel_times_fails_when_no_run_sees_the_chain(monkeypatch, count):
    # a pattern that never matches exactly the chain's launches is a failed gate
    monkeypatch.setattr(benchutil, "kernel_ms", lambda fn, kernel: [0.5] * count)
    with pytest.raises(benchutil.GateFailure, match=rf"\[{count}, {count}, {count}\]"):
        benchutil.kernel_times({"a": lambda: 0}, {"a": "k"}, "cuda", 24)
