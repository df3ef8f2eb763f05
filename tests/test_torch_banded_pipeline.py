"""The port's banded filter end to end on the CPU, against bgsa_tpu.

``run_banded`` result and ``.info`` files must be byte-equal to
``bgsa_tpu.banded_pipeline.run_banded``'s (XLA backend) on the same files,
and scores equal to the behavioural model ``bgsa_tpu.banded_ref``; the CLI
applies ``bgsa-align``'s rules for ``-k``.
"""

import os

import numpy as np
import pytest
import torch

from bgsa_tpu import banded_pipeline as jax_banded_pipeline
from bgsa_tpu import cli as jax_cli
from bgsa_tpu import banded_ref as model
from bgsa_tpu.benchutil import filter_mix_dataset
from bgsa_tpu.pipeline import PipelineConfig as JaxConfig
from bgsa_tpu_torch import align, cli
from bgsa_tpu_torch import banded_pipeline as port
from bgsa_tpu_torch.pipeline import PipelineConfig


def read(path):
    with open(path, "rb") as f:
        return f.read()


def write_lines(path, codes):
    with open(path, "w") as f:
        f.writelines("".join("ACGTN"[c] for c in row) + "\n" for row in codes)


def filter_files(tmp_path, Q, S, m, n, seed=1):
    """Query and subject files of the read-filter mix (30 % near-duplicates),
    subjects cut or extended to n bp."""
    rng = np.random.default_rng(seed)
    q, s = filter_mix_dataset(rng, Q, S, m)
    if n > m:
        s = np.concatenate([s, rng.integers(0, 4, size=(S, n - m))], axis=1)
    s = s[:, :n].copy()
    s[rng.random(s.shape) < 0.005] = 4
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    write_lines(qp, q)
    write_lines(sp, s)
    return qp, sp, q, s


@pytest.mark.parametrize("m,n,k,S,cfg", [
    (150, 150, 8, 300, {}),                                 # packed, n_sub = 3
    (60, 60, 8, 2000, {"bucket_size": 40000}),               # packed, several buckets
    (150, 150, 8, 300, {"banded_packed": False}),           # the stream kernel instead
    (150, 181, 16, 200, {}),                                # stream, band_down = 63
    (150, 148, 8, 200, {}),                                 # dual stream
    (55, 20, 40, 200, {}),                                  # Peq-carry
], ids=["packed", "multibucket", "stream", "stream-63", "dual", "peq-carry"])
def test_run_banded_matches_jax(tmp_path, m, n, k, S, cfg):
    qp, sp, q, s = filter_files(tmp_path, 3, S, m, n)
    got, want = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    stats = port.run_banded(qp, sp, got, k, PipelineConfig(**cfg), device="cpu")
    jax_banded_pipeline.run_banded(qp, sp, want, k, JaxConfig(backend="xla", **cfg))
    assert read(got) == read(want)
    assert read(got + ".info") == read(want + ".info")
    assert stats.subject_count == S
    scores = np.frombuffer(read(got), np.int8)
    assert (scores == 127).any() and (scores < 127).any()
    if S <= 300:  # one bucket: (Q, S padded to 128 lanes), query-major
        np.testing.assert_array_equal(
            scores.reshape(3, -1)[:, :S], [model.banded_scores(qi, s, k) for qi in q])


def test_banded_resume_completes_a_truncated_run(tmp_path):
    qp, sp, _, _ = filter_files(tmp_path, 3, 2000, 60, 60)
    cfg = PipelineConfig(bucket_size=40000)
    full, cut = str(tmp_path / "full.bin"), str(tmp_path / "cut.bin")
    port.run_banded(qp, sp, full, 8, cfg, device="cpu")
    port.run_banded(qp, sp, cut, 8, cfg, device="cpu")
    with open(cut, "r+b") as f:
        f.truncate(os.path.getsize(full) // 2 + 7)  # mid-bucket
    port.run_banded(qp, sp, cut, 8, cfg, device="cpu", resume=True)
    assert read(cut) == read(full) and read(cut + ".info") == read(full + ".info")


def test_convert_infers_int8_from_the_ports_file(tmp_path):
    qp, sp, q, s = filter_files(tmp_path, 2, 200, 100, 100)
    res, conv = str(tmp_path / "r.bin"), str(tmp_path / "r.txt")
    port.run_banded(qp, sp, res, 4, device="cpu")
    assert jax_cli.convert_main(["-r", res, "-o", conv]) == 0  # bgsa-convert, no --banded
    want = np.array([model.banded_scores(qi, s, 4) for qi in q])
    lines = np.loadtxt(conv, dtype=np.int64).reshape(2, -1)  # 200 subjects padded to 256
    np.testing.assert_array_equal(lines[:, :200], want)


def test_banded_engine_routes_like_jax():
    engine = port.BandedEngine(8, device="cpu")
    assert engine.route(150, 150) == "banded_stream_packed"
    assert engine.route(150, 181) == "banded_stream"  # band too wide to pack
    assert engine.route(150, 148) == "banded_stream_dual"
    assert port.BandedEngine(40, device="cpu").route(55, 20) == "banded"
    assert port.BandedEngine(8, PipelineConfig(banded_packed=False), "cpu").route(
        150, 150) == "banded_stream"


@pytest.mark.parametrize("name", list(port.KERNELS))
@pytest.mark.parametrize("m,n,k,takes", [
    (150, 150, 8, set(port.KERNELS)),
    (150, 148, 8, {"banded_stream_dual", "banded"}),
    (55, 20, 40, {"banded"}),
])
def test_kernel_args_feed_each_kernel_that_takes_the_geometry(m, n, k, takes, name):
    rng = np.random.default_rng(m + n + k)
    q, s = filter_mix_dataset(rng, 2, 49, max(m, n))  # 49: the packed route pads
    q, s = torch.from_numpy(q[:, :m]), torch.from_numpy(s[:, :n].astype(np.int32))
    engine = port.BandedEngine(k, device="cpu")
    kernel = port.KERNELS[name][0]
    if name not in takes:
        with pytest.raises(ValueError):
            kernel(*engine.kernel_args(name, s, m), q, q_len=m, s_len=n, k=k)
        return
    got = kernel(*engine.kernel_args(name, s, m), q, q_len=m, s_len=n, k=k)[:, :49]
    np.testing.assert_array_equal(got, [model.banded_scores(qi, s.numpy(), k) for qi in q])


def test_kernel_args_rejects_an_unknown_kernel():
    with pytest.raises(ValueError, match="no banded kernel"):
        port.BandedEngine(8, device="cpu").kernel_args("myers", torch.zeros((4, 8)), 8)


def test_banded_engine_pads_to_n_sub_only():
    # 301 subjects: the packed route pads to 303 (n_sub = 3), not to a lane multiple
    rng = np.random.default_rng(4)
    q, s = filter_mix_dataset(rng, 2, 301, 150)
    got = np.asarray(port.BandedEngine(8, device="cpu").scores(q, s.astype(np.uint8)))
    assert got.dtype == np.int8 and got.shape == (2, 301)
    np.testing.assert_array_equal(got, [model.banded_scores(qi, s, 8) for qi in q])


def test_run_banded_rejects_unported_roles():
    with pytest.raises(NotImplementedError, match="multi-host"):
        port.run_banded("q", "d", "unused.bin", 8, shard=(0, 2), device="cpu")
    # local sharding is ported: two shards need two local devices (the CPU is one)
    with pytest.raises(ValueError, match="exceeds the 1 visible local device"):
        port.BandedEngine(8, PipelineConfig(local_shards=2), "cpu")


@pytest.mark.parametrize("single", [True, False])
def test_align_k_matches_model(single):
    rng = np.random.default_rng(9)
    q, s = filter_mix_dataset(rng, 3, 40, 70)
    got = align(q[0] if single else q, s, k=6, device="cpu")
    want = np.array([model.banded_scores(qi, s, 6) for qi in q], dtype=np.int8)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want[0] if single else want)


def test_cli_banded_run_matches_jax(tmp_path, capsys):
    qp, sp, _, _ = filter_files(tmp_path, 3, 2000, 60, 60)
    res, stats = str(tmp_path / "r.bin"), str(tmp_path / "stats.json")
    assert cli.align_main(["-q", qp, "-d", sp, "-f", res, "-k", "8", "--bucket-size", "40000",
                           "--stats-json", stats, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "score is 0, -1, -1" in out
    want = str(tmp_path / "jax.bin")
    jax_banded_pipeline.run_banded(qp, sp, want, 8,
                                   JaxConfig(backend="xla", bucket_size=40000))
    assert read(res) == read(want) and read(res + ".info") == read(want + ".info")
    assert '"subject_count": 2000' in read(stats).decode()


@pytest.mark.parametrize("flags,message", [
    (["-k", "8", "-M", "0"], "-M/-I/-G cannot combine with -k"),
    (["-k", "8", "-I", "-1"], "-M/-I/-G cannot combine with -k"),
    (["-k", "8", "--semi-global"], "--semi-global cannot combine with -k"),
    (["-k", "-1"], "-k must be >= 0"),
], ids=["match", "mismatch", "semi-global", "negative"])
def test_cli_k_rules(tmp_path, capsys, flags, message):
    qp, sp, _, _ = filter_files(tmp_path, 2, 10, 60, 60)
    res = str(tmp_path / "r.bin")
    assert cli.align_main(["-q", qp, "-d", sp, "-f", res, "--device", "cpu", *flags]) == 1
    assert message in capsys.readouterr().err
    assert not os.path.exists(res)


def test_cli_k_without_gpu_exits_nonzero(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qp, sp, _, _ = filter_files(tmp_path, 2, 10, 60, 60)
    res = str(tmp_path / "r.bin")
    assert cli.align_main(["-q", qp, "-d", sp, "-f", res, "-k", "4"]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not os.path.exists(res)


def test_cli_k_geometry_error_exits_1(tmp_path, capsys):
    # a band wider than the 64-bit register is refused, as bgsa-align refuses it
    qp, sp, _, _ = filter_files(tmp_path, 2, 10, 100, 145)
    res = str(tmp_path / "r.bin")
    assert cli.align_main(["-q", qp, "-d", sp, "-f", res, "-k", "20", "--device", "cpu"]) == 1
    assert "band of 86 bits" in capsys.readouterr().err
