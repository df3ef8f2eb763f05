"""The port's pipeline, CLI and API on the CPU, against bgsa_tpu and the goldens.

Result and .info files must be byte-equal to bgsa_tpu.pipeline's (XLA
backend) on the same inputs and configuration, and their conversions
byte-equal to the reference goldens.
"""

import os

import numpy as np
import pytest
import torch

from bgsa_tpu import oracle
from bgsa_tpu import banded_pipeline as jax_banded_pipeline
from bgsa_tpu import pipeline as jax_pipeline
from bgsa_tpu import schemes as jax_schemes
from bgsa_tpu.io import result as result_io
from bgsa_tpu.pipeline import PipelineConfig as JaxConfig
from bgsa_tpu_torch import align, cli
from bgsa_tpu_torch import pipeline as port
from bgsa_tpu_torch.pipeline import PipelineConfig
from bgsa_tpu_torch.schemes import Mode, Scoring, normalize

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
SAMPLE = (os.path.join(REPO, "sample-data", "query.txt"),
          os.path.join(REPO, "sample-data", "subject.txt"))
MULTI = (os.path.join(GOLDEN, "multibucket_query.txt"),
         os.path.join(GOLDEN, "multibucket_subject.txt"))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_golden(tmp_path, res, golden):
    conv = str(tmp_path / "conv.txt")
    result_io.convert_result(res, conv)
    assert read(conv) == read(os.path.join(GOLDEN, golden))


@pytest.mark.parametrize("inputs,cfg,mode,golden", [
    (SAMPLE, {}, Mode.GLOBAL, "sample_myers_global.txt"),
    (MULTI, {"bucket_size": 40000}, Mode.GLOBAL, "multibucket_scores.txt"),
    (MULTI, {"bucket_size": 40000}, Mode.SEMI_GLOBAL, None),
], ids=["sample", "multibucket", "multibucket-semi"])
def test_run_alignment_matches_jax_and_golden(tmp_path, inputs, cfg, mode, golden):
    got, want = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    stats = port.run_alignment(*inputs, got, mode=mode, config=PipelineConfig(**cfg),
                               device="cpu")
    jax_pipeline.run_alignment(*inputs, want, mode=jax_schemes.Mode(mode.value),
                               config=JaxConfig(backend="xla", **cfg))
    assert read(got) == read(want)
    assert read(got + ".info") == read(want + ".info")
    assert stats.subject_count == (128 if inputs is SAMPLE else 2000)
    if golden:
        assert_golden(tmp_path, got, golden)


def test_resume_completes_a_truncated_run(tmp_path):
    full, cut = str(tmp_path / "full.bin"), str(tmp_path / "cut.bin")
    cfg = PipelineConfig(bucket_size=40000)
    port.run_alignment(*MULTI, full, config=cfg, device="cpu")
    port.run_alignment(*MULTI, cut, config=cfg, device="cpu")
    with open(cut, "r+b") as f:
        f.truncate(os.path.getsize(full) // 2 + 7)  # mid-bucket
    port.run_alignment(*MULTI, cut, config=cfg, device="cpu", resume=True)
    assert read(cut) == read(full) and read(cut + ".info") == read(full + ".info")


def test_cli_global_and_fasta_inputs(tmp_path):
    res = str(tmp_path / "r.bin")
    assert cli.align_main(["-q", SAMPLE[0], "-d", SAMPLE[1], "-f", res,
                           "--device", "cpu", "--quiet"]) == 0
    assert_golden(tmp_path, res, "sample_myers_global.txt")
    fasta = str(tmp_path / "s.fa")
    with open(SAMPLE[1]) as f, open(fasta, "w") as g:
        for i, line in enumerate(f):
            g.write(f">s{i}\n{line}")
    res_fa = str(tmp_path / "fa.bin")
    assert cli.align_main(["-q", SAMPLE[0], "-d", fasta, "-f", res_fa,
                           "--device", "cpu", "--quiet"]) == 0
    assert read(res_fa) == read(res)


def test_cli_semi_global_stats_json(tmp_path):
    res, stats = str(tmp_path / "r.bin"), str(tmp_path / "stats.json")
    assert cli.align_main(["-q", MULTI[0], "-d", MULTI[1], "-f", res, "--semi-global",
                           "--bucket-size", "40000", "--stats-json", stats,
                           "--device", "cpu", "--quiet"]) == 0
    want = str(tmp_path / "jax.bin")
    jax_pipeline.run_alignment(*MULTI, want, mode=jax_schemes.Mode.SEMI_GLOBAL,
                               config=JaxConfig(backend="xla", bucket_size=40000))
    assert read(res) == read(want)
    assert '"subject_count": 2000' in read(stats).decode()


@pytest.mark.parametrize("flags", [
    ["-k", "8"],
    ["-M", "2", "-I", "-3", "-G", "-5"],
    ["--shards", "2"],
    ["--host", "0:2"],
    ["-t", "cuda+cpu"],
    ["-D"],
], ids=["banded", "bitpal", "shards", "host", "hetero", "dynamic"])
def test_cli_rejects_unported_flags(tmp_path, capsys, flags):
    res = str(tmp_path / "r.bin")
    rc = cli.align_main(["-q", SAMPLE[0], "-d", SAMPLE[1], "-f", res, "--device", "cpu",
                         "--quiet", *flags])
    if flags[0] == "-k":  # the banded filter is ported: it runs, as bgsa-align's does
        assert rc == 0
        want = str(tmp_path / "jax.bin")
        jax_banded_pipeline.run_banded(*SAMPLE, want, 8, JaxConfig(backend="xla"))
        assert read(res) == read(want) and read(res + ".info") == read(want + ".info")
        return
    if flags[0] == "-M":  # BitPAl is ported: it runs, as bgsa-align's does
        assert rc == 0
        want = str(tmp_path / "jax.bin")
        jax_pipeline.run_alignment(*SAMPLE, want, scoring=jax_schemes.Scoring(2, -3, -5),
                                   config=JaxConfig(backend="xla"))
        assert read(res) == read(want) and read(res + ".info") == read(want + ".info")
        return
    assert rc == 1
    if flags[0] == "--shards":  # ported: refused as bgsa-align refuses it (one CPU device)
        assert "--shards 2 exceeds the 1 visible local device(s)" in capsys.readouterr().err
        return
    assert "not ported yet" in capsys.readouterr().err
    assert not os.path.exists(res)


def test_cli_unit_scoring_flags_run(tmp_path):
    # (0, 2, 2) is unit-cost Myers with factor 2
    res = str(tmp_path / "r.bin")
    assert cli.align_main(["-q", SAMPLE[0], "-d", SAMPLE[1], "-f", res, "-M", "0", "-I", "2",
                           "-G", "2", "--device", "cpu", "--quiet"]) == 0
    ref = str(tmp_path / "ref.bin")
    jax_pipeline.run_alignment(*SAMPLE, ref, scoring=jax_schemes.Scoring(0, 2, 2),
                               config=JaxConfig(backend="xla"))
    assert read(res) == read(ref)


@pytest.mark.parametrize("device_flags", [[], ["--device", "cuda"]], ids=["default", "cuda"])
def test_cli_without_gpu_exits_nonzero(tmp_path, capsys, monkeypatch, device_flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = str(tmp_path / "r.bin")
    assert cli.align_main(["-q", SAMPLE[0], "-d", SAMPLE[1], "-f", res, *device_flags]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not os.path.exists(res)


def test_api_readme_example():
    assert align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"], device="cpu").tolist() == [0, -1, -2, -3]


@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.SEMI_GLOBAL])
def test_api_multi_query_matches_oracle(mode):
    rng = np.random.default_rng(7)
    q = rng.integers(0, 5, size=(3, 33))
    s = rng.integers(0, 5, size=(5, 40))
    got = align(q, s, mode=mode, device="cpu")
    assert got.shape == (3, 5) and got.dtype == np.int16
    want = np.stack([-oracle.edit_distances(qi, s, jax_schemes.Mode(mode.value)) for qi in q])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(align(q[1], s, mode=mode, device="cpu"), want[1])


def test_api_rejects_unported_paths():
    # k= is ported: the banded filter answers, as bgsa_tpu.align does
    got = align("ACGTACGT", ["ACGTACGT", "ACGTACGA", "TTTTTTTT"], k=2, device="cpu")
    assert got.dtype == np.int8 and got.tolist() == [0, 1, 127]
    # general scoring is ported: BitPAl answers, as bgsa_tpu.align does
    got = align("ACGT", ["ACGT", "ACGA", "TTTT"], scoring=Scoring(2, -3, -5), device="cpu")
    assert got.dtype == np.int16 and got.tolist() == [8, 3, -7]


def test_engine_rejects_unported_configurations():
    myers = normalize(Scoring(0, -1, -1))
    # local sharding is ported: two shards need two local devices (the CPU is one)
    with pytest.raises(ValueError, match="exceeds the 1 visible local device"):
        port.Engine(myers, PipelineConfig(local_shards=2), "cpu")
    # BitPAl is ported: the engine takes the packed kernel in 31-bit words
    bitpal = port.Engine(normalize(Scoring(2, -3, -5)), PipelineConfig(), "cpu")
    assert (bitpal.kernel, bitpal.word_bits) == ("bitpal_packed", 31)
    with pytest.raises(ValueError, match="M > I > 2G"):
        port.Engine(normalize(Scoring(1, -4, -2)), PipelineConfig(), "cpu")
    with pytest.raises(NotImplementedError, match="multi-host"):
        port.run_alignment(*SAMPLE, "unused.bin", shard=(0, 2), device="cpu")


def test_device_scores_fetch():
    scores = port.DeviceScores(torch.arange(6, dtype=torch.int16).reshape(2, 3))
    assert np.asarray(scores[1, 2]) == 5
    host = np.asarray(scores, dtype=np.int32)
    assert host.dtype == np.int32 and host.tolist() == [[0, 1, 2], [3, 4, 5]]
