"""The port's BitPAl path end to end on the CPU: pipeline, CLI and API.

Result and .info files must be byte-equal to bgsa_tpu's (XLA backend) on
the same inputs and configuration, the 96 bp sample's conversion
byte-equal to the reference golden, and ``align(scoring=...)`` equal to the
numpy oracle. ``bgsa-torch-align`` takes ``--packed/--no-packed`` and
``--carry`` with ``bgsa-align``'s rules, word for word.
"""

import os

import numpy as np
import pytest

from bgsa_tpu import cli as jax_cli
from bgsa_tpu import pipeline as jax_pipeline
from bgsa_tpu.io import result as result_io
from bgsa_tpu.oracle import align_scores, align_scores_query_in_subject
from bgsa_tpu.pipeline import PipelineConfig
from bgsa_tpu.schemes import Mode, Scoring, normalize
from bgsa_tpu_torch import align, cli
from bgsa_tpu_torch import pipeline as port

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
SAMPLE = (os.path.join(REPO, "sample-data", "query.txt"),
          os.path.join(REPO, "sample-data", "subject.txt"))
MULTI = (os.path.join(GOLDEN, "multibucket_query.txt"),
         os.path.join(GOLDEN, "multibucket_subject.txt"))
BITPAL = Scoring(2, -3, -5)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def write_prefix(src, dst, bp):
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            g.write(line[:bp].rstrip("\n") + "\n")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_sample_96bp_matches_reference_golden(tmp_path, packed):
    # tests/test_golden.py's BitPAl golden: the reference's generated
    # (2,-3,-5) kernel on the 96 bp prefixes of sample-data
    qp, sp = str(tmp_path / "q96.txt"), str(tmp_path / "s96.txt")
    write_prefix(SAMPLE[0], qp, 96)
    write_prefix(SAMPLE[1], sp, 96)
    res, conv = str(tmp_path / "r.bin"), str(tmp_path / "conv.txt")
    stats = port.run_alignment(qp, sp, res, scoring=BITPAL,
                               config=PipelineConfig(bitpal_packed=packed), device="cpu")
    assert (stats.query_count, stats.subject_count) == (3, 128)
    result_io.convert_result(res, conv)
    assert read(conv) == read(os.path.join(GOLDEN, "sample_bitpal_2_m3_m5_96bp.txt"))


@pytest.mark.parametrize("carry", [None, True, False], ids=["carry-auto", "carry", "no-carry"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_run_alignment_matches_jax(tmp_path, packed, carry):
    cfg = dict(bucket_size=40000, bitpal_packed=packed, bitpal_carry=carry)
    got, want = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    stats = port.run_alignment(*MULTI, got, scoring=BITPAL, config=PipelineConfig(**cfg),
                               device="cpu")
    jax_pipeline.run_alignment(*MULTI, want, scoring=BITPAL,
                               config=PipelineConfig(backend="xla", **cfg))
    assert stats.subject_count == 2000
    assert read(got) == read(want)
    assert read(got + ".info") == read(want + ".info")


@pytest.mark.parametrize("flags", [
    ["-M", "2", "-I", "-3", "-G", "-5"],
    ["-M", "2", "-I", "-3", "-G", "-5", "--no-packed"],
    ["-M", "2", "-I", "-3", "-G", "-5", "--semi-global"],
    ["-M", "2", "-I", "-3", "-G", "-5", "--no-packed", "--semi-global"],
    ["-M", "2", "-I", "-3", "-G", "-5", "--carry"],
    ["-M", "5", "-I", "-1", "-G", "-2"],
], ids=["packed", "unpacked", "packed-semi", "unpacked-semi", "carry", "unpacked-only-scheme"])
def test_cli_matches_bgsa_align(tmp_path, flags):
    got, want = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    common = ["-q", MULTI[0], "-d", MULTI[1], "--bucket-size", "40000", "--quiet", *flags]
    assert cli.align_main([*common, "-f", got, "--device", "cpu"]) == 0
    assert jax_cli.align_main([*common, "-f", want, "--backend", "xla"]) == 0
    assert read(got) == read(want)
    assert read(got + ".info") == read(want + ".info")


@pytest.mark.parametrize("flags", [
    ["--packed"],
    ["--no-packed"],
    ["--carry"],
    ["-M", "0", "-I", "-2", "-G", "-2", "--no-packed"],
    ["-k", "8", "--packed"],
    ["-k", "8", "--carry"],
], ids=["packed-unit", "no-packed-unit", "carry-unit", "no-packed-unit-factor",
        "packed-banded", "carry-banded"])
def test_cli_flag_rules_mirror_bgsa_align(tmp_path, capsys, flags):
    common = ["-q", SAMPLE[0], "-d", SAMPLE[1], "--quiet", *flags]
    assert cli.align_main([*common, "-f", str(tmp_path / "port.bin"), "--device", "cpu"]) == 1
    port_err = capsys.readouterr().err
    assert jax_cli.align_main([*common, "-f", str(tmp_path / "jax.bin"), "--backend", "xla"]) == 1
    assert port_err == capsys.readouterr().err
    assert port_err.startswith(f"error: {'--carry' if '--carry' in flags else '--packed'}")
    assert not os.path.exists(tmp_path / "port.bin")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.SEMI_GLOBAL])
def test_api_matches_oracle(mode, packed):
    rng = np.random.default_rng(11)
    q = rng.integers(0, 5, size=(3, 33))
    s = rng.integers(0, 5, size=(7, 40))
    scoring = Scoring(4, -6, -10)  # (2,-3,-5) with factor 2
    got = align(q, s, scoring=scoring, mode=mode, config=PipelineConfig(bitpal_packed=packed),
                device="cpu")
    assert got.shape == (3, 7) and got.dtype == np.int16
    if mode is Mode.GLOBAL:
        want = np.stack([align_scores(qi, s, scoring) for qi in q])
    else:  # BitPAl's semi-global: full query, subject ends free
        want = np.stack([align_scores_query_in_subject(qi, s, scoring) for qi in q])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("carry", [None, True, False], ids=["carry-auto", "carry", "no-carry"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("scoring", [BITPAL, Scoring(5, -1, -2)], ids=["2-3-5", "5-1-2"])
def test_engine_route_and_layout_match_jax(scoring, packed, carry):
    scheme = normalize(scoring)
    config = PipelineConfig(bitpal_packed=packed, bitpal_carry=carry)
    engine = port.Engine(scheme, config, "cpu")
    want_packed = jax_pipeline.bitpal_packed_route(scheme, packed)
    assert port.bitpal_packed_route(scheme, packed) == want_packed
    assert engine.kernel == ("bitpal_packed" if want_packed else "bitpal")
    assert engine.word_bits == jax_pipeline.Engine(scheme, config).word_bits


def test_resume_completes_a_truncated_bitpal_run(tmp_path):
    full, cut = str(tmp_path / "full.bin"), str(tmp_path / "cut.bin")
    cfg = PipelineConfig(bucket_size=40000)
    port.run_alignment(*MULTI, full, scoring=BITPAL, config=cfg, device="cpu")
    port.run_alignment(*MULTI, cut, scoring=BITPAL, config=cfg, device="cpu")
    with open(cut, "r+b") as f:
        f.truncate(os.path.getsize(full) // 3 + 5)  # mid-bucket
    port.run_alignment(*MULTI, cut, scoring=BITPAL, config=cfg, device="cpu", resume=True)
    assert read(cut) == read(full) and read(cut + ".info") == read(full + ".info")
