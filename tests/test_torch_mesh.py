"""The port's device mesh and local sharding on repeated CPU devices.

The counterpart of tests/test_parallel.py and tests/test_local_shards.py:
where the JAX tests run on 8 virtual CPU devices, the port's mesh and
engines take an explicit device list that repeats the CPU. Sharded scores
must equal the one-device scores and the oracle exactly; sharded result
files must equal bgsa_tpu's sharded ones byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from bgsa_tpu import oracle
from bgsa_tpu import pipeline as jax_pipeline
from bgsa_tpu.banded_pipeline import run_banded as jax_run_banded
from bgsa_tpu.pipeline import PipelineConfig as JaxConfig
from bgsa_tpu_torch import align, cli, pack
from bgsa_tpu_torch.banded_pipeline import BandedEngine, run_banded
from bgsa_tpu_torch.io import result as result_io
from bgsa_tpu_torch.io import seqfile
from bgsa_tpu_torch.parallel import mesh as mesh_mod
from bgsa_tpu_torch.pipeline import DeviceScores, Engine, PipelineConfig, run_alignment
from bgsa_tpu_torch.schemes import Scoring, normalize

CPU8 = ["cpu"] * 8
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MULTI = (os.path.join(GOLDEN, "multibucket_query.txt"),
         os.path.join(GOLDEN, "multibucket_subject.txt"))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def eq31(s):
    return pack.eq_from_numpy(pack.pack_eq_host(s, 31))


def _rare_n_codes(rng, S, L, n_count=60):
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.integers(0, S, n_count), rng.integers(0, L, n_count)] = 4
    return codes


@pytest.mark.parametrize("merge", [False, True], ids=["shards", "merged"])
def test_sharded_matches_oracle(rng, merge):
    mesh = mesh_mod.make_mesh(CPU8, query_shards=2)  # (4, 2) mesh
    assert mesh.shape == (4, 2)
    Q, m, S, n = 4, 30, 512, 40
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n))
    got = mesh_mod.myers_global_sharded(eq31(s), torch.from_numpy(q), mesh, read_len=n,
                                        merge=merge)
    if merge:
        assert isinstance(got, torch.Tensor) and got.device == torch.device("cpu")
    else:
        assert isinstance(got, mesh_mod.ShardedScores) and len(got.blocks) == 4
    want = np.stack([-oracle.edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(np.asarray(got), want)


def test_shard_inputs_places_slices():
    mesh = mesh_mod.make_mesh(CPU8, query_shards=2)
    eq = torch.arange(5 * 2 * 8, dtype=torch.int32).reshape(5, 2, 8)
    q = torch.arange(6, dtype=torch.int32).reshape(6, 1)
    eq_parts, q_parts = mesh_mod.shard_inputs(eq, q, mesh)
    assert torch.equal(eq_parts[3][1], eq[:, :, 6:8])
    assert torch.equal(q_parts[2][1], q[3:6])
    with pytest.raises(ValueError, match="does not split"):
        mesh_mod.shard_inputs(eq[:, :, :7], q, mesh)


def test_make_mesh_rejects_indivisible_query_shards():
    with pytest.raises(ValueError, match="not divisible"):
        mesh_mod.make_mesh(CPU8, query_shards=3)


def test_make_mesh_needs_a_card_without_a_device_list(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_mesh()


@pytest.mark.parametrize("scoring,packed", [
    (Scoring(0, -1, -1), True), (Scoring(2, -3, -5), True), (Scoring(2, -3, -5), False),
], ids=["myers", "bitpal-packed", "bitpal"])
def test_engine_sharded_sidecar_matches_single(rng, scoring, packed):
    """An N-containing batch rides 2bitN split per shard and scores equal to
    the one-device engine."""
    S, L = 2048, 40
    codes = _rare_n_codes(rng, S, L)
    assert pack.select_transport(codes, n_shards=4)[0] == "2bitN"
    q = rng.integers(0, 4, size=(3, 30)).astype(np.int32)
    config = PipelineConfig(bitpal_packed=packed)
    single = Engine(normalize(scoring), config, "cpu")
    sharded = Engine(normalize(scoring), config, "cpu", devices=["cpu"] * 4)
    assert sharded.n_shards == 4
    got = sharded.scores(q, codes)
    assert len(got.shards) == 4
    np.testing.assert_array_equal(np.asarray(got), np.asarray(single.scores(q, codes)))


@pytest.mark.parametrize("s_len", [40, 27])  # s_len >= and < q_len geometries
def test_banded_engine_sharded_matches_single(rng, s_len):
    k, q_len = 4, 30
    q = rng.integers(0, 4, size=(3, q_len)).astype(np.int32)
    codes = rng.integers(0, 4, size=(512, s_len)).astype(np.uint8)
    single = BandedEngine(k, device="cpu")
    sharded = BandedEngine(k, device="cpu", devices=["cpu"] * 4)
    assert sharded.n_shards == 4
    np.testing.assert_array_equal(np.asarray(sharded.scores(q, codes)),
                                  np.asarray(single.scores(q, codes)))


def test_device_scores_over_shards():
    scores = DeviceScores([torch.arange(4, dtype=torch.int16).reshape(2, 2),
                           torch.arange(4, 10, dtype=torch.int16).reshape(2, 3)])
    assert np.asarray(scores[0, 0]) == 0 and np.asarray(scores[1, 3]) == 8
    assert np.asarray(scores).tolist() == [[0, 1, 4, 5, 6], [2, 3, 7, 8, 9]]
    with pytest.raises(IndexError):
        scores[0, 5]


def test_run_alignment_sharded_equals_bgsa_tpu_sharded(tmp_path):
    """Two CPU shards: result and .info bytes equal bgsa_tpu's local_shards=2
    run on its virtual CPU devices; the converted text equals the one-device
    run's (the lane-pad unit is v_num x shards, so raw bytes differ there)."""
    got, want, one = (str(tmp_path / n) for n in ("port.bin", "jax.bin", "one.bin"))
    run_alignment(*MULTI, got, config=PipelineConfig(bucket_size=40000), device="cpu",
                  devices=["cpu"] * 2)
    jax_pipeline.run_alignment(*MULTI, want,
                               config=JaxConfig(backend="xla", bucket_size=40000,
                                                local_shards=2))
    assert read(got) == read(want) and read(got + ".info") == read(want + ".info")
    run_alignment(*MULTI, one, config=PipelineConfig(bucket_size=40000), device="cpu")
    for res in (got, one):
        result_io.convert_result(res, res + ".txt")
    assert read(got + ".txt") == read(one + ".txt")


def test_run_banded_sharded_equals_bgsa_tpu_sharded(tmp_path, rng):
    q = rng.integers(0, 4, size=(2, 28))
    s = rng.integers(0, 4, size=(2100, 30))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    bucket = 1024 * 31
    got, want, one = (str(tmp_path / n) for n in ("port.bin", "jax.bin", "one.bin"))
    run_banded(qp, sp, got, 5, PipelineConfig(bucket_size=bucket), device="cpu",
               devices=["cpu"] * 2)
    jax_run_banded(qp, sp, want, 5, JaxConfig(backend="xla", bucket_size=bucket,
                                              local_shards=2))
    assert read(got) == read(want) and read(got + ".info") == read(want + ".info")
    run_banded(qp, sp, one, 5, PipelineConfig(bucket_size=bucket), device="cpu")
    for res in (got, one):
        result_io.convert_result(res, res + ".txt", write_dtype=np.int8)
    assert read(got + ".txt") == read(one + ".txt")


@pytest.mark.parametrize("k", [None, 3])
def test_align_sharded_pads_to_the_shard_count(rng, k):
    q = rng.integers(0, 4, size=(2, 12))
    s = rng.integers(0, 4, size=(7, 14))  # 7 subjects over 3 shards
    kw = dict(k=k, device="cpu")
    np.testing.assert_array_equal(align(q, s, devices=["cpu"] * 3, **kw), align(q, s, **kw))


@pytest.mark.parametrize("shards", ["2", "5"])
def test_cli_shards_beyond_local_devices_refused(tmp_path, capsys, shards):
    res = str(tmp_path / "r.bin")
    assert cli.align_main(["-q", MULTI[0], "-d", MULTI[1], "-f", res, "--device", "cpu",
                           "--shards", shards, "--quiet"]) == 1
    assert (f"--shards {shards} exceeds the 1 visible local device(s); use --shards 0 "
            "for all local devices") in capsys.readouterr().err
    assert not os.path.exists(res)


def test_cli_shards_zero_is_every_local_device(tmp_path):
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    common = ["-q", MULTI[0], "-d", MULTI[1], "--bucket-size", "40000", "--device", "cpu",
              "--quiet"]
    assert cli.align_main([*common, "-f", a]) == 0
    assert cli.align_main([*common, "-f", b, "--shards", "0"]) == 0
    assert read(a) == read(b) and read(a + ".info") == read(b + ".info")


def test_engine_devices_rejects_unsupported():
    with pytest.raises(ValueError, match="unsupported device"):
        Engine(normalize(Scoring()), PipelineConfig(), "cpu", devices=["meta"])
    with pytest.raises(ValueError, match="devices is empty"):
        Engine(normalize(Scoring()), PipelineConfig(), "cpu", devices=[])
