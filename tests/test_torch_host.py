"""The port's own copies of bgsa_tpu's jax-free host code, against the originals.

Every copied module (schemes, the host half of pack, native, io, stats,
multihost, banded_ref, oracle, benchutil, encode_sequences) gives the same
answers as bgsa_tpu's on the same seeded numpy inputs.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from bgsa_tpu import api as jax_api
from bgsa_tpu import banded_ref as jax_banded_ref
from bgsa_tpu import benchutil as jax_benchutil
from bgsa_tpu import native as jax_native
from bgsa_tpu import oracle as jax_oracle
from bgsa_tpu import pack as jax_pack
from bgsa_tpu import schemes as jax_schemes
from bgsa_tpu import stats as jax_stats
from bgsa_tpu.io import fastx as jax_fastx
from bgsa_tpu.io import result as jax_result
from bgsa_tpu.io import seqfile as jax_seqfile
from bgsa_tpu.parallel import multihost as jax_multihost
from bgsa_tpu_torch import api, banded_ref, benchutil, native, oracle, pack, schemes, stats
from bgsa_tpu_torch.io import fastx, result, seqfile
from bgsa_tpu_torch.parallel import multihost

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MULTI = (os.path.join(GOLDEN, "multibucket_query.txt"),
         os.path.join(GOLDEN, "multibucket_subject.txt"))


@pytest.fixture(params=["native", "numpy"])
def packers(request, monkeypatch):
    """Run each packer comparison with the native library and without it."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    return request.param


def codes(seed, S, L, n_rate=0.0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    c[rng.random((S, L)) < n_rate] = 4
    return c


def test_constants_and_mapping():
    assert (pack.CHAR_NUM, pack.PAD_CODE, pack.SIDECAR_QUANT) == (
        jax_pack.CHAR_NUM, jax_pack.PAD_CODE, jax_pack.SIDECAR_QUANT)
    np.testing.assert_array_equal(pack.MAPPING, jax_pack.MAPPING)
    buf = np.random.default_rng(0).integers(0, 256, size=(7, 33)).astype(np.uint8)
    np.testing.assert_array_equal(pack.encode_ascii(buf), jax_pack.encode_ascii(buf))


@pytest.mark.parametrize("L", [1, 31, 32, 33, 150])
@pytest.mark.parametrize("word_bits", [31, 32])
def test_pack_eq_host(packers, word_bits, L):
    c = codes(L, 50, L, n_rate=0.05)
    got = pack.pack_eq_host(c, word_bits)
    np.testing.assert_array_equal(got, jax_pack.pack_eq(c, word_bits))
    np.testing.assert_array_equal(pack.unpack_eq_host(got, L, word_bits),
                                  jax_pack.unpack_eq(got, L, word_bits))
    assert pack.word_count(L, word_bits) == jax_pack.word_count(L, word_bits)


@pytest.mark.parametrize("L", [1, 7, 150])
def test_transport_packers(packers, L):
    c = codes(L + 1, 40, L, n_rate=0.1)
    np.testing.assert_array_equal(pack.nibble_pack(c, threads=2), jax_pack.nibble_pack(c, 2))
    clean = np.where(c > 3, 0, c).astype(np.uint8)
    np.testing.assert_array_equal(pack.two_bit_pack(clean), jax_pack.two_bit_pack(clean))
    for name in ("2bit", "2bitN", "nib"):
        assert pack.transport_width(name, L) == jax_pack.transport_width(name, L)
        assert pack.transport_specs(name, 40, L, 1024) == jax_pack.transport_specs(
            name, 40, L, 1024)


@pytest.mark.parametrize("n_rate", [0.0, 2e-4, 0.05], ids=["2bit", "2bitN", "nib"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sidecar_and_select_transport(packers, n_shards, n_rate):
    c = codes(n_shards, 4096, 60, n_rate=n_rate)
    got = pack.select_transport(c, n_shards=n_shards)
    want = jax_pack.select_transport(c, n_shards=n_shards)
    assert got[0] == want[0] == {0.0: "2bit", 2e-4: "2bitN", 0.05: "nib"}[n_rate]
    for a, b in zip(got[1] if isinstance(got[1], tuple) else (got[1],),
                    want[1] if isinstance(want[1], tuple) else (want[1],)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pack.sidecar_pack(c, n_shards),
                                  jax_pack.sidecar_pack(c, n_shards))


@pytest.mark.parametrize("k,m,L", [(8, 150, 150), (4, 30, 27), (40, 55, 20)])
def test_pack_banded_host(packers, k, m, L):
    c = codes(k, 30, L, n_rate=0.02)
    for got, want in zip(pack.pack_banded_host(c, k, m), jax_pack.pack_banded(c, k, m)):
        np.testing.assert_array_equal(got, want)


SCHEMES = [(0, -1, -1), (0, 2, 2), (0, -2, -2), (2, -3, -5), (4, -6, -10), (5, -1, -2),
           (1, -1, -1), (0, -2, -3), (5, -4, -11), (1, -4, -2)]


@pytest.mark.parametrize("mode", ["global", "semi-global"])
@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: "%d,%d,%d" % s)
def test_normalize(scheme, mode):
    got = schemes.normalize(schemes.Scoring(*scheme), schemes.Mode(mode))
    want = jax_schemes.normalize(jax_schemes.Scoring(*scheme), jax_schemes.Mode(mode))
    assert (got.algorithm.value, got.mode.value, got.match, got.mismatch, got.gap,
            got.factor) == (want.algorithm.value, want.mode.value, want.match, want.mismatch,
                            want.gap, want.factor)
    assert schemes.Scoring(*scheme).is_unit == jax_schemes.Scoring(*scheme).is_unit


@pytest.mark.parametrize("scheme,algorithm", [
    ((-1, -2, -2), None), ((2, -3, 0), None), ((2, 3, -1), None), ((0, -2, -2), "banded"),
    ((2, -3, -5), "myers")])
def test_normalize_refuses_as_bgsa_tpu(scheme, algorithm):
    def run(mod):
        alg = None if algorithm is None else mod.Algorithm(algorithm)
        with pytest.raises(ValueError) as e:
            mod.normalize(mod.Scoring(*scheme), algorithm=alg)
        return str(e.value)

    assert run(schemes) == run(jax_schemes)


@pytest.mark.parametrize("v_num", [128, 256])
@pytest.mark.parametrize("bucket_size", [40000, 10 ** 9])
def test_database_reader_buckets(bucket_size, v_num):
    got = seqfile.DatabaseReader(MULTI[1], bucket_size, v_num)
    want = jax_seqfile.DatabaseReader(MULTI[1], bucket_size, v_num)
    assert (got.length, got.total_count, got.bucket_count, got.seqs_per_bucket) == (
        want.length, want.total_count, want.bucket_count, want.seqs_per_bucket)
    assert got.bucket_counts() == want.bucket_counts()
    for a, b in zip(got, want):
        assert (a.count, a.extra_count) == (b.count, b.extra_count)
        np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(seqfile.read_queries(MULTI[0]),
                                  jax_seqfile.read_queries(MULTI[0]))
    assert (seqfile.DEFAULT_BUCKET_SIZE, seqfile.REF_BUCKET_COUNT) == (
        jax_seqfile.DEFAULT_BUCKET_SIZE, jax_seqfile.REF_BUCKET_COUNT)


def test_run_stats_json_and_report():
    kw = dict(query_len=150, query_count=20, subject_len=150, subject_count=1000,
              cal_time=0.5, total_time=2.0, read_time=0.1, bucket_cal_times=[0.25, 0.25])
    got, want = stats.RunStats(**kw), jax_stats.RunStats(**kw)
    got_json, want_json = json.loads(got.to_json()), json.loads(want.to_json())
    assert {key: got_json[key] for key in want_json} == want_json
    # the port's own fields: the reader wait, the reader's seconds and its
    # wait on a full queue, native and packed buckets, the rows scored, the
    # BitPAl and Myers launch counters
    assert set(got_json) - set(want_json) == {
        "read_wait_time", "reader_read_time", "reader_encode_time", "reader_put_wait_time",
        "reader_native_buckets",
        "reader_packed_buckets", "scored_rows", "bitpal_word_columns", "bitpal_tiled_word_columns",
        "bitpal_scratch_peak_bytes", "myers_word_columns", "myers_strip_word_columns",
        "myers_carry_peak_bytes", "myers_wave_word_columns"}
    assert got.report() == want.report() and got.cells == want.cells


def test_result_writer_convert_and_resume(tmp_path):
    rng = np.random.default_rng(5)
    blocks = [rng.integers(-300, 300, size=(3, 256)).astype(np.int16) for _ in range(2)]
    paths = []
    for mod, name in ((result, "port.bin"), (jax_result, "jax.bin")):
        path = str(tmp_path / name)
        w = mod.ResultWriter(path, ref_count=3, block_num=2)
        for b in blocks:
            w.start_bucket([256], 10)
            w.write_scores(b)
        w.close()
        paths.append(path)
    for suffix in ("", ".info", ".run.json"):
        assert open(paths[0] + suffix, "rb").read() == open(paths[1] + suffix, "rb").read()
    result.convert_result(paths[0], paths[0] + ".txt")
    jax_result.convert_result(paths[1], paths[1] + ".txt")
    assert open(paths[0] + ".txt").read() == open(paths[1] + ".txt").read()
    assert (dataclasses.asdict(result.read_info(paths[0] + ".info"))
            == dataclasses.asdict(jax_result.read_info(paths[1] + ".info")))
    assert result.infer_write_dtype(paths[0]) == jax_result.infer_write_dtype(paths[1])
    for path in paths:
        with open(path, "r+b") as f:
            f.truncate(3 * 256 * 2 + 5)
    assert result.resume_point(paths[0], 3) == jax_result.resume_point(paths[1], 3) == 1


def test_fastx(tmp_path):
    fa, fq = str(tmp_path / "s.fa"), str(tmp_path / "s.fq")
    with open(fa, "w") as f:
        f.write(">a\r\nACGT\r\nAC\n>b\nTTTTTT\n")
    with open(fq, "w") as f:
        f.write("@a\nACGTAC\n+\n@@@@@@\n@b\nTTTTTT\n+\n!!!!!!\n")
    for conv, jconv, src in ((fastx.convert_fasta, jax_fastx.convert_fasta, fa),
                             (fastx.convert_fastq, jax_fastx.convert_fastq, fq)):
        conv(src, src + ".port")
        jconv(src, src + ".jax")
        assert open(src + ".port", "rb").read() == open(src + ".jax", "rb").read()


@pytest.mark.parametrize("ratios", [None, [1.0, 3.0, 2.0]])
def test_multihost_splits_and_balancer(ratios):
    for total in (0, 1000, 4096):
        assert multihost.split_counts(total, 3, 128, ratios) == jax_multihost.split_counts(
            total, 3, 128, ratios)
        for h in range(3):
            assert multihost.host_slice(total, 3, h, 128, ratios) == jax_multihost.host_slice(
                total, 3, h, 128, ratios)
    a = multihost.DynamicBalancer(3, ratios)
    b = jax_multihost.DynamicBalancer(3, ratios)
    for times in ([1.0, 2.0, 0.5], [1.2, 1.1, 0.9], [0.7, 1.4, 1.0], [1.0, 1.0, 1.0]):
        assert a.update(times) == b.update(times)
    assert multihost.normalized_ratios(ratios, 3) == jax_multihost.normalized_ratios(ratios, 3)


def test_shard_meta_and_merge(tmp_path):
    rng = np.random.default_rng(2)
    paths, metas, jmetas = [], [], []
    for h, count in enumerate((128, 72)):
        path = str(tmp_path / f"shard{h}.bin")
        rng.integers(-9, 9, size=(2, count)).astype(np.int16).tofile(path)
        kw = dict(host_id=h, n_hosts=2, ref_count=2, block_counts=[count],
                  extra_counts=[0 if h == 0 else 56])
        metas.append(multihost.ShardMeta(**kw))
        jmetas.append(jax_multihost.ShardMeta(**kw))
        paths.append(path)
    assert dataclasses.asdict(metas[1]) == dataclasses.asdict(jmetas[1])
    multihost.merge_shards(str(tmp_path / "port.bin"), paths, metas)
    jax_multihost.merge_shards(str(tmp_path / "jax.bin"), paths, jmetas)
    for suffix in ("", ".info"):
        assert (open(str(tmp_path / "port.bin") + suffix, "rb").read()
                == open(str(tmp_path / "jax.bin") + suffix, "rb").read())


@pytest.mark.parametrize("k", [0, 2, 5])
def test_banded_ref(k):
    rng = np.random.default_rng(k)
    q = rng.integers(0, 4, size=40)
    s = rng.integers(0, 4, size=(20, 44))
    s[0] = np.concatenate([q, q[:4]])
    assert banded_ref.banded_scores(q, s, k) == jax_banded_ref.banded_scores(q, s, k)
    assert banded_ref.checkpoint_columns(150, 150, 8) == jax_banded_ref.checkpoint_columns(
        150, 150, 8)
    assert banded_ref.MAX_ERROR == jax_banded_ref.MAX_ERROR


@pytest.mark.parametrize("scheme", [(0, -1, -1), (2, -3, -5), (5, -1, -2)])
@pytest.mark.parametrize("mode", ["global", "semi-global"])
def test_oracle(scheme, mode):
    rng = np.random.default_rng(sum(scheme) + len(mode))
    q = rng.integers(0, 5, size=25)
    s = rng.integers(0, 5, size=(9, 31))
    got = oracle.align_scores(q, s, schemes.Scoring(*scheme), schemes.Mode(mode))
    want = jax_oracle.align_scores(q, s, jax_schemes.Scoring(*scheme), jax_schemes.Mode(mode))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        oracle.align_scores_query_in_subject(q, s, schemes.Scoring(*scheme)),
        jax_oracle.align_scores_query_in_subject(q, s, jax_schemes.Scoring(*scheme)))
    np.testing.assert_array_equal(oracle.edit_distances(q, s, schemes.Mode(mode)),
                                  jax_oracle.edit_distances(q, s, jax_schemes.Mode(mode)))


def test_filter_mix_dataset():
    got = benchutil.filter_mix_dataset(np.random.default_rng(1), 5, 300, 60)
    want = jax_benchutil.filter_mix_dataset(np.random.default_rng(1), 5, 300, 60)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seqs", ["ACGTN", ["ACGT", "TTNA", "xyzw"], b"GGCC",
                                  np.array([[0, 1, 4], [3, 2, 1]])], ids=["str", "list",
                                                                          "bytes", "codes"])
def test_encode_sequences(seqs):
    np.testing.assert_array_equal(api.encode_sequences(seqs), jax_api.encode_sequences(seqs))


@pytest.mark.parametrize("seqs", [[], ["ACG", "AC"], np.array([[0, 5]])],
                         ids=["empty", "ragged", "bad-code"])
def test_encode_sequences_refuses_as_bgsa_tpu(seqs):
    with pytest.raises(ValueError) as got:
        api.encode_sequences(seqs, name="x")
    with pytest.raises(ValueError) as want:
        jax_api.encode_sequences(seqs, name="x")
    assert str(got.value) == str(want.value)


def test_native_library_builds_into_the_checkout():
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and os.sep + "build" + os.sep in path
    if native.get_lib() is not None:  # a toolchain was there: the build is in build/
        assert os.path.exists(path)


# -- the package surface -------------------------------------------------------

def test_package_exports_every_name_of_bgsa_tpu():
    import bgsa_tpu
    import bgsa_tpu_torch

    assert set(bgsa_tpu.__all__) <= set(bgsa_tpu_torch.__all__)
    assert all(hasattr(bgsa_tpu_torch, name) for name in bgsa_tpu_torch.__all__)
    # the port's own classes and functions, not bgsa_tpu's
    assert all(getattr(bgsa_tpu_torch, name) is not getattr(bgsa_tpu, name)
               for name in bgsa_tpu.__all__)
    for enum_name in ("Algorithm", "Mode"):
        assert ([m.value for m in getattr(bgsa_tpu_torch, enum_name)]
                == [m.value for m in getattr(bgsa_tpu, enum_name)])
    assert ([f.name for f in dataclasses.fields(bgsa_tpu_torch.NormalizedScheme)]
            == [f.name for f in dataclasses.fields(bgsa_tpu.NormalizedScheme)])


@pytest.mark.parametrize("scheme,mode,algorithm", [
    ((0, -1, -1), "global", None), ((2, -3, -5), "semi-global", None),
    ((0, -1, -1), "global", "banded"), ((5, -1, -2), "global", "bitpal")])
def test_package_normalize_behaves_as_bgsa_tpu(scheme, mode, algorithm):
    import bgsa_tpu
    import bgsa_tpu_torch

    def run(pkg):
        alg = None if algorithm is None else pkg.Algorithm(algorithm)
        n = pkg.normalize(pkg.Scoring(*scheme), pkg.Mode(mode), algorithm=alg)
        return (n.algorithm.value, n.mode.value, n.match, n.mismatch, n.gap, n.factor)

    assert run(bgsa_tpu_torch) == run(bgsa_tpu)


@pytest.mark.parametrize("seqs", [["ACGT", "NNAC", "tgca"], "GATTACA",
                                  np.array([[4, 3], [0, 1]])], ids=["list", "str", "codes"])
def test_package_encode_sequences_behaves_as_bgsa_tpu(seqs):
    import bgsa_tpu
    import bgsa_tpu_torch

    np.testing.assert_array_equal(bgsa_tpu_torch.encode_sequences(seqs),
                                  bgsa_tpu.encode_sequences(seqs))


def test_package_version_is_the_distribution_version():
    import tomllib

    import bgsa_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        assert bgsa_tpu_torch.__version__ == tomllib.load(f)["project"]["version"]
