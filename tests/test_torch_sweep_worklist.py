"""The branches the coverage sweep found unhit, each held against bgsa_tpu.

``python -m bgsa_tpu_torch.scripts.coverage_sweep -m "not slow"
tests/test_torch_*.py`` listed these host-side branches of the port as run
by no test. Where ``bgsa_tpu`` has the same branch, the test runs both on
the same inputs and holds the port to the same result bytes, or the same
error message and exit code: the CLI's refusals (a malformed ``--host``, ``-t``
with ``--host``/``--shards``/``--resume``/``--sync-dir``, ``-n 0``), FASTQ
inputs and their refusals, ``--sync-timeout``, ``convert``'s errors; the
``.info`` and result-size validation, ``resume_point``'s fresh-start cases
and ``convert_result``'s Python walker (no native library); the database
and query readers' refusals; the shard sidecar, ratio file and ``-D``
time-file waits; the reader failing mid-run and an engine with only
``scores``; the packers' and ``banded_ref``'s refusals. Port-only branches
(``--device``, the native library's build failure) are held to what they
promise.
"""

import json
import os
import struct
import threading
import time

import numpy as np
import pytest

from bgsa_tpu import banded_ref as jax_banded_ref
from bgsa_tpu import cli as jax_cli
from bgsa_tpu import pack as jax_pack
from bgsa_tpu import pipeline as jax_pipeline
from bgsa_tpu.io import result as jax_result
from bgsa_tpu.io import seqfile as jax_seqfile
from bgsa_tpu.parallel import multihost as jax_multihost
from bgsa_tpu_torch import banded_ref, cli, native, pack, pipeline
from bgsa_tpu_torch.io import result, seqfile
from bgsa_tpu_torch.parallel import multihost
from bgsa_tpu_torch.schemes import Algorithm, Mode, NormalizedScheme, Scoring, normalize

LUT = np.frombuffer(b"ACGTN", np.uint8)


def write_lines(path, codes):
    with open(path, "wb") as f:
        for row in np.asarray(codes):
            f.write(LUT[row].tobytes() + b"\n")
    return str(path)


def inputs(tmp_path, rng, Q=3, m=20, S=300, n=24, n_rate=0.0):
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    s[rng.random(s.shape) < n_rate] = 4
    return write_lines(tmp_path / "q.txt", q), write_lines(tmp_path / "s.txt", s)


def same_bytes(a, b) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def both_raise(port_fn, jax_fn, error=ValueError):
    """Both calls raise ``error`` with the same message; returns it."""
    with pytest.raises(error) as got:
        port_fn()
    with pytest.raises(error) as want:
        jax_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


# -- the CLI ---------------------------------------------------------------------


def align_both(tmp_path, capsys, flags, q=None, d=None):
    """``bgsa-torch-align`` and ``bgsa-align`` with the same flags (the
    port's ``--device cpu`` appended unless -t is given) -> (port rc,
    stderr, bgsa-align rc, stderr)."""
    if q is None:
        q, d = inputs(tmp_path, np.random.default_rng(0))
    device = [] if "-t" in flags else ["--device", "cpu"]
    rc = cli.align_main(["-q", q, "-d", d, "-f", str(tmp_path / "port.bin"), "--quiet", *flags,
                         *device])
    err = capsys.readouterr().err
    jax_rc = jax_cli.main(["align", "-q", q, "-d", d, "-f", str(tmp_path / "jax.bin"),
                           "--quiet", *flags])
    return rc, err, jax_rc, capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--host", "x"], ["--host", "1:2:3"], ["--host", "2:2"], ["--host=-1:2"],
    ["-t", "cpu", "--host", "0:2"], ["-t", "cpu", "--shards", "2"],
    ["-t", "cpu", "--resume"], ["-t", "cpu", "--sync-dir", "sync"], ["-t", "cpu", "-n", "0"],
], ids=["host-x", "host-three", "host-id-past-n", "host-negative", "t-host", "t-shards",
        "t-resume", "t-sync-dir", "n-zero"])
def test_refusals_match_bgsa_align(tmp_path, capsys, flags):
    rc, err, jax_rc, jax_err = align_both(tmp_path, capsys, flags)
    assert rc == jax_rc == 1
    assert err == jax_err and err.startswith("error: ")
    assert not os.path.exists(tmp_path / "port.bin")


@pytest.mark.parametrize("body", ["1 0\n", "1\n", None], ids=["zero", "too-few", "missing"])
def test_a_bad_ratio_file_exits_1_where_bgsa_align_raises(tmp_path, capsys, body):
    # bgsa-align lets read_ratio_file's error escape as a traceback
    # (bgsa_tpu/cli.py:317); the port prints it and exits 1, as it does for
    # every other refusal
    ratios = tmp_path / "ratios.txt"
    if body is not None:
        ratios.write_text(body)
    q, d = inputs(tmp_path, np.random.default_rng(0))
    flags = ["--host", "0:2", "-R", str(ratios)]
    rc = cli.align_main(["-q", q, "-d", d, "-f", str(tmp_path / "p.bin"), "--quiet", *flags,
                         "--device", "cpu"])
    err = capsys.readouterr().err
    with pytest.raises((ValueError, OSError)) as jax:
        jax_cli.main(["align", "-q", q, "-d", d, "-f", str(tmp_path / "j.bin"), "--quiet", *flags])
    assert rc == 1 and err == f"error: {jax.value}\n"
    assert not os.path.exists(tmp_path / "p.bin")


def error_line(err: str, prog: str, jax_prog: str) -> str:
    return err.strip().splitlines()[-1].replace(prog, jax_prog)


def test_fastq_inputs_score_as_bgsa_align(tmp_path, capsys):
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, size=(3, 20))
    with open(tmp_path / "q.fq", "wb") as f:
        for i, row in enumerate(q):
            f.write(b"@r%d\n" % i + LUT[row].tobytes() + b"\n+\n" + b"I" * 20 + b"\n")
    _, d = inputs(tmp_path, rng)
    rc, err, jax_rc, _ = align_both(tmp_path, capsys, [], str(tmp_path / "q.fq"), d)
    assert rc == jax_rc == 0, err
    assert same_bytes(tmp_path / "port.bin", tmp_path / "jax.bin")


@pytest.mark.parametrize("kind", ["not-fastq", "missing"])
def test_input_refusals_match_bgsa_align(tmp_path, capsys, kind):
    q, d = inputs(tmp_path, np.random.default_rng(2))
    if kind == "not-fastq":
        q = str(tmp_path / "bad.fq")
        with open(q, "wb") as f:
            f.write(b"@r0\nACGT\nACGT\n")
    else:
        d = str(tmp_path / "nowhere.txt")
    with pytest.raises(SystemExit) as port:
        cli.align_main(["-q", q, "-d", d, "-f", str(tmp_path / "p.bin"), "--device", "cpu"])
    err = capsys.readouterr().err
    with pytest.raises(SystemExit) as jax:
        jax_cli.main(["align", "-q", q, "-d", d, "-f", str(tmp_path / "j.bin")])
    assert port.value.code == jax.value.code == 2
    assert error_line(err, "bgsa-torch-align", "bgsa-align") == error_line(
        capsys.readouterr().err, "bgsa-torch-align", "bgsa-align")


def test_sync_timeout_runs_a_dynamic_role_as_bgsa_align(tmp_path, capsys):
    flags = ["--host", "0:1", "-D", "--sync-timeout", "30"]
    q, d = inputs(tmp_path, np.random.default_rng(3))
    rc = cli.align_main(["-q", q, "-d", d, "-f", str(tmp_path / "port.bin"), "--quiet", *flags,
                         "--sync-dir", str(tmp_path / "psync"), "--device", "cpu"])
    jax_rc = jax_cli.main(["align", "-q", q, "-d", d, "-f", str(tmp_path / "jax.bin"),
                           "--quiet", *flags, "--sync-dir", str(tmp_path / "jsync")])
    assert rc == jax_rc == 0, capsys.readouterr().err
    assert same_bytes(tmp_path / "port.bin", tmp_path / "jax.bin")


def test_host_auto_from_the_environment_as_bgsa_align(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("BGSA_HOST_ID", "1")
    monkeypatch.setenv("BGSA_NUM_HOSTS", "2")
    rc, err, jax_rc, _ = align_both(tmp_path, capsys, ["--host", "auto"])
    assert rc == jax_rc == 0, err
    assert same_bytes(tmp_path / "port.bin", tmp_path / "jax.bin")
    port = multihost.ShardMeta.load(str(tmp_path / "port.bin") + ".meta.json")
    assert (port.host_id, port.n_hosts) == (1, 2)


def test_an_unknown_device_is_a_usage_error(tmp_path, capsys):
    q, d = inputs(tmp_path, np.random.default_rng(4))
    with pytest.raises(SystemExit) as e:
        cli.align_main(["-q", q, "-d", d, "-f", str(tmp_path / "p.bin"), "--device", "gpu9"])
    assert e.value.code == 2 and "--device gpu9" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["no-input", "truncated-info", "short-result"])
def test_convert_errors_match_bgsa_convert(tmp_path, capsys, kind):
    res = tmp_path / "r.bin"
    args = ["-o", str(tmp_path / "o.txt")]
    if kind != "no-input":
        res.write_bytes(b"\x00" * 8)
        info = (b"\x01\x00\x00\x00" if kind == "truncated-info"
                else struct.pack("<iiq", 1, 1, 3) + struct.pack("<qi", 5, 0))
        (tmp_path / "r.bin.info").write_bytes(info)
        args = ["-r", str(res), *args, "--banded"]
    with pytest.raises(SystemExit) as port:
        cli.main(["convert", *args])
    err = capsys.readouterr().err
    with pytest.raises(SystemExit) as jax:
        jax_cli.main(["convert", *args])
    assert port.value.code == jax.value.code == 2
    assert error_line(err, "bgsa-torch-convert", "bgsa-convert") == error_line(
        capsys.readouterr().err, "bgsa-torch-convert", "bgsa-convert")


# -- result files ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["implausible", "truncated", "infer"])
def test_info_validation_matches_bgsa_tpu(tmp_path, kind):
    path = str(tmp_path / "r.bin")
    with open(path, "wb") as f:
        f.write(b"\x00" * 10)
    header = {"implausible": struct.pack("<iiq", -1, 1, 3),
              "truncated": struct.pack("<iiq", 2, 1, 3) + b"\x00" * 5,
              "infer": struct.pack("<iiq", 1, 1, 3) + struct.pack("<qi", 2, 0)}[kind]
    with open(path + ".info", "wb") as f:
        f.write(header)
    if kind == "infer":
        msg = both_raise(lambda: result.infer_write_dtype(path),
                         lambda: jax_result.infer_write_dtype(path))
        assert "does not match 6 scores" in msg
    else:
        both_raise(lambda: result.read_info(path + ".info"),
                   lambda: jax_result.read_info(path + ".info"))


@pytest.fixture
def two_role_result(tmp_path):
    """A merged two-role result (device_num 2), several blocks and query
    buckets, pad rows in the last block, from the port."""
    rng = np.random.default_rng(5)
    q, d = inputs(tmp_path, rng, Q=5, S=700)
    cfg = pipeline.PipelineConfig(bucket_size=25 * 256, ref_bucket_count=2)
    shards, metas = [], []
    for h in range(2):
        path = str(tmp_path / f"shard{h}.bin")
        _, meta = pipeline.run_alignment(q, d, path, config=cfg, shard=(h, 2), device="cpu")
        shards.append(path)
        metas.append(meta)
    merged = str(tmp_path / "merged.bin")
    multihost.merge_shards(merged, shards, metas)
    return merged


def test_python_convert_walker_without_queries_as_bgsa_convert(tmp_path, monkeypatch):
    # no run writes a result of 0 queries (the reader refuses an empty query
    # file); without the native library both walkers refuse one, the same way
    from bgsa_tpu import native as jax_native

    res = str(tmp_path / "r.bin")
    open(res, "wb").close()
    with open(res + ".info", "wb") as f:
        f.write(struct.pack("<iiq", 1, 1, 0) + struct.pack("<qi", 128, 0))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    both_raise(lambda: result.convert_result(res, str(tmp_path / "port.txt")),
               lambda: jax_result.convert_result(res, str(tmp_path / "jax.txt")))


def test_python_convert_walker_equals_bgsa_convert(tmp_path, two_role_result, monkeypatch):
    info = result.read_info(two_role_result + ".info")
    assert info.device_num == 2 and info.block_num >= 2 and info.extra_counts[-1] > 0
    monkeypatch.setattr(native, "get_lib", lambda: None)
    port = str(tmp_path / "port.txt")
    result.convert_result(two_role_result, port, ref_bucket_count=2)
    jax = str(tmp_path / "jax.txt")
    jax_result.convert_result(two_role_result, jax, ref_bucket_count=2)
    assert same_bytes(port, jax)
    native_port = str(tmp_path / "native.txt")
    monkeypatch.undo()
    result.convert_result(two_role_result, native_port, ref_bucket_count=2)
    assert same_bytes(port, native_port)


def resume_case(tmp_path, src, kind):
    """A copy of a finished single-host result, altered per ``kind`` ->
    (path, resume_point's ref_count, expected_buckets, dtype)."""
    path = str(tmp_path / f"{kind}.bin")
    for suffix in ("", ".info"):
        with open(src + suffix, "rb") as f, open(path + suffix, "wb") as g:
            g.write(f.read())
    info = result.read_info(path + ".info")
    buckets = [(sum(c), e) for c, e in zip(info.device_read_counts, info.extra_counts)]
    ref_count, dtype = info.ref_count, np.int16
    if kind == "bad-run-json":
        with open(path + ".run.json", "w") as f:
            f.write("{not json")
    elif kind == "other-dtype":
        with open(path + ".run.json", "w") as f:
            json.dump({"write_dtype": "int8"}, f)
    elif kind == "bad-info":
        with open(path + ".info", "wb") as f:
            f.write(b"\x01")
    elif kind == "ref-count":
        ref_count += 1
    elif kind == "block-num":
        buckets = buckets[:-1]
    elif kind == "bucket-counts":
        buckets[0] = (buckets[0][0] + 128, buckets[0][1])
    elif kind == "oversized":
        with open(path, "ab") as f:
            f.write(b"\x00" * 64)
    elif kind == "no-info":
        os.unlink(path + ".info")
    elif kind == "partial-manifest":  # no geometry given, a complete-record prefix
        buckets = None
        with open(path + ".info", "r+b") as f:
            f.truncate(16 + (8 * info.device_num + 4))
    return path, ref_count, buckets, dtype


@pytest.mark.parametrize("kind", ["no-info", "bad-run-json", "other-dtype", "bad-info", "ref-count",
                                  "block-num", "bucket-counts", "oversized",
                                  "partial-manifest"])
def test_resume_point_matches_bgsa_tpu(tmp_path, kind):
    rng = np.random.default_rng(6)
    q, d = inputs(tmp_path, rng, S=700)
    src = str(tmp_path / "src.bin")
    pipeline.run_alignment(q, d, src, config=pipeline.PipelineConfig(bucket_size=25 * 256),
                           device="cpu")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = resume_case(tmp_path / "port", src, kind)
    jax = resume_case(tmp_path / "jax", src, kind)
    got = result.resume_point(port[0], port[1], 1, write_dtype=port[3],
                              expected_buckets=port[2])
    want = jax_result.resume_point(jax[0], jax[1], 1, write_dtype=jax[3],
                                   expected_buckets=jax[2])
    assert got == want
    if kind == "bad-run-json":
        assert got == 3  # an unreadable sidecar records no dtype: every bucket done
    elif kind == "partial-manifest":
        assert got == 1
    else:
        assert got == 0
    for suffix in ("", ".info") if kind != "no-info" else ("",):
        assert same_bytes(port[0] + suffix, jax[0] + suffix)


# -- the readers ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["crlf", "empty", "blank-first", "ragged-size",
                                  "ragged-aligned", "bucket-too-small", "queries-ragged",
                                  "queries-ragged-aligned", "queries-empty"])
def test_reader_refusals_match_bgsa_tpu(tmp_path, kind):
    path = str(tmp_path / "f.txt")
    data = {"crlf": b"ACGT\r\nACGT\r\n", "empty": b"", "blank-first": b"\nACGT\n",
            "ragged-size": b"ACGT\nAC\n", "ragged-aligned": b"ACGT\nACGTA\nACG\n",
            "bucket-too-small": b"ACGT\n" * 10, "queries-ragged": b"ACGT\nACG\n",
            "queries-ragged-aligned": b"ACGT\nACGTA\nACG\n", "queries-empty": b"\n"}[kind]
    with open(path, "wb") as f:
        f.write(data)
    if kind.startswith("queries"):
        msg = both_raise(lambda: seqfile.read_queries(path),
                         lambda: jax_seqfile.read_queries(path))
        assert kind != "queries-ragged-aligned" or "ragged line near sequence 1" in msg
    elif kind == "ragged-aligned":  # the size lines up: the newline column catches it
        msg = both_raise(lambda: list(seqfile.DatabaseReader(path)),
                         lambda: list(jax_seqfile.DatabaseReader(path)))
        assert "ragged line near sequence 1" in msg
    else:
        bucket = 8 if kind == "bucket-too-small" else seqfile.DEFAULT_BUCKET_SIZE
        msg = both_raise(lambda: seqfile.DatabaseReader(path, bucket_size=bucket),
                         lambda: jax_seqfile.DatabaseReader(path, bucket_size=bucket))
    assert msg


@pytest.mark.parametrize("data", [b"ACGT\nTTGA\nCCCN", b"ACGTN"], ids=["last-line", "one-line"])
def test_a_missing_final_newline_reads_as_bgsa_tpu(tmp_path, data):
    path = str(tmp_path / "s.txt")
    with open(path, "wb") as f:
        f.write(data)
    got = [(b.codes.tolist(), b.count, b.extra_count) for b in seqfile.DatabaseReader(path)]
    want = [(b.codes.tolist(), b.count, b.extra_count)
            for b in jax_seqfile.DatabaseReader(path)]
    assert got == want and got[0][1] == 128


# -- multi-host files ----------------------------------------------------------------


@pytest.mark.parametrize("body", ['{"host_id": 0}', "[1, 2]", "{oops"])
def test_malformed_shard_sidecar_matches_bgsa_tpu(tmp_path, body):
    path = str(tmp_path / "s.bin.shard.json")
    with open(path, "w") as f:
        f.write(body)
    with pytest.raises(ValueError) as got:
        multihost.ShardMeta.load(path)
    with pytest.raises(ValueError) as want:
        jax_multihost.ShardMeta.load(path)
    # the message names the class, whose module differs
    assert str(got.value).replace("bgsa_tpu_torch.", "bgsa_tpu.") == str(want.value)
    assert "malformed shard sidecar" in str(got.value)


@pytest.mark.parametrize("body", ["1", "1 0", "1 -2"])
def test_bad_ratio_file_matches_bgsa_tpu(tmp_path, body):
    path = str(tmp_path / "r.txt")
    with open(path, "w") as f:
        f.write(body)
    both_raise(lambda: multihost.read_ratio_file(path, 2),
               lambda: jax_multihost.read_ratio_file(path, 2))


def test_stale_time_files_are_cleared_as_bgsa_tpu(tmp_path):
    for mod, sub in ((multihost, "port"), (jax_multihost, "jax")):
        sync = str(tmp_path / sub)
        os.makedirs(sync)
        for bucket in range(3):
            mod.write_bucket_time(sync, bucket, 0, 1.0, token="t")
            mod.write_bucket_time(sync, bucket, 1, 2.0, token="t")
        mod.clear_bucket_times(sync, 0, token="t")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 3


@pytest.mark.parametrize("hello", [False, True])
def test_a_silent_peer_times_out_as_bgsa_tpu(tmp_path, hello):
    sync = str(tmp_path)
    multihost.write_bucket_time(sync, 0, 0, 1.5, token="t")  # no hello yet: still written
    assert multihost.read_bucket_times(sync, 0, 1, token="t") == [1.5]
    multihost.write_bucket_time(sync, 0, 0, 9.0, token="t")  # first write wins
    assert jax_multihost.read_bucket_times(sync, 0, 1, token="t") == [1.5]
    if hello:
        multihost.write_hello(sync, 1, "t")
    kw = dict(timeout=0.1, poll=0.01, token="t", grace_factor=2.0)
    msg = both_raise(lambda: multihost.read_bucket_times(sync, 0, 2, **kw),
                     lambda: jax_multihost.read_bucket_times(sync, 0, 2, **kw),
                     TimeoutError)
    assert ("started but stalled" if hello else "never announced") in msg


# -- the pipeline -------------------------------------------------------------------


class Interrupted(BaseException):
    """Stands for KeyboardInterrupt: not an Exception."""


@pytest.mark.parametrize("error", [OSError("disk pulled mid-run"), Interrupted("stop")],
                         ids=["oserror", "interrupt"])
def test_reader_failure_mid_run_raises_as_bgsa_tpu(tmp_path, monkeypatch, error):
    q, d = inputs(tmp_path, np.random.default_rng(7), S=600)

    def failing(real_reader):
        class FailingReader(real_reader):
            def __iter__(self):
                it = super().__iter__()
                yield next(it)  # the first bucket reads fine
                raise error

        return FailingReader

    monkeypatch.setattr(pipeline.seqfile, "DatabaseReader",
                        failing(pipeline.seqfile.DatabaseReader))
    monkeypatch.setattr(jax_pipeline.seqfile, "DatabaseReader",
                        failing(jax_pipeline.seqfile.DatabaseReader))
    before = threading.active_count()
    kind = type(error)
    with pytest.raises(kind) as got:
        pipeline.run_alignment(q, d, str(tmp_path / "p.bin"), device="cpu",
                               config=pipeline.PipelineConfig(bucket_size=128 * 25))
    with pytest.raises(kind) as want:
        jax_pipeline.run_alignment(q, d, str(tmp_path / "j.bin"),
                                   config=jax_pipeline.PipelineConfig(backend="xla",
                                                                      bucket_size=128 * 25))
    assert str(got.value).replace("p.bin", "") == str(want.value).replace("j.bin", "")
    if kind is OSError:
        assert str(got.value) == f"reading {d} failed mid-run: disk pulled mid-run"
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_an_engine_failure_stops_the_reader_as_bgsa_tpu(tmp_path):
    # the reader is blocked on a full queue (prefetch 1, many buckets) when
    # the main loop fails: it must see the stop event and exit
    q, d = inputs(tmp_path, np.random.default_rng(10), S=1500)

    class FailingEngine:  # bgsa_tpu's run_bucketed takes any engine with scores
        n_shards = 1

        def scores(self, qc, sc):
            if len(np.unique(sc)) > 1:  # the warm-up's dummy buckets pass
                raise RuntimeError("engine failed")
            return np.zeros((qc.shape[0], sc.shape[0]), np.int16)

    class FailingPortEngine(pipeline.Engine):
        def score_codes(self, queries, codes):
            raise RuntimeError("engine failed")

    before = threading.active_count()
    for mod, extra in ((pipeline, {}), (jax_pipeline, {"backend": "xla"})):
        cfg = mod.PipelineConfig(bucket_size=128 * 25, prefetch=1, **extra)
        engine = (FailingPortEngine(normalize(Scoring()), cfg, "cpu") if mod is pipeline
                  else FailingEngine())
        with pytest.raises(RuntimeError, match="engine failed"):
            mod.run_bucketed(engine, q, d, str(tmp_path / "r.bin"), cfg, shard=None,
                             shard_ratios=None, resume=False, write_dtype=np.int16)
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_an_n_bearing_database_matches_bgsa_tpu(tmp_path):
    # 300 subjects with rare 'N's, in buckets of 128: the 'N'-bearing buckets
    # and the tail's 'N' lane pads through the port's run, byte for byte
    q, d = inputs(tmp_path, np.random.default_rng(8), Q=2, S=300, n=25, n_rate=0.01)
    res = str(tmp_path / "r.bin")
    pipeline.run_alignment(q, d, res, config=pipeline.PipelineConfig(bucket_size=128 * 26),
                           device="cpu")
    jax = str(tmp_path / "jax.bin")
    jax_pipeline.run_alignment(q, d, jax, config=jax_pipeline.PipelineConfig(
        backend="xla", bucket_size=128 * 26))
    assert same_bytes(res, jax) and same_bytes(res + ".info", jax + ".info")


@pytest.mark.parametrize("flags", [[], ["--host", "0:1", "-D"]], ids=["single", "dynamic-role"])
def test_the_bucket_sleep_hook_changes_no_byte(tmp_path, capsys, monkeypatch, flags):
    # BGSA_TEST_BUCKET_SLEEP (the resume tests' slow host) in both packages
    q, d = inputs(tmp_path, np.random.default_rng(11), S=600)
    outs = {}
    for sleep in ("", "0.01"):
        monkeypatch.setenv("BGSA_TEST_BUCKET_SLEEP", sleep)
        sync = ["--sync-dir", str(tmp_path / f"sync{sleep}")] if flags else []
        rc, err, jax_rc, _ = align_both(tmp_path, capsys, [*flags, *sync, "--bucket-size",
                                                            str(25 * 256)], q, d)
        assert rc == jax_rc == 0, err
        assert same_bytes(tmp_path / "port.bin", tmp_path / "jax.bin")
        with open(tmp_path / "port.bin", "rb") as f:
            outs[sleep] = f.read()
    assert outs[""] == outs["0.01"]


def test_engine_and_device_refusals():
    with pytest.raises(ValueError, match="unsupported device"):
        pipeline.local_devices(1, "meta")
    banded = NormalizedScheme(Algorithm.BANDED, Mode.GLOBAL, 0, -1, -1, -1)
    with pytest.raises(ValueError, match="BandedEngine"):
        pipeline.Engine(banded, pipeline.PipelineConfig(), "cpu")
    engine = pipeline.Engine(normalize(Scoring()), pipeline.PipelineConfig(), "cpu",
                             devices=["cpu"] * 2)
    payload = pack.two_bit_pack(np.zeros((3, 8), np.uint8))
    with pytest.raises(ValueError, match="do not split into 2 equal shards"):
        engine.scores_packed(np.zeros((1, 8), np.uint8), "2bit", payload, 8)


# -- packers, banded_ref, the native library -----------------------------------------


def test_packer_refusals_match_bgsa_tpu():
    codes = np.zeros((5, 8), np.uint8)
    codes[0, 0] = 4
    both_raise(lambda: pack.sidecar_pack(codes, 2), lambda: jax_pack.sidecar_pack(codes, 2))
    long = np.zeros((2, 40), np.uint8)
    msg = both_raise(lambda: pack.pack_banded_host(long, 32, 40),
                     lambda: jax_pack.pack_banded(long, 32, 40))
    assert "64-bit band register" in msg
    both_raise(lambda: banded_ref.banded_score([0] * 10, [0] * 4, 2),
               lambda: jax_banded_ref.banded_score([0] * 10, [0] * 4, 2))


def test_a_failed_native_build_falls_back_to_numpy(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_FLAGS", ("-O3", "--no-such-flag", "-shared", "-fPIC"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("BGSA_NO_NATIVE", raising=False)
    assert native.get_lib() is None
    assert os.listdir(tmp_path) == []  # the temp file is gone, no library
    assert native.pack_eq(np.zeros((2, 8), np.uint8), 31) is None
    codes = np.random.default_rng(9).integers(0, 5, size=(7, 40)).astype(np.uint8)
    np.testing.assert_array_equal(pack.pack_eq_host(codes, 31), jax_pack.pack_eq(codes, 31))
    assert not native.convert_result("x", "y", 2, 100)


def test_an_unloadable_native_library_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("BGSA_NO_NATIVE", raising=False)
    path = str(tmp_path / os.path.basename(native.library_path()))
    with open(path, "wb") as f:
        f.write(b"not a shared object")
    assert native.get_lib() is None


def test_native_off_by_environment(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("BGSA_NO_NATIVE", "1")
    assert native.get_lib() is None


@pytest.mark.parametrize("call", ["dual-shape", "peq-subjects", "packed-shape", "probe-mode",
                                  "packed-probe-mode", "bitpal-device", "bitpal-packed-device",
                                  "myers-queries"])
def test_kernel_wrappers_refuse_what_their_kernels_do_not_take(call):
    import torch

    from bgsa_tpu_torch.ops import banded as bo
    from bgsa_tpu_torch.ops import banded_packed as bpk
    from bgsa_tpu_torch.ops import banded_packed_pair as bpp
    from bgsa_tpu_torch.ops import banded_pair as bpr
    from bgsa_tpu_torch.ops import bitpal, bitpal_packed, myers_semiglobal

    q = torch.zeros((1, 40), dtype=torch.int32)
    words = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    kw = dict(q_len=40, s_len=40, k=4)
    with pytest.raises(ValueError):
        if call == "dual-shape":
            bo.banded_stream_dual(words(3, 5, 2, 8), q, q_len=40, s_len=36, k=4)
        elif call == "peq-subjects":
            bo.banded(words(5, 8), words(5, 8), words(5, 2, 9), q, q_len=40, s_len=10, k=35)
        elif call == "packed-shape":
            bpk.banded_stream_packed(words(6, 4, 2, 8), q, **kw)
        elif call == "probe-mode":
            bpr.banded_probe_ref(words(5, 2, 8), q, mode="fast", **kw)
        elif call == "packed-probe-mode":
            bpp.banded_packed_probe_ref(words(6, 5, 2, 8), q, mode="fast", **kw)
        elif call == "myers-queries":
            myers_semiglobal.myers_semiglobal(words(5, 2, 8), q[0], read_len=40)
        else:
            fn = bitpal.bitpal if call == "bitpal-device" else bitpal_packed.bitpal_packed
            eq = torch.zeros((5, 2, 8), dtype=torch.int32, device="meta")
            fn(eq, q.to("meta"), match=2, mismatch=-3, gap=-5, read_len=40)


def test_the_read_filter_script_prints_its_hits(capsys, monkeypatch):
    from bgsa_tpu_torch.scripts import read_filter

    assert read_filter.main(["--device", "cpu", "--reads", "1000"]) == 0
    out = capsys.readouterr().out.splitlines()
    target, reads, planted = read_filter.make_reads(1000)
    hits, best = read_filter.filter_and_verify(target, reads, "cpu")
    assert out[0] == (f"filter: {len(hits)} / 1000 reads within {read_filter.K} errors "
                      f"({len(set(hits) & set(planted))} of {len(planted)} planted)")
    assert out[2:] == [f"  read {i:6d}  distance {dist}" for i, dist in best]
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read_filter.main([]) == 1
    assert "--device cpu" in capsys.readouterr().err
