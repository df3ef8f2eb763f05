"""The readers' native line encode against numpy's lookup.

``native.encode_lines`` gives ``pack.MAPPING`` on every byte value at line
lengths on both sides of the vector width, with the 'N' pad rows after them;
``DatabaseReader`` and ``read_queries`` give the same codes, bucket layout
and ragged-line errors with the native library and with ``native.get_lib``
patched to None (numpy); a CLI run writes the same result and ``.info``
bytes on both paths as ``bgsa_tpu`` does; ``RunStats.reader_native_buckets``
counts the buckets the native pass encoded, and ``--stats-json`` writes it.
"""

import json

import numpy as np
import pytest

from bgsa_tpu import banded_pipeline as jax_banded_pipeline
from bgsa_tpu import pipeline as jax_pipeline
from bgsa_tpu.pipeline import PipelineConfig as JaxConfig
from bgsa_tpu_torch import cli, native, pack
from bgsa_tpu_torch.io import seqfile
from bgsa_tpu_torch.stats import RunStats

LENGTHS = (1, 31, 32, 33, 150, 960)


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "the native library did not build"
    return lib


def lines(body: np.ndarray) -> np.ndarray:
    """The flat bytes of ``body``'s rows, each followed by a newline."""
    nl = np.full((body.shape[0], 1), ord("\n"), np.uint8)
    return np.concatenate([body, nl], axis=1).reshape(-1)


def both_paths(monkeypatch, fn):
    """fn() with the native library, then with get_lib patched to None."""
    got = fn()
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        want = fn()
    return got, want


@pytest.mark.parametrize("length", LENGTHS)
def test_encode_lines_is_the_mapping_on_every_byte(lib, length):
    rng = np.random.default_rng(length)
    rows = -(-256 // length) + 40
    body = rng.integers(0, 256, (rows, length), dtype=np.uint8)
    body.reshape(-1)[:256] = np.arange(256, dtype=np.uint8)  # every byte value
    body[-20:] = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (20, length))]
    codes, bad = native.encode_lines(lines(body), rows, length, length + 1, pad_rows=3)
    assert bad == -1 and codes.shape == (rows + 3, length) and codes.flags.c_contiguous
    np.testing.assert_array_equal(codes[:rows], pack.MAPPING[body])
    assert (codes[rows:] == 4).all()
    # every byte value at every column: each line a shifted run of 0..255
    ramp = ((np.arange(256)[:, None] + np.arange(length)[None, :]) % 256).astype(np.uint8)
    codes, bad = native.encode_lines(lines(ramp), 256, length, length + 1)
    assert bad == -1
    np.testing.assert_array_equal(codes, pack.MAPPING[ramp])


@pytest.mark.parametrize("length", LENGTHS)
def test_encode_lines_finds_the_first_ragged_line(lib, length):
    body = np.full((9, length), ord("A"), np.uint8)
    raw = lines(body)
    raw[5 * (length + 1) + length] = ord("C")
    raw[7 * (length + 1) + length] = ord("C")
    assert native.encode_lines(raw, 9, length, length + 1)[1] == 5
    assert native.encode_lines(raw, 5, length, length + 1)[1] == -1


def test_encode_lines_refuses_a_short_buffer(lib):
    with pytest.raises(ValueError, match="fewer than 3 lines"):
        native.encode_lines(np.zeros(10, np.uint8), 3, 4, 5)
    for rows, length, stride, pad_rows in ((1, 4, 4, 0), (1, 0, 1, 0), (-1, 4, 5, 0),
                                           (1, 4, 5, -1)):
        with pytest.raises(ValueError, match="bad line geometry"):
            native.encode_lines(np.zeros(10, np.uint8), rows, length, stride, pad_rows)
    codes, bad = native.encode_lines(np.zeros(0, np.uint8), 0, 4, 5, pad_rows=2)
    assert bad == -1 and codes.shape == (2, 4) and (codes == 4).all()


def database(path, rows, length, seed, final_newline=True):
    """A database of bases, N, lowercase and other bytes, each line's last
    byte a base (a '\\r' there would read as CRLF)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTNACGTacgtnX*\r ", np.uint8)
    body = alphabet[rng.integers(0, len(alphabet), (rows, length))]
    body[:, -1] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, rows)]
    data = lines(body).tobytes()
    with open(path, "wb") as f:
        f.write(data if final_newline else data[:-1])
    return body


@pytest.mark.parametrize("rows,length,bucket_lines,v_num,final_newline", [
    (1000, 150, 200, 128, True),  # 128-row buckets, a tail of 104 + 24 pads
    (1000, 150, 10_000, 128, True),  # one bucket, 1000 + 24 pads
    (777, 33, 100, 16, False),  # 96-row buckets, a tail of 9 + 7 pads; no final newline
    (512, 31, 64, 64, True),  # no pads
    (300, 960, 40, 8, False),
    (50, 1, 7, 2, True),
])
def test_database_reader_native_and_numpy_agree(lib, tmp_path, monkeypatch, rows, length,
                                                 bucket_lines, v_num, final_newline):
    path = str(tmp_path / "d.txt")
    body = database(path, rows, length, rows + length, final_newline)

    def read():
        stats = RunStats()
        buckets = [(b.codes.tobytes(), b.codes.shape, b.count, b.extra_count)
                   for b in seqfile.DatabaseReader(path, bucket_lines * (length + 1), v_num,
                                                   stats)]
        return buckets, stats

    (got, native_stats), (want, numpy_stats) = both_paths(monkeypatch, read)
    assert got == want
    assert native_stats.reader_native_buckets == len(got) and numpy_stats.reader_native_buckets == 0
    assert native_stats.reader_encode_time > 0 and native_stats.reader_read_time > 0
    codes = np.concatenate([np.frombuffer(c, np.uint8).reshape(shape) for c, shape, _, _ in got])
    extra = got[-1][3]
    np.testing.assert_array_equal(codes[:rows], pack.MAPPING[body])
    assert (codes[rows:] == 4).all() and len(codes) == rows + extra
    assert sum(count for _, _, count, _ in got) % v_num == 0


@pytest.mark.parametrize("reader", ["database", "database-later-bucket", "queries"])
def test_a_ragged_line_raises_the_same_error_on_both_paths(lib, tmp_path, monkeypatch, reader):
    path = str(tmp_path / "f.txt")
    lines_ = [b"ACGT"] * 40
    bad = 29 if reader == "database-later-bucket" else 6
    lines_[bad], lines_[bad + 1] = b"ACGTA", b"ACG"  # the file's size still lines up
    with open(path, "wb") as f:
        f.write(b"\n".join(lines_) + b"\n")
    if reader == "queries":
        call = lambda: seqfile.read_queries(path)  # noqa: E731
    else:
        call = lambda: list(seqfile.DatabaseReader(path, 8 * 5, 4))  # noqa: E731

    def message():
        with pytest.raises(ValueError) as e:
            call()
        return str(e.value)

    got, want = both_paths(monkeypatch, message)
    assert got == want
    assert got.endswith(f"(ragged line near sequence {bad})"), got


@pytest.mark.parametrize("data", [b"ACGTN\nacgtx\nTTGA*\n\n\n", b"ACG\rA\nNNNNN", b"A\nC\nG\nT\nN\n"],
                         ids=["blank-tail", "no-final-newline", "one-base"])
def test_read_queries_native_and_numpy_agree(lib, tmp_path, monkeypatch, data):
    path = str(tmp_path / "q.txt")
    with open(path, "wb") as f:
        f.write(data)
    got, want = both_paths(monkeypatch, lambda: seqfile.read_queries(path))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    rows = [r for r in data.split(b"\n") if r]
    np.testing.assert_array_equal(got, pack.MAPPING[np.frombuffer(b"".join(rows), np.uint8)]
                                  .reshape(len(rows), -1))


@pytest.mark.parametrize("family", ["myers", "banded"])
def test_cli_results_and_stats_on_both_paths(lib, tmp_path, monkeypatch, family):
    """Result and .info bytes equal on both paths and to bgsa_tpu's; the
    native buckets counted in --stats-json."""
    q, d = str(tmp_path / "q.txt"), str(tmp_path / "d.txt")
    rng = np.random.default_rng(17)
    seqfile.write_seq_file(q, rng.integers(0, 5, (3, 20), np.uint8))
    db = np.frombuffer(b"ACGTNacgt", np.uint8)[rng.integers(0, 9, (600, 20))]
    db[:, -1] = ord("A")
    seqfile.write_seq_file(d, db)
    bucket_size = 256 * 21  # buckets of 256, 256 and 88 + 40 'N' lane pads
    flags = ["-k", "4"] if family == "banded" else []
    runs = []

    def run():
        out = str(tmp_path / f"r{len(runs)}.bin")
        runs.append(out)
        assert cli.align_main(["-q", q, "-d", d, "-f", out, *flags, "--bucket-size",
                               str(bucket_size), "--stats-json", out + ".stats",
                               "--device", "cpu", "--quiet"]) == 0
        with open(out + ".stats") as f:
            return json.load(f)

    got, want = both_paths(monkeypatch, run)
    assert got["reader_native_buckets"] == 3 and want["reader_native_buckets"] == 0
    assert len(got["bucket_cal_times"]) == 3
    ref = str(tmp_path / "jax.bin")
    config = JaxConfig(backend="xla", bucket_size=bucket_size)
    if family == "banded":
        jax_banded_pipeline.run_banded(q, d, ref, 4, config)
    else:
        jax_pipeline.run_alignment(q, d, ref, config=config)
    for suffix in ("", ".info"):
        paths = [runs[0] + suffix, runs[1] + suffix, ref + suffix]
        native_bytes, numpy_bytes, ref_bytes = (open(path, "rb").read() for path in paths)
        assert native_bytes == numpy_bytes == ref_bytes, suffix
