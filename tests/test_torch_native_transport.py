"""The database reader's encode straight to the transport payload.

``seqfile.encode_transport`` (``native.encode_transport`` and
``native.list_n``, one pass from the file's bytes) gives what
``pack.select_transport`` gives for the codes of ``seqfile.encode_lines``:
the same name, payload bytes and sidecar, at line lengths around the
vector width, on N-free lines, a few 'N's, 'N' pad rows, N-heavy lines (the
nibble fallback), bytes outside ACGTN and lowercase, on both sides of the
native row loop's 1,024-row cut at 1 and 8 threads; the same with
``native.get_lib`` patched to None (numpy); the same first ragged line as
``encode_lines``; no load past the bucket's last byte. ``DatabaseReader``
hands out those payloads, and a single-host run packs nothing on its main
thread and writes the result and ``.info`` bytes ``bgsa_tpu`` writes.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bgsa_tpu import banded_pipeline as jax_banded_pipeline
from bgsa_tpu import pipeline as jax_pipeline
from bgsa_tpu.pipeline import PipelineConfig as JaxConfig
from bgsa_tpu_torch import cli, native, pack
from bgsa_tpu_torch.io import seqfile
from bgsa_tpu_torch.stats import RunStats

LENGTHS = (1, 3, 31, 32, 33, 150, 151, 960)
KINDS = ("clean", "few_n", "pads", "n_heavy", "other_bytes", "lowercase")
ROWS = (300, 5000)  # fewer and more than the native row loop's 1,024 rows a thread
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "the native library did not build"
    return lib


def lines(body: np.ndarray) -> bytes:
    """``body``'s rows, each followed by a newline."""
    nl = np.full((body.shape[0], 1), ord("\n"), np.uint8)
    return np.concatenate([body, nl], axis=1).tobytes()


def bucket(kind: str, rows: int, length: int):
    """(line bytes, pad rows) of one bucket of ``kind``."""
    rng = np.random.default_rng([KINDS.index(kind), rows, length])
    alphabet = {"n_heavy": b"ACGTN", "lowercase": b"acgtnACGT",
                "other_bytes": bytes(b for b in range(256) if b != ord("\n"))}
    body = np.frombuffer(alphabet.get(kind, b"ACGT"), np.uint8)[
        rng.integers(0, len(alphabet.get(kind, b"ACGT")), (rows, length))]
    if kind in ("few_n", "lowercase"):
        body.reshape(-1)[rng.integers(0, body.size, max(rows // 50, 2))] = ord("N")
        body[-1, -1] = ord("N")
    return lines(body), 7 if kind in ("pads", "n_heavy") else 0


def leaves(payload):
    return payload if isinstance(payload, tuple) else (payload,)


def assert_same(got, want):
    """Two (transport, payload) pairs: the same name and leaves, byte for byte."""
    assert got[0] == want[0]
    assert len(leaves(got[1])) == len(leaves(want[1]))
    for a, b in zip(leaves(got[1]), leaves(want[1])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def select(raw: bytes, rows: int, length: int, pad_rows: int, n_shards=1, threads=1):
    codes, bad, _ = seqfile.encode_lines(raw, rows, length, pad_rows)
    assert bad == -1
    return pack.select_transport(codes, n_shards=n_shards, threads=threads)


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_native_pass_is_select_transport(lib, length, kind, rows, threads):
    raw, pad_rows = bucket(kind, rows, length)
    name, payload, bad, native_pass, packed = seqfile.encode_transport(
        raw, rows, length, pad_rows, threads=threads)
    want = select(raw, rows, length, pad_rows, threads=threads)
    assert bad == -1 and native_pass
    assert_same((name, payload), want)
    assert packed == (name != "nib")  # only the nibble transport falls back


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_numpy_path_gives_the_same_payload(lib, monkeypatch, length, kind):
    raw, pad_rows = bucket(kind, 300, length)
    got = seqfile.encode_transport(raw, 300, length, pad_rows)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    want = seqfile.encode_transport(raw, 300, length, pad_rows)
    assert want[2:] == (-1, False, False)
    assert_same(got[:2], want[:2])


def test_every_transport_is_reached(lib):
    """At 150 bp and 5,000 rows: N-free lines "2bit"; a few 'N's, or the
    pad rows alone, "2bitN"; N-heavy lines "nib"."""
    got = {}
    for kind in ("clean", "few_n", "pads", "n_heavy"):
        raw, pad_rows = bucket(kind, 5000, 150)
        got[kind] = seqfile.encode_transport(raw, 5000, 150, pad_rows)
    assert {k: v[0] for k, v in got.items()} == {
        "clean": "2bit", "few_n": "2bitN", "pads": "2bitN", "n_heavy": "nib"}
    positions = got["pads"][1][1]
    assert positions.shape == (2048, 2)  # 7 x 150 'N's, to a multiple of 1,024 rows
    np.testing.assert_array_equal(positions[:1050, 0], np.repeat(np.arange(5000, 5007), 150))
    np.testing.assert_array_equal(positions[:1050, 1], np.tile(np.arange(150), 7))
    assert (positions[1050:] == 5007).all()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_other_shard_counts_pack_the_codes(lib, n_shards):
    """The sidecar splits by shard there: the reader encodes the codes and
    packs them with select_transport."""
    raw, _ = bucket("few_n", 4096, 150)
    name, payload, bad, native_pass, packed = seqfile.encode_transport(
        raw, 4096, 150, 0, n_shards)
    assert (bad, native_pass, packed) == (-1, True, False) and name == "2bitN"
    assert_same((name, payload), select(raw, 4096, 150, 0, n_shards))


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("length", [1, 33, 150])
def test_a_ragged_line_gives_the_index_of_encode_lines(lib, length, where, threads):
    rows = 5000
    raw = bytearray(bucket("few_n", rows, length)[0])
    first = {"first": 0, "middle": 2600, "last": rows - 1}[where]
    for row in {first, rows - 1}:  # a later ragged line too, in another thread's rows
        raw[row * (length + 1) + length] = ord("C")
    raw = bytes(raw)
    got = seqfile.encode_transport(raw, rows, length, 3, threads=threads)
    assert got[:2] == (None, None) and got[2] == first
    assert native.encode_transport(np.frombuffer(raw, np.uint8), rows, length, length + 1, 3,
                                   threads)[3] == first
    assert seqfile.encode_lines(raw, rows, length, 3)[1] == first


def test_no_load_past_the_buckets_last_byte(lib):
    """Each bucket ends where an unreadable page starts: a load past its
    last byte would kill the child process."""
    script = textwrap.dedent("""
        import ctypes, mmap
        import numpy as np
        from bgsa_tpu_torch import native, pack
        page = mmap.PAGESIZE * 16
        libc = ctypes.CDLL(None, use_errno=True)
        libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        for length in (1, 3, 31, 32, 33, 63, 150, 151):
            m = mmap.mmap(-1, 2 * page)
            base = ctypes.addressof(ctypes.c_char.from_buffer(m))
            assert libc.mprotect(base + page, page, 0) == 0
            rows = page // (length + 1) - 1
            size = rows * (length + 1)
            buf = np.frombuffer(m, np.uint8, count=size, offset=page - size)
            rng = np.random.default_rng(length)
            body = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (rows, length))]
            buf[:] = np.concatenate([body, np.full((rows, 1), 10, np.uint8)], 1).reshape(-1)
            for threads in (1, 8):
                packed, row_n, n, bad = native.encode_transport(buf, rows, length, length + 1,
                                                                2, threads)
                assert bad == -1 and n == (body == ord("N")).sum() + 2 * length
                codes = np.where(body == ord("N"), 0, pack.MAPPING[body])
                assert (packed[:rows] == pack.two_bit_pack(codes)).all()
                pos = native.list_n(buf, rows, length, length + 1, 2, row_n, n + 7)
                assert pos.shape == (n + 7, 2)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": ROOT}
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and done.stdout.strip() == "ok", done.stderr[-2000:]


def database(path, rows, length, seed, final_newline=True):
    """A database of bases with a few 'N's, lowercase and other bytes."""
    rng = np.random.default_rng(seed)
    body = np.frombuffer(b"ACGTACGTacgtX", np.uint8)[rng.integers(0, 13, (rows, length))]
    body.reshape(-1)[rng.integers(rows * length // 2, rows * length, 5)] = ord("N")
    body[rows // 2, 0] = ord("N")  # none in the first half
    body[:, -1] = ord("A")
    data = lines(body)
    with open(path, "wb") as f:
        f.write(data if final_newline else data[:-1])


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("rows,length,bucket_lines,v_num,final_newline", [
    (3064, 64, 1024, 128, True),  # "2bit", "2bitN", then a tail of 1,016 + 8 pads ("2bitN")
    (1000, 150, 300, 128, False),  # 256-row buckets; a tail of 232 + 24 pads ("nib")
    (300, 960, 40, 8, True),
])
def test_reader_hands_out_the_payloads(lib, tmp_path, rows, length, bucket_lines, v_num,
                                       final_newline, n_shards):
    path = str(tmp_path / "d.txt")
    database(path, rows, length, rows, final_newline)
    size = bucket_lines * (length + 1)
    stats = RunStats()
    got = list(seqfile.DatabaseReader(path, size, v_num * n_shards, stats,
                                      transport_shards=n_shards, threads=8))
    want = list(seqfile.DatabaseReader(path, size, v_num * n_shards))
    assert [(b.count, b.extra_count) for b in got] == [(b.count, b.extra_count) for b in want]
    for g, w in zip(got, want):
        assert g.codes is None
        assert_same((g.transport, g.payload), pack.select_transport(w.codes, n_shards=n_shards))
    native_packed = [b.transport != "nib" for b in got] if n_shards == 1 else [False] * len(got)
    assert stats.reader_packed_buckets == sum(native_packed)
    assert stats.reader_native_buckets == len(got) and stats.reader_encode_time > 0
    if rows == 3064 and n_shards == 1:
        assert [b.transport for b in got] == ["2bit", "2bitN", "2bitN"]


def test_reader_refuses_a_ragged_line(lib, tmp_path):
    path = str(tmp_path / "d.txt")
    lines_ = [b"ACGT"] * 40
    lines_[29], lines_[30] = b"ACGTA", b"ACG"  # the file's size still lines up
    with open(path, "wb") as f:
        f.write(b"\n".join(lines_) + b"\n")
    for shards in (None, 1, 2):
        with pytest.raises(ValueError, match=r"\(ragged line near sequence 29\)$"):
            list(seqfile.DatabaseReader(path, 8 * 5, 4, transport_shards=shards))


@pytest.mark.parametrize("family", ["myers", "banded"])
def test_single_host_run_packs_in_the_reader(lib, tmp_path, monkeypatch, family):
    """Result and .info bytes equal to bgsa_tpu's on both paths; the main
    thread packs nothing (pack_time 0, no bgsa.transport_pack), and the
    reader's pass packs every bucket where the native library loads."""
    q, d = str(tmp_path / "q.txt"), str(tmp_path / "d.txt")
    seqfile.write_seq_file(q, np.random.default_rng(21).integers(0, 5, (3, 64), np.uint8))
    database(d, 3064, 64, 21)
    bucket_size = 1024 * 65  # buckets of 1,024, 1,024 and 1,016 + 8 'N' lane pads
    flags = ["-k", "4"] if family == "banded" else []
    runs = []

    def run():
        out = str(tmp_path / f"r{len(runs)}.bin")
        runs.append(out)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert cli.align_main(["-q", q, "-d", d, "-f", out, *flags, "--bucket-size",
                                   str(bucket_size), "--stats-json", out + ".stats",
                                   "--device", "cpu", "--quiet"]) == 0
        names = {e.key for e in prof.key_averages()}
        assert "bgsa.dispatch" in names and "bgsa.transport_pack" not in names
        with open(out + ".stats") as f:
            return json.load(f)

    got = run()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    want = run()
    assert got["reader_packed_buckets"] == got["reader_native_buckets"] == 3
    assert want["reader_packed_buckets"] == want["reader_native_buckets"] == 0
    assert got["pack_time"] == want["pack_time"] == 0
    assert len(got["bucket_cal_times"]) == 3 and got["scored_rows"] == 3072
    ref = str(tmp_path / "jax.bin")
    config = JaxConfig(backend="xla", bucket_size=bucket_size)
    if family == "banded":
        jax_banded_pipeline.run_banded(q, d, ref, 4, config)
    else:
        jax_pipeline.run_alignment(q, d, ref, config=config)
    for suffix in ("", ".info"):
        native_bytes, numpy_bytes, ref_bytes = (open(path + suffix, "rb").read()
                                                for path in (*runs, ref))
        assert native_bytes == numpy_bytes == ref_bytes, suffix
