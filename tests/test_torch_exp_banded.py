"""The paired-query banded experiments' kernels of bgsa_tpu_torch, on the CPU.

The plain versions of the stream pair, the three banded probes and the
packed pair (``ops.banded_pair``, ``ops.banded_packed_pair``) are held
against the experiments' own Pallas kernels (``scripts/exp_banded_pair.py``,
``scripts/exp_banded_packed_pair.py``, loaded by path and run with
``pl.pallas_call`` in interpret mode) on a handful of small cases (each
interpret-mode compile costs seconds here), and across a wider grid against
the behavioural model ``banded_ref`` and the port's shipping plain versions.
Integer scores: every comparison is exact.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bgsa_tpu import banded_ref as model
from bgsa_tpu import pack as host_pack
from bgsa_tpu.ops import banded_packed as jax_packed
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.ops import banded as bo
from bgsa_tpu_torch.ops import banded_packed as bpk
from bgsa_tpu_torch.ops import banded_packed_pair as bpp
from bgsa_tpu_torch.ops import banded_pair as bpr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


exp_pair = load_script("exp_banded_pair")
exp_packed_pair = load_script("exp_banded_packed_pair")


@pytest.fixture
def interpret(monkeypatch):
    """pl.pallas_call with interpret=True merged into its keywords (bgsa_tpu's
    own launchers pass the keyword themselves)."""
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: real(*a, **{**kw, "interpret": True}))


def case(seed, Q, m, S, n, k, *, near=0.4):
    """Queries and subjects, a share ``near`` of the subjects within about k
    substitutions of one of the queries; no N (the scripts' workloads have none)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n)).astype(np.int32)
    for i in range(int(S * near)):
        t = rng.integers(0, 4, size=n)
        t[:min(m, n)] = q[i % Q, :min(m, n)]
        edits = rng.integers(0, k + 3)
        t[rng.integers(0, n, size=edits)] = rng.integers(0, 4, size=edits)
        s[i] = t
    return q, s


def oracle(q, s, k):
    return np.array([model.banded_scores(qi, s, k) for qi in q], dtype=np.int32)


def tensor(words_u32):
    return pack.eq_from_numpy(np.array(words_u32))


def band_min_model(eq, m, k, h):
    """The probe's column without latches, on Python ints: every column's
    window ``eq``, err counted from column k, the minimum over h + 1 heights."""
    full = (1 << 64) - 1
    vp = vn = 0
    err = k
    for t in range(m):
        x = eq | vn
        d0 = ((((x & vp) + vp) & full) ^ vp) | x
        hn, hp, xs = d0 & vp, (~(d0 | vp) & full) | vn, d0 >> 1
        vn, vp = xs & hp, (~(hp | xs) & full) | hn
        err += (t >= k) * (1 - (d0 & 1))
    cur = mn = err
    for i in range(h + 1):
        cur += ((vp >> i) & 1) - ((vn >> i) & 1)
        mn = min(mn, cur)
    return mn


# -- against the experiments' Pallas kernels (interpret mode) -------------------

@pytest.mark.parametrize("m,n,k", [(48, 48, 8), (40, 60, 12)])  # 40/60/12: the high word
def test_stream_pair_ref_matches_pallas_pair_kernel(interpret, m, n, k):
    q, s = case(m + n, 2, m, 128, n, k)
    stream = np.asarray(host_pack.pack_banded_stream_jax(s, k, m))
    kw = dict(q_len=m, s_len=n, k=k)
    want = np.asarray(exp_pair.banded_stream_pair(stream, q, **kw))
    got = bpr.banded_stream_pair_ref(tensor(stream), torch.from_numpy(q), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(q, s, k))
    np.testing.assert_array_equal(
        got, bo.banded_stream_ref(tensor(stream), torch.from_numpy(q), **kw).numpy())
    assert (got != 127).any() and ((got == 127).any() or m < 64)  # 40 columns: no latch


@pytest.mark.parametrize("mode", ["full", "static_c", "noload"])
def test_probe_ref_matches_pallas_probe_kernel(interpret, mode):
    m, n, k = 48, 48, 8
    q, s = case(3, 3, m, 128, n, k)  # any Q: the probe has no pairs
    stream = np.asarray(host_pack.pack_banded_stream_jax(s, k, m))
    kw = dict(q_len=m, s_len=n, k=k)
    want = np.asarray(exp_pair.banded_probe(stream, q, mode=mode, **kw))
    got = bpr.banded_probe_ref(tensor(stream), torch.from_numpy(q), mode=mode, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 127).all()  # nothing latches


@pytest.mark.parametrize("m,n,k", [(40, 44, 8)])  # n_sub = 2: a batch, the tail, last_chk
def test_packed_pair_ref_matches_pallas_pair_kernel(interpret, m, n, k):
    n_sub = bpk.packed_subbands(m, n, k)
    assert n_sub == 2
    q, s = case(m + k, 2, m, n_sub * 128, n, k)
    streams = np.asarray(jax_packed.pack_packed_streams_jax(s, k, m, n_sub))
    kw = dict(q_len=m, s_len=n, k=k)
    want = np.asarray(exp_packed_pair.banded_packed_pair(streams, q, **kw))
    got = bpp.banded_packed_pair_ref(tensor(streams), torch.from_numpy(q), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(q, s, k))
    np.testing.assert_array_equal(
        got, bpk.banded_stream_packed_ref(tensor(streams), torch.from_numpy(q), **kw).numpy())


def test_packed_pair_short_query_differs_from_jax_by_k_minus_q_len(interpret):
    # q_len < k: no column is scored and err stays k (banded_ref). The JAX
    # pair kernel takes err = q_len - matches, the bgsa_tpu packed fault of
    # ROADMAP queue 3, so where a pair is not over budget its score is
    # k - q_len too low; the port follows its packed kernel and the model.
    m, n, k = 5, 12, 8
    n_sub = bpk.packed_subbands(m, n, k)
    assert n_sub == 2
    q, s = case(11, 2, m, n_sub * 128, n, k)
    streams = np.asarray(jax_packed.pack_packed_streams_jax(s, k, m, n_sub))
    kw = dict(q_len=m, s_len=n, k=k)
    jax_out = np.asarray(exp_packed_pair.banded_packed_pair(streams, q, **kw))
    got = bpp.banded_packed_pair_ref(tensor(streams), torch.from_numpy(q), **kw).numpy()
    np.testing.assert_array_equal(got, oracle(q, s, k))
    assert (got != 127).all()  # too short for any checkpoint to latch
    np.testing.assert_array_equal(jax_out, got - (k - m))


def test_odd_query_counts_are_refused_as_by_the_jax_launchers():
    m, n, k = 40, 44, 8
    q, s = case(1, 3, m, 128, n, k)
    stream = np.asarray(host_pack.pack_banded_stream_jax(s, k, m))
    kw = dict(q_len=m, s_len=n, k=k)
    with pytest.raises(AssertionError):
        exp_pair.banded_stream_pair(stream, q, **kw)
    for fn in (bpr.banded_stream_pair, bpr.banded_stream_pair_ref):
        with pytest.raises(ValueError, match="even query count"):
            fn(tensor(stream), torch.from_numpy(q), **kw)
    streams = bpk.pack_packed_streams(torch.from_numpy(s), k, m, 2)
    for fn in (bpp.banded_packed_pair, bpp.banded_packed_pair_ref):
        with pytest.raises(ValueError, match="even query count"):
            fn(streams, torch.from_numpy(q), **kw)


# -- wide grids against the model and the shipping plain versions ------------

STREAM_GRID = [(150, 150, 8), (150, 150, 16), (150, 181, 16), (64, 80, 8), (40, 44, 4),
               (70, 70, 0), (33, 40, 3)]
PACKED_GRID = [(150, 158, 8), (150, 150, 8), (72, 72, 5), (100, 100, 4), (40, 44, 4),
               (3, 5, 4), (10, 12, 6), (20, 20, 10)]


@pytest.mark.parametrize("m,n,k", STREAM_GRID)
def test_stream_pair_ref_matches_model(m, n, k):
    q, s = case(2 * m + n + k, 4, m, 60, n, k)
    stream = pack.pack_banded_stream(torch.from_numpy(s), k, m)
    kw = dict(q_len=m, s_len=n, k=k)
    got = bpr.banded_stream_pair(stream, torch.from_numpy(q), **kw).numpy()
    np.testing.assert_array_equal(got, oracle(q, s, k))


@pytest.mark.parametrize("m,n,k", STREAM_GRID)
def test_probe_refs_match_the_unlatched_column(m, n, k):
    q, s = case(3 * m + n + k, 3, m, 40, n, k)
    codes = torch.from_numpy(s)
    stream = pack.pack_banded_stream(codes, k, m)
    qt = torch.from_numpy(q)
    kw = dict(q_len=m, s_len=n, k=k)
    h = k + n - m
    full = bpr.banded_probe(stream, qt, mode="full", **kw).numpy()
    # full: the stream column without its latches, so it equals the stream
    # kernel wherever that kernel has not latched a pair over budget
    latched = bo.banded_stream_ref(stream, qt, **kw).numpy()
    np.testing.assert_array_equal(full[latched != 127], latched[latched != 127])
    # static_c: the full column of a query of code 0 only
    np.testing.assert_array_equal(
        bpr.banded_probe(stream, qt, mode="static_c", **kw).numpy(),
        bpr.banded_probe(stream, torch.zeros_like(qt), mode="full", **kw).numpy())
    # noload: every column's window the subject's first stream word (plane 0)
    words = pack.eq_to_numpy(stream)[0, 0]
    want = np.array([band_min_model(int(w), m, k, h) for w in words], dtype=np.int32)
    np.testing.assert_array_equal(bpr.banded_probe(stream, qt, mode="noload", **kw).numpy(),
                                  np.broadcast_to(want, (len(q), len(s))))


@pytest.mark.parametrize("m,n,k", PACKED_GRID)
def test_packed_pair_ref_matches_model(m, n, k):
    n_sub = bpk.packed_subbands(m, n, k)
    assert n_sub >= 2
    q, s = case(5 * m + n + k, 4, m, n_sub * 20, n, k)
    streams = bpk.pack_packed_streams(torch.from_numpy(s), k, m, n_sub)
    got = bpp.banded_packed_pair(streams, torch.from_numpy(q), q_len=m, s_len=n, k=k).numpy()
    np.testing.assert_array_equal(got, oracle(q, s, k))


def test_wrappers_run_the_plain_versions_on_the_cpu():
    m, n, k = 64, 70, 8
    q, s = case(9, 2, m, 40, n, k)
    qt, codes = torch.from_numpy(q), torch.from_numpy(s)
    kw = dict(q_len=m, s_len=n, k=k)
    before = dict(bpr.LAUNCHES), bpp.LAUNCHES
    stream = pack.pack_banded_stream(codes, k, m)
    assert bpr.banded_stream_pair(stream, qt, **kw).dtype == torch.int32
    for mode in bpr.PROBE_MODES:
        assert bpr.banded_probe(stream, qt, mode=mode, **kw).shape == (2, 40)
    bpp.banded_packed_pair(bpk.pack_packed_streams(codes, k, m, 2), qt, **kw)
    assert (dict(bpr.LAUNCHES), bpp.LAUNCHES) == before  # plain versions launch nothing


def test_wrappers_reject_what_the_stream_kernel_rejects():
    stream = pack.pack_banded_stream(torch.zeros((8, 66), dtype=torch.int32), 8, 70)
    q70 = torch.zeros((2, 70), dtype=torch.int32)
    with pytest.raises(ValueError, match="s_len >= q_len"):
        bpr.banded_stream_pair(stream, q70, q_len=70, s_len=66, k=8)
    with pytest.raises(ValueError, match="s_len >= q_len"):
        bpr.banded_probe(stream, q70, q_len=70, s_len=66, k=8, mode="full")
    stream = pack.pack_banded_stream(torch.zeros((8, 64), dtype=torch.int32), 6, 64)
    with pytest.raises(ValueError, match="mode"):
        bpr.banded_probe(stream, q70[:, :64], q_len=64, s_len=64, k=6, mode="fast")
    with pytest.raises(ValueError, match="device"):
        bpr.banded_stream_pair(stream.to("meta"), q70[:, :64], q_len=64, s_len=64, k=6)
    with pytest.raises(ValueError, match="sub-bands"):
        bpp.banded_packed_pair(torch.zeros((2, 5, 8, 4), dtype=torch.int32),
                               torch.zeros((2, 150), dtype=torch.int32), q_len=150, s_len=150,
                               k=8)


def test_thread_counts_of_the_pair_kernels():
    # a pair thread runs while either of its queries has a live pair; a packed
    # pair thread while any of its 2 x n_sub pairs is live
    dead = torch.tensor([[1, 0, 1, 1, 0, 1], [1, 1, 0, 1, 0, 1],
                         [0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 0]], dtype=torch.bool)
    assert bpr.pair_threads(dead).tolist() == [[1, 0, 0, 1, 0, 1], [0, 0, 1, 1, 1, 0]]
    # n_sub = 2: subjects (0, 3), (1, 4), (2, 5) share a thread's fields
    assert bpp.packed_pair_threads(2)(dead).tolist() == [[1, 0, 0], [0, 0, 0]]
    m, n, k = 100, 100, 4
    q, s = case(4, 4, m, 30, n, k)
    stream = pack.pack_banded_stream(torch.from_numpy(s), k, m)
    lanes, pairs = [], []
    bo.banded_stream_ref(stream, torch.from_numpy(q), q_len=m, s_len=n, k=k, live=lanes)
    bpr.banded_stream_pair_ref(stream, torch.from_numpy(q), q_len=m, s_len=n, k=k, live=pairs)
    assert len(pairs) == m and pairs[0] == 2 * 30
    assert all(p <= a <= 2 * p for a, p in zip(lanes, pairs))
