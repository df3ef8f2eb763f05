"""The paired-query banded kernels' window schedule, on the CPU.

Both pair kernels run the shipping kernels' window fold with two queries a
thread. The stream pair (``csrc/banded_pair.cu``
``banded_stream_pair_kernel<Wide>``) loads every code's stream words w,
w + 1 (and w + 2 where band_down >= 32) once per 32-column window w = t >> 5
into one slot that both queries' chains read, and latches a pair over
budget at the batch ends <= the last checkpoint and at the last checkpoint
(``ops.banded.windowed_stream_columns``, ``kernel_latch_array``). The packed
pair (``csrc/banded_packed_pair.cu``) loads every code's and field's word
pair once per window w = min(t >> 5, W - 2) and latches at the ends of the
32-column batches from min(k, q_len) and at the last checkpoint
(``ops.banded_packed.windowed_columns``, ``packed_latch_array``). A thread
runs until both of its queries are over budget.

``windowed_stream_pair_ref`` and ``windowed_packed_pair_ref`` are those
schedules in plain torch. They must equal the pair kernels' plain versions,
the shipping kernels' plain versions and the experiments' JAX kernels
(Pallas interpret mode) on garbage, near and mix inputs, at the window
edges: q_len 32, 64 and 96, band_down 31, 36, 40 and 63, words past the
stream's last one, and the packed window's W - 2 clamp. The thread-column
counts the bound takes (``pair_threads``, ``packed_pair_threads``: the
threads still running under the reference's checkpoints) stay what the
schedules' threads are. Integer scores and counts: every comparison is
exact.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bgsa_tpu import pack as host_pack
from bgsa_tpu.ops import banded_packed as jax_packed
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.benchutil import filter_mix_dataset
from bgsa_tpu_torch.ops import banded as bo
from bgsa_tpu_torch.ops import banded_packed as bpk
from bgsa_tpu_torch.ops import banded_packed_pair as bpp
from bgsa_tpu_torch.ops import banded_pair as bpr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (q_len, s_len, k) of the stream pair: the experiment's geometry, then the
# window edges: q_len 32, 64 and 96; band_down 2, 31 (the last narrow
# instance), 32, 36, 40 and 63
STREAM = [(150, 150, 8), (150, 150, 16), (150, 181, 16), (64, 80, 8), (150, 150, 1),
          (32, 47, 8), (32, 36, 16), (64, 72, 16), (96, 96, 16), (96, 100, 16), (40, 44, 4)]
# (q_len, s_len, k) of the packed pair: n_sub 2 to 8 and 16, q_len 32, 64
# and 96, min(k, q_len) never a multiple of 32, and q_len < k
PACKED = [(150, 158, 8), (150, 150, 8), (150, 150, 7), (72, 72, 5), (100, 100, 4), (40, 44, 4),
          (3, 5, 4), (150, 151, 3), (100, 100, 3), (7, 7, 1), (32, 32, 4), (64, 66, 5),
          (96, 96, 8)]
KINDS = ("garbage", "near", "mix")


def inputs(seed, Q, m, S, n, k, kind):
    """(queries, subjects) codes: random subjects with N (every pair over
    budget), queries and subjects within k/4 substitutions of one base
    sequence, or the read-filter mix (30 % near)."""
    rng = np.random.default_rng(seed)
    if kind == "mix":
        q, s = filter_mix_dataset(rng, Q, S, max(m, n, 6))
        return q[:, :m].astype(np.int32), s[:, :n].astype(np.int32)
    if kind == "near":
        base = rng.integers(0, 4, size=max(m, n))
        q, s = np.repeat(base[None, :m], Q, axis=0), np.repeat(base[None, :n], S, axis=0)
        for row in (*q, *s):
            e = rng.integers(0, k // 4 + 1)
            row[rng.integers(0, row.size, size=e)] = rng.integers(0, 4, size=e)
        return q.astype(np.int32), s.astype(np.int32)
    return (rng.integers(0, 4, size=(Q, m)).astype(np.int32),
            rng.integers(0, 5, size=(S, n)).astype(np.int32))


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """pl.pallas_call with interpret=True merged into its keywords."""
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: real(*a, **{**kw, "interpret": True}))


def band_down(m, n, k):
    return bo.geometry(m, n, k)[1]


def test_the_grids_reach_the_window_edges():
    assert {32, 64, 96} <= {m for m, _, _ in STREAM}
    assert {31, 32, 36, 40, 63} <= {band_down(*g) for g in STREAM}
    assert {32, 64, 96} <= {m for m, _, _ in PACKED}
    assert set(range(2, 9)) | {16} <= {bpk.packed_subbands(*g) for g in PACKED}


# -- the stream pair ------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", STREAM)
def test_stream_pair_schedule_equals_plain_versions(m, n, k, kind):
    q, s = inputs(5 * m + n + k, 4, m, 96, n, k, kind)
    stream = pack.pack_banded_stream(torch.from_numpy(s), k, m)
    qt = torch.from_numpy(q)
    kw = dict(q_len=m, s_len=n, k=k)
    got = bpr.windowed_stream_pair_ref(stream, qt, **kw)
    assert got.dtype == torch.int32 and got.shape == (4, 96)
    assert torch.equal(got, bpr.banded_stream_pair_ref(stream, qt, **kw))
    assert torch.equal(got, bo.banded_stream_ref(stream, qt, **kw))
    assert torch.equal(got, bo.windowed_stream_ref(stream, qt, **kw))  # the shipping schedule
    if kind == "near":
        assert (got != 127).any()  # not every pair latched


@pytest.mark.parametrize("m,n,k,kind", [(32, 47, 8, "near"), (64, 72, 16, "mix"),
                                        (96, 100, 16, "near"), (150, 181, 16, "garbage"),
                                        (150, 150, 8, "mix")])
def test_stream_pair_schedule_equals_the_jax_pair_kernel(interpret, m, n, k, kind):
    exp_pair = load_script("exp_banded_pair")
    q, s = inputs(3 * m + k, 2, m, 128, n, k, kind)
    words = np.asarray(host_pack.pack_banded_stream_jax(s, k, m))
    kw = dict(q_len=m, s_len=n, k=k)
    want = np.asarray(exp_pair.banded_stream_pair(words, q, **kw))
    got = bpr.windowed_stream_pair_ref(pack.eq_from_numpy(words), torch.from_numpy(q), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("past", [1, 2])
@pytest.mark.parametrize("m,n,k", [(32, 47, 8), (64, 72, 16), (96, 96, 16), (96, 100, 16)])
def test_stream_pair_reads_zero_past_the_last_word(m, n, k, past):
    # random words, no packer (the packer leaves two words of room): the last
    # window's word w + past is the first past W and reads as 0
    rng = np.random.default_rng(m + n + past)
    W = (m - 1) // 32 + past
    stream = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(5, W, 64), dtype=np.int64)
                              .astype(np.int32))
    qt = torch.from_numpy(rng.integers(0, 4, size=(4, m)).astype(np.int32))
    kw = dict(q_len=m, s_len=n, k=k)
    assert torch.equal(bpr.windowed_stream_pair_ref(stream, qt, **kw),
                       bpr.banded_stream_pair_ref(stream, qt, **kw))


def test_stream_pair_codes_outside_0_to_4_match_nothing():
    # the staged rows clamp codes above 4 to the zero slot: codes 5 and 9
    # score as code 4 against a stream whose code-4 plane is zero
    m, n, k = 96, 100, 16
    q, s = inputs(9, 4, m, 60, n, k, "near")
    q[0, ::7], q[3, 20::11] = 5, 9
    stream = pack.pack_banded_stream(torch.from_numpy(s), k, m)
    zeroed = stream.clone()
    zeroed[4] = 0
    kw = dict(q_len=m, s_len=n, k=k)
    want = bo.banded_stream_ref(zeroed, torch.from_numpy(np.where(q >= 5, 4, q)), **kw)
    got = bpr.windowed_stream_pair_ref(stream, torch.from_numpy(q), **kw)
    assert torch.equal(got, want) and (got != 127).any()


# -- the packed pair --------------------------------------------------------------

def packed_case(m, n, k, kind, S_sub=24, Q=4):
    n_sub = bpk.packed_subbands(m, n, k)
    q, s = inputs(7 * m + n + k, Q, m, n_sub * S_sub, n, k, kind)
    codes = torch.from_numpy(s)
    return torch.from_numpy(q), bpk.pack_packed_streams(codes, k, m, n_sub), codes


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", PACKED)
def test_packed_pair_schedule_equals_plain_versions(m, n, k, kind):
    qt, streams, _ = packed_case(m, n, k, kind)
    kw = dict(q_len=m, s_len=n, k=k)
    got = bpp.windowed_packed_pair_ref(streams, qt, **kw)
    assert got.dtype == torch.int32 and got.shape == (4, streams.shape[0] * streams.shape[3])
    assert torch.equal(got, bpp.banded_packed_pair_ref(streams, qt, **kw))
    assert torch.equal(got, bpk.banded_stream_packed_ref(streams, qt, **kw))
    if kind == "near" and m >= k:
        assert (got != 127).any()


@pytest.mark.parametrize("m,n,k,W", [(150, 150, 8, 3), (150, 150, 8, 4), (100, 100, 4, 3),
                                     (100, 100, 4, 4), (96, 96, 8, 3)])
def test_packed_pair_window_clamps_at_the_last_word_pair(m, n, k, W):
    # streams of few words (random words, no packer: the packer leaves room),
    # so the columns past 32 (W - 1) share the last pair, shifted further
    rng = np.random.default_rng(W + m)
    n_sub = bpk.packed_subbands(m, n, k)
    streams = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(n_sub, 5, W, 16),
                                            dtype=np.int64).astype(np.int32))
    assert any((t >> 5) > W - 2 for t in range(m))
    qt = torch.from_numpy(rng.integers(0, 5, size=(4, m)).astype(np.int32))
    kw = dict(q_len=m, s_len=n, k=k)
    assert torch.equal(bpp.windowed_packed_pair_ref(streams, qt, **kw),
                       bpp.banded_packed_pair_ref(streams, qt, **kw))


@pytest.mark.parametrize("m,n,k,kind", [(40, 44, 8, "mix"), (40, 44, 8, "near")])
def test_packed_pair_schedule_equals_the_jax_pair_kernel(interpret, m, n, k, kind):
    exp_packed_pair = load_script("exp_banded_packed_pair")
    n_sub = bpk.packed_subbands(m, n, k)
    assert n_sub == 2  # n_sub = 3, q_len 32 or 64: minutes each in interpret mode
    q, s = inputs(m + n, 2, m, n_sub * 128, n, k, kind)
    words = np.asarray(jax_packed.pack_packed_streams_jax(s, k, m, n_sub))
    kw = dict(q_len=m, s_len=n, k=k)
    want = np.asarray(exp_packed_pair.banded_packed_pair(words, q, **kw))
    got = bpp.windowed_packed_pair_ref(pack.eq_from_numpy(words), torch.from_numpy(q), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got != 127).any()


def test_packed_pair_short_query_differs_from_jax_by_k_minus_q_len(interpret):
    # q_len < k: no column is scored and err stays k. The JAX pair kernel
    # takes err = q_len - matches (a known fault of the JAX packed kernels),
    # so its scores are k - q_len too low; the schedule keeps the model's
    exp_packed_pair = load_script("exp_banded_packed_pair")
    m, n, k = 5, 12, 8
    n_sub = bpk.packed_subbands(m, n, k)
    q, s = inputs(11, 2, m, n_sub * 128, n, k, "mix")
    words = np.asarray(jax_packed.pack_packed_streams_jax(s, k, m, n_sub))
    kw = dict(q_len=m, s_len=n, k=k)
    jax_out = np.asarray(exp_packed_pair.banded_packed_pair(words, q, **kw))
    got = bpp.windowed_packed_pair_ref(pack.eq_from_numpy(words), torch.from_numpy(q), **kw)
    assert (got != 127).all()
    np.testing.assert_array_equal(jax_out, got.numpy() - (k - m))


@pytest.mark.parametrize("m,n,k", PACKED)
def test_packed_latch_columns(m, n, k):
    latch = bpk.packed_latch_array(m, n, k)
    last = bo.last_checkpoint(m, n, k)
    head_end = min(k, m)
    want = {t for t in range(head_end, m) if (t + 1 - head_end) % 32 == 0 and t + 1 <= last}
    assert set(np.flatnonzero(latch)) == want | {last - 1}
    assert np.flatnonzero(bo.chk_array(m, n, k)).max() == last - 1


# -- the threads the bound counts -------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(150, 150, 8), (150, 181, 16), (96, 100, 16), (40, 44, 4)])
def test_stream_pair_threads_run_until_both_queries_are_over_budget(m, n, k):
    q, s = inputs(m + k, 6, m, 80, n, k, "mix")
    stream = pack.pack_banded_stream(torch.from_numpy(s), k, m)
    qt = torch.from_numpy(q)
    kw = dict(q_len=m, s_len=n, k=k)
    threads, lanes, kernel = [], [], []
    bpr.banded_stream_pair_ref(stream, qt, live=threads, **kw)  # the bound's count
    bo.banded_stream_ref(stream, qt, live=lanes, **kw)
    bpr.windowed_stream_pair_ref(stream, qt, live=kernel, **kw)
    assert len(threads) == len(kernel) == m and threads[0] == kernel[0] == 3 * 80
    assert all(p <= a <= 2 * p for a, p in zip(lanes, threads))  # a thread: one or two pairs
    assert threads[:32] == kernel[:32]  # no latch before the first batch's end
    assert all(x >= y for x, y in zip(kernel, kernel[1:]))


@pytest.mark.parametrize("m,n,k", [(150, 158, 8), (150, 150, 8), (72, 72, 5), (32, 32, 4)])
def test_packed_pair_threads_are_the_bounds_threads(m, n, k):
    # under the reference's checkpoints the packed states' threads (all
    # 2 n_sub fields over budget) are packed_pair_threads' on the
    # per-subject scan, which the bound counts
    qt, streams, codes = packed_case(m, n, k, "mix", S_sub=40, Q=6)
    n_sub = streams.shape[0]
    kw = dict(q_len=m, s_len=n, k=k)
    bound, packed, kernel = [], [], []
    bo.banded_stream_ref(pack.pack_banded_stream(codes, k, m), qt, live=bound,
                         threads=bpp.packed_pair_threads(n_sub), **kw)
    _, band_down_, _ = bo.geometry(m, n, k)
    pitch, wmask = band_down_ + 2, (1 << (band_down_ + 1)) - 1
    bpk.packed_scan(streams, qt, eq_at=lambda st, t, q: bo.column_eq(
        bpk.packed_window(st, t, pitch, wmask), q[:, t]), chk=bo.chk_array(m, n, k), live=packed,
        threads=bpr.pair_threads, **kw)
    assert packed == bound and bound[0] == 3 * 40
    bpp.windowed_packed_pair_ref(streams, qt, live=kernel, **kw)
    assert kernel[:min(k, m) + 32] == bound[:min(k, m) + 32]  # before the first latch


def test_thread_columns_at_the_experiments_shapes():
    # the thread-columns the kernels line bounds the two pair kernels by, at
    # the experiments' own inputs (chip_smoke.py phase 18): the count the
    # bound took before the kernels moved to the window fold
    from bgsa_tpu_torch.scripts import exp_banded_packed_pair as packed_exp
    from bgsa_tpu_torch.scripts import exp_banded_pair as pair_exp

    rng = np.random.default_rng(pair_exp.SEED)
    q, s = filter_mix_dataset(rng, pair_exp.QUERIES, pair_exp.SUBJECTS, pair_exp.LENGTH)
    kw = dict(q_len=pair_exp.LENGTH, s_len=pair_exp.LENGTH, k=pair_exp.K)
    stream = pack.pack_banded_stream(torch.from_numpy(s.astype(np.int32)), pair_exp.K,
                                     pair_exp.LENGTH)
    live = []
    bo.banded_stream_ref(stream, torch.from_numpy(q), live=live, threads=bpr.pair_threads, **kw)
    assert sum(live) == 18_467_976
    q, s = packed_exp.inputs("mix")
    n_sub = bpk.packed_subbands(packed_exp.LENGTH, packed_exp.LENGTH, packed_exp.K)
    kw = dict(q_len=packed_exp.LENGTH, s_len=packed_exp.LENGTH, k=packed_exp.K)
    live = []
    bo.banded_stream_ref(pack.pack_banded_stream(torch.from_numpy(s), packed_exp.K,
                                                 packed_exp.LENGTH),
                         torch.from_numpy(q), live=live, threads=bpp.packed_pair_threads(n_sub),
                         **kw)
    assert sum(live) == 7_135_846
