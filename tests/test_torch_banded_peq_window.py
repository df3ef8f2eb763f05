"""The Peq-carry banded kernel's window fold and latch rule, on the CPU.

The kernel (``csrc/banded.cu`` ``banded_peq_kernel<Wide>``) carries no Peq
planes: it reads them as two streams, A the initial window (the words
init_lo, init_hi, zero past them; read by the columns t < 64) and B the
injection bits, bit u at position band_down + 1 + u, built at the top of
each 32-column batch from the injection words (word j from words j - 1, j,
or j - 2 .. j where band_down >= 32, by one funnel shift; injection word i
is inj's min(i, W - 1), none before word 0; bits from q_len - k on zeroed),
and folds each column as (A's window) | (B's window masked to the band). It
latches a pair over budget only at the batch ends <= the last checkpoint
and at the last checkpoint. ``ops.banded.windowed_peq_columns`` and
``windowed_peq_ref`` are that schedule in plain torch. The first must give
every column every code's plane of the reference's shift-and-inject carry
(``peq_columns``, which ``banded_ref`` reads) bit for bit, on random words
too (bits above band_down, bits past q_len - k, fewer injection words than
q_len - k needs); the second must equal ``banded_ref``, the JAX kernel
(Pallas interpret mode) and ``banded_xla`` on garbage, near and mix inputs.
Integer registers and scores: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu import pack as host_pack
from bgsa_tpu.ops import banded as jax_banded
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.ops import banded as bo

from test_torch_banded_stream_window import KINDS, inputs

# (q_len, s_len, k): the route (2k > 63, s_len < k: (55, 20, 40) is the CLI's
# -k 40 run, (63, 31, 32) the longest query the route takes), then band_down
# 31 (the last narrow instance), 32 and 63, q_len < k (no injection), and
# queries past column 64 (A runs out; whole B-only batches)
ROUTE = [(55, 20, 40), (50, 20, 40), (63, 31, 32), (40, 10, 35)]
EDGES = [(100, 95, 18), (150, 150, 16), (150, 181, 16), (20, 10, 30), (150, 150, 8),
         (70, 64, 8)]
GEOMETRIES = ROUTE + EDGES


def random_words(rng, W, S=9):
    """init_lo, init_hi (5, S) and inj (5, W, S) int32 of random bits."""
    return [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64)
                             .astype(np.int32)) for shape in ((5, S), (5, S), (5, W, S))]


def assert_folds_equal(lo, hi, inj, m, n, k):
    kw = dict(q_len=m, s_len=n, k=k)
    windowed = list(bo.windowed_peq_columns(lo, hi, inj, **kw))
    assert [t for t, _ in windowed] == list(range(m))  # every column, in order
    for (t, got), (_, want) in zip(windowed, bo.peq_columns(lo, hi, inj, **kw)):
        assert torch.equal(got, want), t


def test_geometries_cover_the_edges():
    band_downs = {bo.geometry(*g)[1] for g in GEOMETRIES}
    assert {31, 32, 63} <= band_downs
    assert all(2 * k > 63 and n < k for _, n, k in ROUTE)
    assert any(m < k for m, _, k in GEOMETRIES) and any(m > 64 for m, _, _ in GEOMETRIES)
    assert max(m for m, _, _ in ROUTE) == 63


@pytest.mark.parametrize("words", ["packed", "random", "short W"])
@pytest.mark.parametrize("m,n,k", GEOMETRIES)
def test_window_fold_equals_the_carried_planes(m, n, k, words):
    rng = np.random.default_rng(m + 3 * n + 7 * k + len(words))
    n_inj_words = max(1, -(-(m - k) // 32))
    if words == "packed":
        s = rng.integers(0, 5, size=(9, n)).astype(np.int32)
        lo, hi, inj = pack.pack_banded(torch.from_numpy(s), k, m)
    else:
        # random bits above band_down in the window and past q_len - k in
        # the injections; "short W": one word, where the index clamps at
        # W - 1 for every column from 32 on
        lo, hi, inj = random_words(rng, 1 if words == "short W" else n_inj_words + 1)
    assert_folds_equal(lo, hi, inj, m, n, k)


def test_short_w_clamps_to_the_last_word():
    # q_len - k = 142 injections in one word: columns 32.. read word 0 again
    m, n, k = 150, 150, 8
    lo, hi, inj = random_words(np.random.default_rng(4), 1)
    kw = dict(q_len=m, s_len=n, k=k)
    clamped = list(bo.windowed_peq_columns(lo, hi, inj, **kw))
    repeated = list(bo.windowed_peq_columns(lo, hi, inj.repeat(1, 5, 1), **kw))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(clamped, repeated))
    zero_past = torch.cat([inj, torch.zeros_like(inj).repeat(1, 4, 1)], dim=1)
    differs = list(bo.windowed_peq_columns(lo, hi, zero_past, **kw))
    assert not all(torch.equal(a, b) for (_, a), (_, b) in zip(clamped, differs))


def test_injections_past_q_len_minus_k_are_not_read():
    # bits of inj from q_len - k on never reach a register
    m, n, k = 70, 64, 8
    lo, hi, inj = random_words(np.random.default_rng(6), 3)
    cut = inj.clone()
    cut[:, 1] &= (1 << (m - k - 32)) - 1  # bits 62, 63 of the stream cleared
    cut[:, 2] = 0
    kw = dict(q_len=m, s_len=n, k=k)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        bo.windowed_peq_columns(lo, hi, inj, **kw), bo.windowed_peq_columns(lo, hi, cut, **kw)))


def test_no_injection_when_the_query_is_shorter_than_k():
    # q_len < k: every column's register is the initial window shifted
    m, n, k = 20, 10, 30
    lo, hi, inj = random_words(np.random.default_rng(8), 1)
    init = bo.words64(lo, hi)
    for t, got in bo.windowed_peq_columns(lo, hi, inj, q_len=m, s_len=n, k=k):
        assert torch.equal(got, bo.shr(init, t))


def test_codes_outside_0_to_4_match_nothing():
    # codes 5 and 9 score as code 4 against a window and injections whose
    # code-4 planes are zero
    m, n, k = 55, 20, 40
    q, s = inputs(9, 3, m, 60, n, k, "near")
    q[:, ::11], q[:, 5::13] = 5, 9
    args = pack.pack_banded(torch.from_numpy(s), k, m)
    zeroed = [x.clone() for x in args]
    for x in zeroed:
        x[4] = 0
    kw = dict(q_len=m, s_len=n, k=k)
    want = bo.banded_ref(*zeroed, torch.from_numpy(np.where(q >= 5, 4, q)), **kw)
    got = bo.windowed_peq_ref(*args, torch.from_numpy(q), **kw)
    assert torch.equal(got, want) and (got != 127).any()


@pytest.mark.parametrize("m,n,k", GEOMETRIES)
def test_windowed_ref_equals_banded_ref_on_random_words(m, n, k):
    rng = np.random.default_rng(5 * m + n + k)
    q = rng.integers(0, 5, size=(3, m)).astype(np.int32)
    for W in (1, max(1, -(-(m - k) // 32)) + 1):
        args = random_words(rng, W, S=40)
        kw = dict(q_len=m, s_len=n, k=k)
        assert torch.equal(bo.windowed_peq_ref(*args, torch.from_numpy(q), **kw),
                           bo.banded_ref(*args, torch.from_numpy(q), **kw))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", GEOMETRIES)
def test_latch_rule_equals_plain_version_and_jax(m, n, k, kind):
    q, s = inputs(13 * m + n + k, 2, m, 128, n, k, kind)
    qt = torch.from_numpy(q)
    kw = dict(q_len=m, s_len=n, k=k)
    lo, hi, inj = host_pack.pack_banded(s, k, m)
    want = np.asarray(jax_banded.banded(lo, hi, inj, q, interpret=True, **kw))
    np.testing.assert_array_equal(np.asarray(jax_banded.banded_xla(lo, hi, inj, q, **kw)), want)
    args = [pack.eq_from_numpy(np.asarray(x)) for x in (lo, hi, inj)]
    got = bo.windowed_peq_ref(*args, qt, **kw)
    assert got.dtype == torch.int32
    assert torch.equal(got, bo.banded_ref(*args, qt, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "near" and n >= m - k // 4:
        assert (got != 127).any()  # not every pair latched
