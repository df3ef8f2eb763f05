"""The stream and dual banded kernels' window fold and latch rule, on the CPU.

The kernels (``csrc/banded.cu`` ``banded_stream_kernel<Dual, Wide>``) load
every code's stream words w, w + 1 (and w + 2 where band_down >= 32) once
per 32-column window w = t >> 5, at the top of each 32-column batch, and
fold each column from them; the dual kernel's columns t <= 2k also fold the
preload stream A's whole window from a second slot. They latch a pair over
budget only at the batch ends <= the last checkpoint and at the last
checkpoint. ``ops.banded.windowed_stream_columns`` and
``windowed_stream_ref`` are that schedule in plain torch. The first must
give every column the register the per-column fold gives
(``stream_window_at``, ``dual_window_at``) bit for bit, also where w + 2
lies past the stream's last word, at band_down 63 and where the dual head
ends inside a window; the second must equal the shipping plain versions
and the JAX kernels (Pallas interpret mode) on garbage, near and mix
inputs. Integer registers and scores: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu import pack as host_pack
from bgsa_tpu.ops import banded as jax_banded
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.benchutil import filter_mix_dataset
from bgsa_tpu_torch.ops import banded as bo

# tests/test_torch_banded.py's STREAM and DUAL, then the window edges:
# q_len 32, 64 and 96, band_down 31 (narrow), 40 and 36 (wide), and the
# dual head (t <= 2k) ending on the first column of window 1 (96, 95, 16)
STREAM = [(150, 150, 16), (150, 181, 16), (64, 80, 8), (150, 150, 1), (32, 47, 8),
          (64, 72, 16), (96, 96, 16)]
DUAL = [(100, 95, 20), (150, 148, 8), (41, 30, 20), (100, 99, 31), (32, 28, 20),
        (64, 60, 12), (96, 95, 16)]
KINDS = ("garbage", "near", "mix")
CODES = torch.arange(5)


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


def streams_of(s, m, k, dual):
    codes = torch.from_numpy(s)
    return pack.pack_banded_streams(codes, k, m) if dual else pack.pack_banded_stream(codes, k, m)


def assert_folds_equal(streams, m, n, k, dual):
    per_column = (bo.dual_window_at if dual else bo.stream_window_at)(streams, m, n, k)
    windowed = list(bo.windowed_stream_columns(streams, q_len=m, s_len=n, k=k, dual=dual))
    assert [t for t, _ in windowed] == list(range(m))  # every column, in order
    for t, got in windowed:
        assert torch.equal(got, per_column(CODES, t)), t


@pytest.mark.parametrize("m,n,k,dual", [(*g, False) for g in STREAM] + [(*g, True) for g in DUAL])
def test_window_fold_equals_per_column_fold(m, n, k, dual):
    _, s = inputs(m + n + k, 1, m, 40, n, k, "mix")
    s[::3] = np.random.default_rng(k).integers(0, 5, size=s[::3].shape)  # N in the streams
    assert_folds_equal(streams_of(s, m, k, dual), m, n, k, dual)


@pytest.mark.parametrize("past", [1, 2])
@pytest.mark.parametrize("m,n,k,dual", [(32, 47, 8, False), (64, 72, 16, False),
                                        (96, 96, 16, False), (32, 28, 20, True),
                                        (64, 60, 12, True), (96, 95, 16, True)])
def test_window_fold_reads_zero_past_the_last_word(m, n, k, dual, past):
    # random words, no packer (the packer leaves two words of room): the last
    # window's word w + past is the first past W and reads as 0; A's words
    # are not empty past position 2k either, so its whole window counts
    rng = np.random.default_rng(m + past)
    W = (m - 1) // 32 + past
    st = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(2, 5, W, 6), dtype=np.int64)
                          .astype(np.int32))
    assert ((m - 1) >> 5) + past == W
    assert_folds_equal(st if dual else st[1], m, n, k, dual)


def test_narrow_instance_reads_the_low_half_only():
    # band_down 31 (the last narrow instance): the high words do not matter
    m, n, k = 32, 47, 8
    assert bo.geometry(m, n, k)[1] == 31
    rng = np.random.default_rng(3)
    st = torch.from_numpy(rng.integers(0, 1 << 31, size=(5, 4, 7), dtype=np.int64).astype(np.int32))
    noisy = st.clone()
    noisy[:, 2:] = -1  # words w + 2 of every window
    a = list(bo.windowed_stream_columns(st, q_len=m, s_len=n, k=k))
    b = list(bo.windowed_stream_columns(noisy, q_len=m, s_len=n, k=k))
    assert all(torch.equal(x, y) and int(x.max()) < 1 << 32 for (_, x), (_, y) in zip(a, b))


def test_codes_outside_0_to_4_match_nothing():
    rng = np.random.default_rng(5)
    regs = torch.from_numpy(rng.integers(1, 1 << 40, size=(5, 7), dtype=np.int64))
    got = bo.column_eq(regs, torch.tensor([0, 4, 5, 2, 9]))
    assert torch.equal(got[[0, 1, 3]], regs[[0, 4, 2]])
    assert int(got[[2, 4]].abs().sum()) == 0
    # end to end: codes 5 and 9 score as code 4 against a stream whose code-4
    # plane is zero
    m, n, k = 150, 150, 16
    q, s = inputs(9, 3, m, 60, n, k, "near")
    q[:, ::41], q[:, 20::53] = 5, 9
    stream = streams_of(s, m, k, False)
    zeroed = stream.clone()
    zeroed[4] = 0
    want = bo.banded_stream_ref(zeroed, torch.from_numpy(np.where(q >= 5, 4, q)), q_len=m,
                                s_len=n, k=k)
    got = bo.windowed_stream_ref(stream, torch.from_numpy(q), q_len=m, s_len=n, k=k)
    assert torch.equal(got, want) and (got != 127).any()


@pytest.mark.parametrize("m,n,k", STREAM + DUAL)
def test_kernel_latch_columns(m, n, k):
    latch = bo.kernel_latch_array(m, n, k)
    last = bo.last_checkpoint(m, n, k)
    want = {t for t in range(m) if (t + 1) % 32 == 0 and t + 1 <= last} | {last - 1}
    assert set(np.flatnonzero(latch)) == want - {-1}
    # every reference checkpoint lies at or before the last latch
    assert np.flatnonzero(bo.chk_array(m, n, k)).max() == last - 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k,dual", [(*g, False) for g in STREAM] + [(*g, True) for g in DUAL])
def test_latch_rule_equals_plain_versions_and_jax(m, n, k, dual, kind):
    q, s = inputs(7 * m + n + k, 2, m, 128, n, k, kind)
    qt = torch.from_numpy(q)
    kw = dict(q_len=m, s_len=n, k=k)
    if dual:
        words = np.asarray(host_pack.pack_banded_streams_jax(s, k, m))
        jax_out = jax_banded.banded_stream_dual(words, q, interpret=True, **kw)
        plain = bo.banded_stream_dual_ref
    else:
        words = np.asarray(host_pack.pack_banded_stream_jax(s, k, m))
        jax_out = jax_banded.banded_stream(words, q, interpret=True, **kw)
        plain = bo.banded_stream_ref
    streams = pack.eq_from_numpy(words)
    got = bo.windowed_stream_ref(streams, qt, dual=dual, **kw)
    assert got.dtype == torch.int32
    assert torch.equal(got, plain(streams, qt, **kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out))
    if kind == "near":
        assert (got != 127).any()  # not every pair latched
