"""bgsa_tpu_torch's banded modules against bgsa_tpu's, on the CPU.

The geometry helpers, the device packers and the plain versions of the four
banded kernels are held against their JAX counterparts (the Pallas kernels
in interpret mode, as tests/test_banded*.py run them, or the XLA twin
``banded_packed_xla`` where interpret mode livelocks at n_sub >= 4) and
against the behavioural model ``bgsa_tpu.banded_ref``, on the same
numpy-seeded inputs. Integer scores and words: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu import banded_ref as model
from bgsa_tpu import pack as host_pack
from bgsa_tpu.ops import banded as jax_banded
from bgsa_tpu.ops import banded_packed as jax_packed
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.ops import banded as bo
from bgsa_tpu_torch.ops import banded_packed as bp

# (q_len, s_len, k) over every route and edge: packed n_sub 2, 3, 6 (and a
# short query with a single checkpoint), the stream kernel's hi word and
# band_down == 63, the dual kernel with 2k >= 32 and band_down >= 32, and
# the Peq-carry corner 2k > 63 with subjects shorter than k
PACKED = [(150, 158, 8), (150, 150, 8), (100, 100, 4), (40, 44, 4)]
STREAM = [(150, 150, 16), (150, 181, 16), (64, 80, 8), (150, 150, 1)]
DUAL = [(100, 95, 20), (150, 148, 8), (41, 30, 20), (100, 99, 31)]
PEQ = [(50, 20, 40), (55, 20, 40)]


def case(seed, Q, m, S, n, k, *, n_rate=0.01):
    """Queries and subjects, half of the subjects near one of the queries."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n)).astype(np.int32)
    for i in range(S // 2):
        t = rng.integers(0, 4, size=n)
        t[:min(m, n)] = q[i % Q, :min(m, n)]
        edits = rng.integers(0, k + 3)
        t[rng.integers(0, n, size=edits)] = rng.integers(0, 4, size=edits)
        s[i] = t
    s[rng.random(s.shape) < n_rate] = 4
    return q, s


def oracle(q, s, k):
    return np.array([model.banded_scores(qi, s, k) for qi in q], dtype=np.int32)


def words(x):
    return pack.eq_to_numpy(x)


def tensor(words_u32):
    """uint32 words from bgsa_tpu (numpy or jax) -> the port's int32 tensor."""
    return pack.eq_from_numpy(np.array(words_u32))


# -- geometry helpers ------------------------------------------------------

GRID = [(q, s, k) for q in (1, 40, 64, 65, 100, 150) for s in (1, 20, 64, 99, 150, 158, 181)
        for k in (0, 4, 8, 16, 31, 40)]


def _raises(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("q_len", [1, 40, 64, 65, 100, 150])
def test_geometry_matches_jax(q_len):
    for _, s_len, k in (g for g in GRID if g[0] == q_len):
        assert _raises(bo.geometry, q_len, s_len, k) == _raises(
            jax_banded._geometry, q_len, s_len, k)
        np.testing.assert_array_equal(bo.chk_array(q_len, s_len, k),
                                      jax_banded._chk_array(q_len, s_len, k))
        assert bp.packed_subbands(q_len, s_len, k) == jax_packed.packed_subbands(q_len, s_len, k)
        if bp.packed_subbands(q_len, s_len, k):
            assert bp.consts(q_len, s_len, k) == jax_packed._consts(q_len, s_len, k)


def test_word_helpers():
    assert bo.const64(1 << 63) == -(2**63) and bo.const64((1 << 64) - 1) == -1
    x = torch.tensor([-1, -(2**63), 5], dtype=torch.int64)
    assert bo.shr(x, 1).tolist() == [2**63 - 1, 2**62, 2]
    assert bo.shr(x, 63).tolist() == [1, 1, 0] and bo.shr(x, 0).tolist() == x.tolist()
    lo = torch.tensor([-1, 7], dtype=torch.int32)
    hi = torch.tensor([-(2**31), 0], dtype=torch.int32)
    w = bo.words64(lo, hi)
    assert w.tolist() == [bo.const64(0x80000000FFFFFFFF), 7]
    assert torch.equal(pack.int32_words(w & bo.MASK32), lo)
    assert torch.equal(pack.int32_words(bo.shr(w, 32)), hi)


# -- packers ---------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", PACKED + STREAM + DUAL)
def test_stream_packers_match_jax(m, n, k):
    _, s = case(n + k, 1, m, 40, n, k)
    codes = torch.from_numpy(s)
    if n >= m:
        want = np.asarray(host_pack.pack_banded_stream_jax(s, k, m))
        np.testing.assert_array_equal(words(pack.pack_banded_stream(codes, k, m)), want)
    want = np.asarray(host_pack.pack_banded_streams_jax(s, k, m))
    np.testing.assert_array_equal(words(pack.pack_banded_streams(codes, k, m)), want)


@pytest.mark.parametrize("m,n,k", PACKED + DUAL + PEQ + [(150, 150, 16)])
def test_pack_banded_matches_jax_and_numpy(m, n, k):
    _, s = case(m + k, 1, m, 40, n, k)
    got = [words(x) for x in pack.pack_banded(torch.from_numpy(s), k, m)]
    for want in (host_pack.pack_banded_jax(s, k, m), host_pack.pack_banded(s, k, m)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_pack_banded_rejects_preload_overflow():
    with pytest.raises(ValueError, match="preload"):
        pack.pack_banded(torch.zeros((4, 65), dtype=torch.int32), 40, 100)


@pytest.mark.parametrize("m,n,k", PACKED)
def test_pack_packed_streams_matches_jax(m, n, k):
    n_sub = bp.packed_subbands(m, n, k)
    _, s = case(m + n, 1, m, n_sub * 128, n, k)
    got = bp.pack_packed_streams(torch.from_numpy(s), k, m, n_sub)
    want = np.asarray(jax_packed.pack_packed_streams_jax(s, k, m, n_sub))
    np.testing.assert_array_equal(words(got), want)
    # no lane rule: any multiple of n_sub packs, chunk by chunk
    small = bp.pack_packed_streams(torch.from_numpy(s[:n_sub * 5]), k, m, n_sub)
    assert small.shape[-1] == 5
    with pytest.raises(ValueError, match="multiple of"):
        bp.pack_packed_streams(torch.from_numpy(s[:n_sub * 5 + 1]), k, m, n_sub)


# -- plain kernel versions against the JAX kernels and the model ------------

@pytest.mark.parametrize("m,n,k", PACKED)
def test_packed_ref_matches_jax_and_model(m, n, k):
    n_sub = bp.packed_subbands(m, n, k)
    q, s = case(7 * m + n, 2, m, n_sub * 128, n, k)
    streams = jax_packed.pack_packed_streams_jax(s, k, m, n_sub)
    kw = dict(q_len=m, s_len=n, k=k)
    if n_sub <= 3:
        want = jax_packed.banded_stream_packed(streams, q, interpret=True, **kw)
    else:  # interpret mode livelocks the XLA CPU simplifier at n_sub >= 4
        want = jax_packed.banded_packed_xla(streams, q, **kw)
    got = bp.banded_stream_packed_ref(tensor(streams),
                                      torch.from_numpy(q), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, oracle(q, s, k))
    assert (got == 127).any() and (got != 127).any()


@pytest.mark.parametrize("m,n,k", STREAM + PACKED[:1])
def test_stream_ref_matches_jax_and_model(m, n, k):
    q, s = case(3 * m + n + k, 2, m, 128, n, k)
    stream = np.asarray(host_pack.pack_banded_stream_jax(s, k, m))
    kw = dict(q_len=m, s_len=n, k=k)
    want = np.asarray(jax_banded.banded_stream(stream, q, interpret=True, **kw))
    got = bo.banded_stream_ref(tensor(stream), torch.from_numpy(q), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(q, s, k))


@pytest.mark.parametrize("m,n,k", DUAL)
def test_dual_ref_matches_jax_and_model(m, n, k):
    q, s = case(5 * m + n + k, 2, m, 128, n, k)
    streams = np.asarray(host_pack.pack_banded_streams_jax(s, k, m))
    kw = dict(q_len=m, s_len=n, k=k)
    want = np.asarray(jax_banded.banded_stream_dual(streams, q, interpret=True, **kw))
    got = bo.banded_stream_dual_ref(tensor(streams), torch.from_numpy(q),
                                    **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(q, s, k))


@pytest.mark.parametrize("m,n,k", PEQ + [(150, 150, 8), (70, 64, 8)])
def test_peq_ref_matches_jax_and_model(m, n, k):
    q, s = case(11 * m + n + k, 2, m, 128, n, k)
    lo, hi, inj = host_pack.pack_banded(s, k, m)
    kw = dict(q_len=m, s_len=n, k=k)
    want = np.asarray(jax_banded.banded(lo, hi, inj, q, interpret=True, **kw))
    np.testing.assert_array_equal(
        np.asarray(jax_banded.banded_xla(lo, hi, inj, q, **kw)), want)
    got = bo.banded_ref(*map(tensor, (lo, hi, inj)), torch.from_numpy(q),
                        **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(q, s, k))


@pytest.mark.parametrize("m,n,k", [(3, 5, 4), (10, 12, 6), (20, 20, 10), (1, 1, 0), (0, 2, 1)])
def test_packed_short_query_corners_match_model(m, n, k):
    # q_len < k or q_len <= k + h: no field may latch, and err starts at k
    # (bgsa_tpu's packed twin charges q_len there; the port follows the model)
    n_sub = bp.packed_subbands(m, n, k)
    assert n_sub >= 2
    q, s = case(m + 100 * k, 2, m, n_sub * 4, n, k)
    got = bp.banded_stream_packed_ref(bp.pack_packed_streams(torch.from_numpy(s), k, m, n_sub),
                                      torch.from_numpy(q), q_len=m, s_len=n, k=k).numpy()
    np.testing.assert_array_equal(got, oracle(q, s, k))
    stream = pack.pack_banded_stream(torch.from_numpy(s), k, m)
    np.testing.assert_array_equal(
        bo.banded_stream_ref(stream, torch.from_numpy(q), q_len=m, s_len=n, k=k).numpy(), got)


# -- wrappers --------------------------------------------------------------

def test_wrappers_dispatch_cpu_to_plain_versions():
    m, n, k = 64, 70, 8  # n_sub = 2
    q, s = case(2, 2, m, 60, n, k)
    qt, codes = torch.from_numpy(q), torch.from_numpy(s)
    kw = dict(q_len=m, s_len=n, k=k)
    before = dict(bo.LAUNCHES), bp.LAUNCHES
    want = oracle(q, s, k)
    n_sub = bp.packed_subbands(m, n, k)
    got = bp.banded_stream_packed(bp.pack_packed_streams(codes, k, m, n_sub), qt, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    got = bo.banded_stream(pack.pack_banded_stream(codes, k, m), qt, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bo.banded_stream_dual(pack.pack_banded_streams(codes, k, m), qt, **kw).numpy(), want)
    np.testing.assert_array_equal(bo.banded(*pack.pack_banded(codes, k, m), qt, **kw).numpy(),
                                  want)
    assert (dict(bo.LAUNCHES), bp.LAUNCHES) == before  # plain versions launch nothing


def test_wrappers_reject_what_the_jax_wrappers_reject():
    codes = torch.zeros((8, 64), dtype=torch.int32)
    q70 = torch.zeros((1, 70), dtype=torch.int32)
    with pytest.raises(ValueError, match="s_len >= q_len"):  # h < k
        bo.banded_stream(pack.pack_banded_stream(torch.zeros((8, 66), dtype=torch.int32), 8, 70),
                         q70, q_len=70, s_len=66, k=8)
    with pytest.raises(ValueError, match="2k <= 63"):
        bo.banded_stream_dual(pack.pack_banded_streams(codes[:, :20], 40, 55),
                              torch.zeros((1, 55), dtype=torch.int32), q_len=55, s_len=20, k=40)
    with pytest.raises(ValueError, match="preload"):
        bo.banded_stream_dual(pack.pack_banded_streams(codes[:, :60], 32, 61),
                              torch.zeros((1, 61), dtype=torch.int32), q_len=61, s_len=60, k=32)
    with pytest.raises(ValueError, match="band of 86"):
        bo.banded_stream(torch.zeros((5, 8, 8), dtype=torch.int32),
                         torch.zeros((1, 100), dtype=torch.int32), q_len=100, s_len=145, k=20)
    stream = pack.pack_banded_stream(codes, 6, 64)
    with pytest.raises(ValueError, match="int32"):
        bo.banded_stream(stream.long(), q70[:, :64], q_len=64, s_len=64, k=6)
    with pytest.raises(ValueError, match="queries"):
        bo.banded_stream(stream, q70, q_len=64, s_len=64, k=6)
    with pytest.raises(ValueError, match="device"):
        bo.banded_stream(stream.to("meta"), q70[:, :64], q_len=64, s_len=64, k=6)
    lo, hi, inj = pack.pack_banded(codes[:, :20], 40, 55)
    with pytest.raises(ValueError, match="one device"):
        bo.banded(lo, hi, inj.to("meta"), torch.zeros((1, 55), dtype=torch.int32),
                  q_len=55, s_len=20, k=40)
    with pytest.raises(ValueError, match="sub-bands"):
        bp.banded_stream_packed(torch.zeros((2, 5, 8, 4), dtype=torch.int32),
                                torch.zeros((1, 150), dtype=torch.int32),
                                q_len=150, s_len=150, k=8)
