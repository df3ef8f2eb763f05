"""bgsa_tpu_torch.ops.myers_pallas against bgsa_tpu.ops.myers_pallas.

The plain torch version of the 31-bit reserved-carry Myers kernel is held
against the JAX XLA twin (``myers_xla.myers_global``) and the Pallas kernel
in interpret mode (as tests/test_myers_pallas.py runs it), on the same
numpy-seeded inputs. Integer scores: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu import oracle
from bgsa_tpu import pack as jax_pack
from bgsa_tpu.ops import myers_pallas as jax_mp
from bgsa_tpu.ops import myers_xla
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.ops import myers_pallas as mp

S = 128  # the Pallas kernel's lane multiple


def inputs(seed, Q, m, n):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n)).astype(np.int32)
    s[rng.random((S, n)) < 0.03] = 4  # N in subjects
    q[0, 1] = 4  # and in a query
    # all-ones carry chains: a subject equal to the query, one of one base
    s[0, :min(m, n)] = q[0, :min(m, n)]
    s[1] = 2
    s[2] = 4
    return q, s


def port(q, s, n, factor):
    eq = pack.eq_from_numpy(jax_pack.pack_eq(s, 31))
    return mp.myers_global_ref(eq, torch.from_numpy(q), read_len=n, factor=factor).numpy()


# word boundaries of the 31-bit layout: W = 1 (n <= 31), maskh at bit 30
# (n = 31, 62, 93), the carry into a new word (n = 32, 63, 64)
LENGTHS = [1, 20, 30, 31, 32, 62, 63, 64, 100]


@pytest.mark.parametrize("factor", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_ref_matches_xla(n, factor):
    q, s = inputs(n, 3, 40, n)
    eq = jax_pack.pack_eq(s, 31)
    want = np.asarray(myers_xla.myers_global(eq, q, read_len=n, factor=factor))
    np.testing.assert_array_equal(port(q, s, n, factor), want)


@pytest.mark.parametrize("factor", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_ref_matches_pallas_interpret(n, factor):
    q, s = inputs(1000 + n, 2, 17, n)
    eq = jax_pack.pack_eq(s, 31)
    want = np.asarray(jax_mp.myers_global(eq, q, read_len=n, factor=factor, interpret=True))
    np.testing.assert_array_equal(port(q, s, n, factor), want)


def test_wrapper_runs_plain_version_on_cpu_and_matches_oracle():
    q, s = inputs(5, 2, 45, 70)
    s[s == 4] = 0  # the oracle scores N as a character; keep ACGT
    q[q == 4] = 0
    eq = pack.eq_from_numpy(jax_pack.pack_eq(s, 31))
    before = mp.LAUNCHES
    got = mp.myers_global(eq, torch.from_numpy(q), read_len=70).numpy()
    assert mp.LAUNCHES == before  # the plain version, not a launch
    np.testing.assert_array_equal(got, np.stack([-oracle.edit_distances(qi, s) for qi in q]))


@pytest.mark.parametrize("case,match", [
    ("eq-dtype", "int32"),
    ("eq-planes", r"\(5, W, S\)"),
    ("queries-rank", r"\(Q, m\)"),
    ("read-len", "31-bit words"),
    ("word-bits", "word_bits"),
    ("device", "no myers_global for device"),
])
def test_wrapper_shape_and_type_errors(case, match):
    # the wrapper has no word_bits argument (31-bit words only): JAX's is refused
    eq = torch.zeros((5, 2, 8), dtype=torch.int32)
    q = torch.zeros((1, 4), dtype=torch.int32)
    kw = dict(read_len=40)
    if case == "eq-dtype":
        eq = eq.long()
    elif case == "eq-planes":
        eq = eq[:4]
    elif case == "queries-rank":
        q = q[0]
    elif case == "read-len":
        kw["read_len"] = 70
    elif case == "word-bits":
        kw["word_bits"] = 32
    elif case == "device":
        eq = eq.to("meta")
    with pytest.raises(TypeError if case == "word-bits" else ValueError, match=match):
        mp.myers_global(eq, q, **kw)


@pytest.mark.parametrize("word_bits", [20, 32])
def test_other_word_sizes_refused_where_bgsa_tpu_scores_wrong(word_bits):
    # bgsa_tpu's myers_global takes any word_bits, but its carries are right
    # for 31 only: with other sizes hp >> word_bits is not a 0/1 bit (20) or
    # the add's carry is lost (32), and multiword scores go wrong. The port
    # has no word_bits argument: its words are 31 bits.
    q, s = inputs(7, 2, 40, 40)
    q[q == 4], s[s == 4] = 0, 0
    want = np.stack([-oracle.edit_distances(qi, s) for qi in q])
    got = np.asarray(myers_xla.myers_global(jax_pack.pack_eq(s, word_bits), q, read_len=40,
                                            word_bits=word_bits))
    assert (got != want).any()
    eq = pack.eq_from_numpy(jax_pack.pack_eq(s, word_bits))
    with pytest.raises(TypeError, match="word_bits"):
        mp.myers_global(eq, torch.from_numpy(q), read_len=40, word_bits=word_bits)
