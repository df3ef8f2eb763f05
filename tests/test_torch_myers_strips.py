"""The plain models of the two Myers strip kernels against the plain
versions, bgsa_tpu and the oracle.

``ops.myers_semiglobal.myers_strip_ref`` and ``ops.myers_pallas.
myers_global_strip_ref`` run the words in strips of ``strip`` words, one
strip after another over every column, with each column's carries passed
between strips packed 32 columns to a word, as the CUDA strip kernels do
past their register bound. Here the strips are 1 to 4 words wide at W = 3
to 9 (so the last strip is often narrower), the queries cross 32 and 64
columns (one, two and three carry words), both modes and factor -1 and +1,
N codes in subjects and queries, query codes 5 and above (which match
nothing), and ragged subject counts. The JAX twins run on the CPU as
bgsa_tpu's own tests run them: the XLA scans, and the Pallas kernels in
interpret mode (S = 128, their lane multiple). Integer scores: every
comparison is exact. The launchers' rule for the wavefront schedule
(``strip_wave``) and their CPU dispatch past the register bound are pinned
too.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu import oracle
from bgsa_tpu import pack as jax_pack
from bgsa_tpu.ops import myers_pallas as jax_mp
from bgsa_tpu.ops import myers_semiglobal as jax_sg
from bgsa_tpu.ops import myers_xla
from bgsa_tpu.schemes import Mode
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.ops import myers_pallas as mp
from bgsa_tpu_torch.ops import myers_semiglobal as sg

STRIPS = [1, 2, 3, 4]
# (n, m): W = 3, 5, 7, 9 full words / 3, 5, 7, 9 31-bit words (n = 9 x 31
# fills its last word); m = 33, 64 and 70 carry words 2, 2 and 3
FULL = [(70, 33), (129, 70), (200, 64), (288, 70)]
BITS31 = [(70, 70), (125, 33), (200, 64), (279, 70)]
MODES = [(True, -1), (False, 1), (True, 1), (False, -1)]


def inputs(seed, Q, m, n, S, *, high_codes=False):
    """ACGT with 3 % N in subjects and queries, an all-ones carry chain (a
    subject equal to the query's prefix, one of one base), and with
    ``high_codes`` query codes 5 and 6."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n)).astype(np.int32)
    s[rng.random((S, n)) < 0.03] = 4
    q[rng.random((Q, m)) < 0.03] = 4
    s[0, :min(m, n)] = q[0, :min(m, n)]
    s[1] = 2
    if high_codes:
        q[rng.random((Q, m)) < 0.05] = 5
        q[:, -1] = 6
    return q, s


def eq_words(s, word_bits):
    return pack.eq_from_numpy(jax_pack.pack_eq(s, word_bits))


@pytest.mark.parametrize("strip", STRIPS)
@pytest.mark.parametrize("case", range(len(FULL) * 2))
def test_full_word_strips_match_plain(case, strip):
    (n, m), (is_global, factor) = FULL[case % len(FULL)], MODES[case // len(FULL) * 2 + case % 2]
    q, s = inputs(case, 3, m, n, 37)
    eq, qt = eq_words(s, 32), torch.from_numpy(q)
    assert eq.shape[1] in (3, 5, 7, 9)
    got = sg.myers_strip_ref(eq, qt, read_len=n, factor=factor, is_global=is_global, strip=strip)
    want = sg.myers_semiglobal_ref(eq, qt, read_len=n, factor=factor, is_global=is_global)
    assert torch.equal(got, want)


@pytest.mark.parametrize("strip", STRIPS)
@pytest.mark.parametrize("case", range(len(BITS31) * 2))
def test_31bit_strips_match_plain(case, strip):
    n, m = BITS31[case % len(BITS31)]
    factor = (-1, 1)[case // len(BITS31)]
    q, s = inputs(100 + case, 3, m, n, 37)
    eq, qt = eq_words(s, 31), torch.from_numpy(q)
    assert eq.shape[1] in (3, 5, 7, 9)
    got = mp.myers_global_strip_ref(eq, qt, read_len=n, factor=factor, strip=strip)
    assert torch.equal(got, mp.myers_global_ref(eq, qt, read_len=n, factor=factor))


# (index into FULL, strip, mode index): a ragged last strip in each
JAX_FULL = [(0, 2, 0), (1, 2, 1), (2, 3, 2), (3, 4, 3)]


@pytest.mark.parametrize("i,strip,mode", JAX_FULL)
def test_full_word_strips_match_xla(i, strip, mode):
    (n, m), (is_global, factor) = FULL[i], MODES[mode]
    q, s = inputs(200 + i, 2, m, n, 128)
    got = sg.myers_strip_ref(eq_words(s, 32), torch.from_numpy(q), read_len=n, factor=factor,
                             is_global=is_global, strip=strip)
    want = jax_sg.myers_semiglobal_xla(jax_pack.pack_eq(s, 32), q, read_len=n, factor=factor,
                                       is_global=is_global)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("i,strip,mode", JAX_FULL)
def test_full_word_strips_match_pallas_interpret(i, strip, mode):
    (n, m), (is_global, factor) = FULL[i], MODES[mode]
    q, s = inputs(300 + i, 2, m, n, 128)
    got = sg.myers_strip_ref(eq_words(s, 32), torch.from_numpy(q), read_len=n, factor=factor,
                             is_global=is_global, strip=strip)
    want = jax_sg.myers_semiglobal(jax_pack.pack_eq(s, 32), q, read_len=n, factor=factor,
                                   is_global=is_global, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


JAX_31 = [(0, 2, -1), (1, 2, 1), (2, 3, -1), (3, 4, 1)]


@pytest.mark.parametrize("i,strip,factor", JAX_31)
def test_31bit_strips_match_xla(i, strip, factor):
    n, m = BITS31[i]
    q, s = inputs(400 + i, 2, m, n, 128)
    got = mp.myers_global_strip_ref(eq_words(s, 31), torch.from_numpy(q), read_len=n,
                                    factor=factor, strip=strip)
    want = myers_xla.myers_global(jax_pack.pack_eq(s, 31), q, read_len=n, factor=factor,
                                  word_bits=31)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("i,strip,factor", JAX_31)
def test_31bit_strips_match_pallas_interpret(i, strip, factor):
    n, m = BITS31[i]
    q, s = inputs(500 + i, 2, m, n, 128)
    got = mp.myers_global_strip_ref(eq_words(s, 31), torch.from_numpy(q), read_len=n,
                                    factor=factor, strip=strip)
    want = jax_mp.myers_global(jax_pack.pack_eq(s, 31), q, read_len=n, factor=factor,
                               interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def oracle_scores(q, s, mode):
    """Unit-cost distances by the numpy oracle; a query code 5 or 6 matches
    no subject code (0..4), as the kernels treat it."""
    return np.stack([oracle.edit_distances(qi, s, mode) for qi in q])


@pytest.mark.parametrize("strip", [1, 3])
@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.SEMI_GLOBAL])
@pytest.mark.parametrize("i", [0, 1])
def test_full_word_strips_match_oracle_with_high_codes(i, mode, strip):
    n, m = FULL[i]
    q, s = inputs(600 + i, 3, m, n, 19, high_codes=True)
    got = sg.myers_strip_ref(eq_words(s, 32), torch.from_numpy(q), read_len=n, factor=1,
                             is_global=mode is Mode.GLOBAL, strip=strip)
    np.testing.assert_array_equal(got.numpy(), oracle_scores(q, s, mode))


@pytest.mark.parametrize("strip", [1, 3])
@pytest.mark.parametrize("i", [0, 1])
def test_31bit_strips_match_oracle_with_high_codes(i, strip):
    n, m = BITS31[i]
    q, s = inputs(700 + i, 3, m, n, 19, high_codes=True)
    got = mp.myers_global_strip_ref(eq_words(s, 31), torch.from_numpy(q), read_len=n,
                                    strip=strip)
    np.testing.assert_array_equal(got.numpy(), -oracle_scores(q, s, Mode.GLOBAL))


@pytest.mark.parametrize("m", [1, 31, 32, 33, 64, 65])
def test_carry_words_per_32_columns(m):
    assert sg.carry_words(m) == -(-m // 32) and mp.carry_words is sg.carry_words


@pytest.mark.parametrize("strip", [3, 9, 32])
def test_one_strip_or_wider_is_the_plain_version(strip):
    # a strip as wide as W or wider: no carries pass, the register schedule
    n, m = FULL[3]
    q, s = inputs(800 + strip, 2, m, n, 5)
    eq, qt = eq_words(s, 32), torch.from_numpy(q)
    assert eq.shape[1] == 9
    got = sg.myers_strip_ref(eq, qt, read_len=n, is_global=True, strip=strip)
    assert torch.equal(got, sg.myers_semiglobal_ref(eq, qt, read_len=n, is_global=True))


@pytest.mark.parametrize("Q,S,m,want", [
    (20, 5632, 1000, False),    # a 5 kbp bucket: 3,520 groups of 32 subjects, 26.7 an SM
    (20, 2816, 1000, False),    # 10 kbp: 13.3 an SM
    (20, 1408, 1000, True),     # 20 kbp: 6.7 an SM
    (20, 640, 1000, True),      # 40 kbp: 3.0 an SM
    (40, 32768, 500, False),    # the card-filling shape
    (33, 1024, 1000, False),    # 1,056 groups: eight an SM
    (33, 992, 1000, True),      # 1,023 groups: fewer
    (3, 300, 97, True),         # four batches of columns
    (3, 300, 96, False),        # three: fewer than the wavefront's warps
])
def test_strip_wave_on_few_pairs_and_four_batches(Q, S, m, want):
    assert sg.strip_wave(Q, S, m, 132) is want  # 132 SMs: the H100 SXM


def test_wrappers_run_the_plain_versions_on_the_cpu_past_the_register_bound():
    n, m = 1100, 40  # 35 full words, 36 31-bit words: past both register bounds
    q, s = inputs(900, 2, m, n, 9)
    qt = torch.from_numpy(q)
    launches = [(module.LAUNCHES, module.STRIP_LAUNCHES, module.WAVE_LAUNCHES)
                for module in (sg, mp)]
    got = sg.myers_semiglobal(eq_words(s, 32), qt, read_len=n, is_global=True)
    assert torch.equal(got, sg.myers_strip_ref(eq_words(s, 32), qt, read_len=n, is_global=True))
    got = mp.myers_global(eq_words(s, 31), qt, read_len=n)
    assert torch.equal(got, mp.myers_global_strip_ref(eq_words(s, 31), qt, read_len=n))
    assert launches == [(module.LAUNCHES, module.STRIP_LAUNCHES, module.WAVE_LAUNCHES)
                        for module in (sg, mp)]
