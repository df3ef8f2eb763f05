"""The port's BitPAl plain versions against bgsa_tpu's, on the CPU.

``bitpal_ref`` and ``bitpal_packed_ref`` (plain torch) must equal the JAX
package's XLA twins bit for bit (tolerance 0: integer scores) on the same
inputs, made from a numpy seed, with N codes in subjects and queries; on a
few small cases also the Pallas kernels in interpret mode. A wider grid of
schemes, lengths, word layouts and modes is held against the numpy oracle,
which costs no compile.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu import pack as host_pack
from bgsa_tpu.oracle import align_scores, align_scores_query_in_subject
from bgsa_tpu.ops import bitpal as jax_bitpal
from bgsa_tpu.ops import bitpal_packed as jax_packed
from bgsa_tpu.schemes import Scoring
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.ops import bitpal as tb
from bgsa_tpu_torch.ops import bitpal_packed as tbp

# tests/test_bitpal.py's SCHEMES, three more, and an unpacked-only scheme
SCHEMES = [(2, -3, -5), (1, -1, -1), (3, -1, -2), (0, -2, -3), (5, -4, -11),
           (0, -1, -3), (1, 0, -2), (0, -1, -2), (5, -1, -2)]
LENGTHS = [1, 30, 31, 32, 33, 62, 70, 96]
# (word_bits, semi_global, factor), rotated over the lengths and schemes so
# that each kernel meets every combination
COMBOS = [(31, False, 1), (32, True, 2), (31, True, 1), (32, False, 2),
          (31, False, 2), (32, True, 1), (31, True, 2), (32, False, 1)]


def codes(rng, shape, n_rate=0.05):
    c = rng.integers(0, 4, size=shape).astype(np.int32)
    c[rng.random(shape) < n_rate] = 4
    return c


def both(eq_u32, q, fn_jax, fn_torch, **kw):
    """(JAX XLA twin, port plain version) on the same inputs."""
    want = np.asarray(fn_jax(eq_u32, q, **kw))
    got = fn_torch(pack.eq_from_numpy(eq_u32), torch.from_numpy(q), **kw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    return got.numpy(), want


def kernels(M, I, G):
    """(name, JAX XLA twin, port plain version) of each kernel the scheme takes."""
    out = [("unpacked", jax_bitpal.bitpal_xla, tb.bitpal_ref)]
    if tbp.packed_supported(tb.BitpalParams(M, I, G)):
        out.append(("packed", jax_packed.bitpal_packed_xla, tbp.bitpal_packed_ref))
    return out


@pytest.mark.parametrize("n", LENGTHS)
def test_matches_xla_over_lengths(n):
    M, I, G = 2, -3, -5
    word_bits, semi, factor = COMBOS[LENGTHS.index(n)]
    rng = np.random.default_rng(n)
    q, s = codes(rng, (3, 37)), codes(rng, (9, n))
    eq = host_pack.pack_eq(s, word_bits)
    kw = dict(match=M, mismatch=I, gap=G, read_len=n, factor=factor, semi_global=semi,
              word_bits=word_bits)
    for name, fn_jax, fn_torch in kernels(M, I, G):
        got, want = both(eq, q, fn_jax, fn_torch, **kw)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} n={n}")


@pytest.mark.parametrize("M,I,G", SCHEMES)
def test_matches_xla_over_schemes(M, I, G):
    word_bits, semi, factor = COMBOS[SCHEMES.index((M, I, G)) % len(COMBOS)]
    rng = np.random.default_rng(M - 10 * I - 100 * G)
    q, s = codes(rng, (3, 29)), codes(rng, (9, 33))
    eq = host_pack.pack_eq(s, word_bits)
    kw = dict(match=M, mismatch=I, gap=G, read_len=33, factor=factor, semi_global=semi,
              word_bits=word_bits)
    for name, fn_jax, fn_torch in kernels(M, I, G):
        got, want = both(eq, q, fn_jax, fn_torch, **kw)
        np.testing.assert_array_equal(got, want, err_msg=name)


def oracle(q, s, M, I, G, semi):
    """Integer scores from the numpy DP: global, or BitPAl's semi-global
    (full query, subject ends free)."""
    if semi:
        return np.stack([align_scores_query_in_subject(qi, s, Scoring(M, I, G)) for qi in q])
    return np.stack([align_scores(qi, s, Scoring(M, I, G)) for qi in q])


@pytest.mark.parametrize("semi", [False, True], ids=["global", "semi"])
@pytest.mark.parametrize("M,I,G", SCHEMES)
def test_matches_oracle(M, I, G, semi):
    # every length, both word layouts, both kernels, factor 2 on the
    # scheme halved: (2M, 2I, 2G) scores twice (M, I, G)
    rng = np.random.default_rng(2 * abs(M + I + G) + semi)
    q = codes(rng, (2, 21))
    for n in LENGTHS:
        s = codes(rng, (5, n))
        want = oracle(q, s, 2 * M, 2 * I, 2 * G, semi)
        for word_bits in (31, 32):
            eq = pack.eq_from_numpy(host_pack.pack_eq(s, word_bits))
            kw = dict(match=M, mismatch=I, gap=G, read_len=n, factor=2, semi_global=semi,
                      word_bits=word_bits)
            for name, _, fn_torch in kernels(M, I, G):
                got = fn_torch(eq, torch.from_numpy(q), **kw).numpy()
                np.testing.assert_array_equal(got, want, err_msg=f"{name} n={n} {word_bits}")


@pytest.mark.parametrize("kernel,word_bits,semi", [
    ("unpacked", 32, False), ("unpacked", 31, True), ("packed", 31, False), ("packed", 32, True),
])
def test_matches_pallas_interpret(kernel, word_bits, semi):
    # the Pallas kernels as tests/test_bitpal.py runs them on the CPU
    M, I, G = 2, -3, -5
    rng = np.random.default_rng(word_bits + semi)
    q, s = codes(rng, (2, 12)), codes(rng, (128, 40))
    s[0, 5:17] = q[0]  # an exact hit for the semi-global walk
    eq = host_pack.pack_eq(s, word_bits)
    kw = dict(match=M, mismatch=I, gap=G, read_len=40, semi_global=semi, word_bits=word_bits)
    if kernel == "packed":
        fn_jax, fn_torch = jax_packed.bitpal_packed, tbp.bitpal_packed
    else:
        fn_jax, fn_torch = jax_bitpal.bitpal, tb.bitpal
    want = np.asarray(fn_jax(eq, q, interpret=True, **kw))
    got = fn_torch(pack.eq_from_numpy(eq), torch.from_numpy(q), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(q, s, M, I, G, semi))


@pytest.mark.parametrize("M,I,G", SCHEMES + [(1, -4, -2), (2, -3, -1), (0, 0, -1), (9, -1, -1)])
def test_scheme_rules_agree_with_jax(M, I, G):
    try:
        want = jax_bitpal.BitpalParams(M, I, G)
    except ValueError as e:
        with pytest.raises(ValueError, match="M > I > 2G") as got:
            tb.BitpalParams(M, I, G)
        assert str(got.value) == str(e)
        return
    p = tb.BitpalParams(M, I, G)
    assert (p.minv, p.midv, p.maxv, p.max_sub_mid, list(p.values)) == (
        want.minv, want.midv, want.maxv, want.max_sub_mid, list(want.values))
    assert tbp.packed_supported(p) == jax_packed.packed_supported(want)
    assert tbp._bits_num(p) == jax_packed._bits_num(want)


def test_packed_refuses_unsupported_scheme():
    eq = torch.zeros((5, 1, 4), dtype=torch.int32)
    q = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"M <= 2I - 2G \+ 1"):
        tbp.bitpal_packed(eq, q, match=5, mismatch=-1, gap=-2, read_len=10)


def test_popcount_matches_numpy():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    got = tb.popcount(torch.from_numpy(words.view(np.int32))).numpy()
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("word_bits", [31, 32])
def test_add_carry_matches_unsigned_arithmetic(word_bits):
    rng = np.random.default_rng(word_bits)
    top = 1 << word_bits
    a = rng.integers(0, top, size=4096, dtype=np.uint64)
    b = rng.integers(0, top, size=4096, dtype=np.uint64)
    cin = rng.integers(0, 2, size=4096, dtype=np.uint64)
    a[:3], b[:3], cin[:3] = top - 1, [top - 1, 0, 1], [1, 1, 0]  # carry chains
    total = a + b + cin

    def t(x):
        return torch.from_numpy((x & 0xFFFFFFFF).astype(np.uint32).view(np.int32))

    s, carry = tb.add_carry(t(a), t(b), t(cin), word_bits)
    np.testing.assert_array_equal(s.numpy().view(np.uint32), (total & 0xFFFFFFFF).astype(np.uint32))
    want = (total >> word_bits) if word_bits == 32 else (total >> 31) & 1
    np.testing.assert_array_equal(carry.numpy(), want.astype(np.int32))


def test_wrappers_check_inputs():
    eq = torch.zeros((5, 2, 4), dtype=torch.int32)
    q = torch.zeros((1, 3), dtype=torch.int32)
    kw = dict(match=2, mismatch=-3, gap=-5)
    with pytest.raises(ValueError, match="does not fill"):
        tb.bitpal(eq, q, read_len=70, **kw)  # 70 bp is 3 words of 31 bits
    with pytest.raises(ValueError, match="word_bits"):
        tb.bitpal(eq, q, read_len=40, word_bits=16, **kw)
    with pytest.raises(ValueError, match="int32"):
        tbp.bitpal_packed(eq.long(), q, read_len=40, **kw)
    with pytest.raises(ValueError, match=r"\(Q, m\)"):
        tbp.bitpal_packed(eq, q[0], read_len=40, **kw)
    with pytest.raises(ValueError, match="M > I > 2G"):
        tb.bitpal(eq, q, read_len=40, match=1, mismatch=-4, gap=-2)
