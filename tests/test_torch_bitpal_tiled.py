"""The word-major plain model of BitPAl's tiled kernel, on the CPU.

Past the register bound the CUDA kernel (``csrc/bitpal_common.cuh``
``bitpal_tiled_kernel``) runs word-major over tiles of query columns and
passes each column's cross-word carries to the next word in packed words.
``word_major_ref`` runs that order in plain torch with the same packed
carry words; here it must equal the column-major plain versions
(``bitpal_ref``, ``bitpal_packed_ref``) and the JAX package's XLA twins bit
for bit (tolerance 0: integer scores) on inputs made from a numpy seed,
with N codes. The JAX twins compile for minutes at 500 bp on wide schemes,
so they meet the model on a rotated subset; the plain versions, which the
other BitPAl tests hold to the twins, meet it on the whole grid.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu import pack as host_pack
from bgsa_tpu.ops import bitpal as jax_bitpal
from bgsa_tpu.ops import bitpal_packed as jax_packed
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.ops import bitpal as tb
from bgsa_tpu_torch.ops import bitpal_packed as tbp

# chip_smoke.py's BITPAL_SCHEMES: the bench scheme, small and zero-match
# lattices, an unpacked-only scheme, and the wide (5,-4,-11) and (5,-4,-10)
# (26 planes; its carries take two words, as (5,-4,-11)'s do)
SCHEMES = [(2, -3, -5), (1, -1, -1), (0, -2, -3), (5, -1, -2), (5, -4, -11), (5, -4, -10)]
LENGTHS = [1, 31, 32, 33, 150, 500]
TILES = [1, 7, 32, None]  # None: the whole query in one tile (T = m)
# (word_bits, semi_global) pairs; each case takes one pair of them, so both
# layouts and both modes meet every scheme
COMBOS = [((31, False), (32, True)), ((31, True), (32, False))]


def codes(rng, shape, n_rate=0.05):
    c = rng.integers(0, 4, size=shape).astype(np.int32)
    c[rng.random(shape) < n_rate] = 4
    return c


def models(M, I, G):
    """(name, column-major plain version, word-major model, JAX XLA twin)."""
    out = [("unpacked", tb.bitpal_ref, tb.bitpal_tiled_ref, jax_bitpal.bitpal_xla)]
    if tbp.packed_supported(tb.BitpalParams(M, I, G)):
        out.append(("packed", tbp.bitpal_packed_ref, tbp.bitpal_packed_tiled_ref,
                    jax_packed.bitpal_packed_xla))
    return out


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("M,I,G", SCHEMES)
def test_word_major_model_matches_plain(M, I, G, n):
    # every tile size: one column a tile, a ragged last tile (7), a tile
    # wider than the query (32), the whole query (m)
    rng = np.random.default_rng(1000 * abs(M + I + G) + n)
    m = 40 if n <= 33 else 8
    q = torch.from_numpy(codes(rng, (2, m)))
    s = codes(rng, (5, n))
    s[0, :min(n, m)] = q[0, :min(n, m)].numpy()  # a long run of matches
    for word_bits, semi in COMBOS[(SCHEMES.index((M, I, G)) + LENGTHS.index(n)) % 2]:
        eq = pack.eq_from_numpy(host_pack.pack_eq(s, word_bits))
        kw = dict(match=M, mismatch=I, gap=G, read_len=n, factor=2, semi_global=semi,
                  word_bits=word_bits)
        for name, ref, model, _ in models(M, I, G):
            want = ref(eq, q, **kw)
            for tile in sorted({min(t or m, m) for t in TILES}):  # m <= 32: 32 runs as m
                got = model(eq, q, tile=tile, **kw)
                assert torch.equal(got, want), (name, word_bits, semi, tile)


# (scheme, n): each scheme once at W <= 2 words, and 150 and 500 bp on a
# scheme whose twins compile in seconds
XLA_CASES = [((2, -3, -5), 33), ((1, -1, -1), 31), ((0, -2, -3), 32), ((5, -1, -2), 1),
             ((5, -4, -11), 33), ((5, -4, -10), 31), ((1, -1, -1), 150), ((1, -1, -1), 500)]


@pytest.mark.parametrize("scheme,n", XLA_CASES)
def test_word_major_model_matches_xla(scheme, n):
    M, I, G = scheme
    rng = np.random.default_rng(7 * n + M)
    q, s = codes(rng, (2, 9)), codes(rng, (5, n))
    case = XLA_CASES.index((scheme, n))
    word_bits, semi = COMBOS[case % 2][case // 2 % 2]
    eq = host_pack.pack_eq(s, word_bits)
    kw = dict(match=M, mismatch=I, gap=G, read_len=n, semi_global=semi, word_bits=word_bits)
    for name, _, model, twin in models(M, I, G):
        want = np.asarray(twin(eq, q, **kw))
        got = model(pack.eq_from_numpy(eq), torch.from_numpy(q), tile=4, **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("M,I,G,packed", [
    (*scheme, packed) for scheme in SCHEMES for packed in (False, True)
    if not packed or tbp.packed_supported(tb.BitpalParams(*scheme))])
def test_carries_round_trip(M, I, G, packed):
    p = tb.BitpalParams(M, I, G)
    layout = tb.carry_layout(p, packed)
    assert len(set(layout)) == len(layout)
    # the kernel's kCarryBits: kAdds + planes - 2, or 2 kAdds - 1 + TOP packed
    adds = p.maxv - p.midv
    bits = 2 * adds - 1 + tbp._bits_num(p) - 1 if packed else adds + len(p.values) - 2
    assert len(layout) == bits
    rng = np.random.default_rng(len(layout))
    carries = {key: torch.from_numpy(rng.integers(0, 2, size=(3, 4)).astype(np.int32))
               for key in layout}
    words = tb.pack_carries(carries, layout)
    assert len(words) == tb.carry_words(layout) == -(-bits // 32)
    assert all(w.dtype == torch.int32 and w.shape == (3, 4) for w in words)
    back = tb.unpack_carries(words, layout)
    assert back.keys() == carries.keys()
    assert all(torch.equal(back[key], carries[key]) for key in layout)
    # a missing carry packs as zero
    assert all(int(w.abs().sum()) == 0 for w in tb.pack_carries({}, layout))


def test_carries_pass_32_bits_on_the_wide_schemes():
    # (5,-4,-10): 9 add and 24 shift carries, 33 bits: two words, bit 32 in
    # the second; bit 31 sets the first word's sign
    layout = tb.carry_layout(tb.BitpalParams(5, -4, -10))
    assert len(layout) == 33 and tb.carry_words(layout) == 2
    one = torch.ones((1,), dtype=torch.int32)
    words = tb.pack_carries({layout[31]: one, layout[32]: one}, layout)
    assert int(words[0]) == -(1 << 31) and int(words[1]) == 1
    assert len(tb.carry_layout(tb.BitpalParams(5, -4, -11))) == 35


def test_tile_is_checked():
    eq = torch.zeros((5, 2, 4), dtype=torch.int32)
    q = torch.zeros((1, 3), dtype=torch.int32)
    kw = dict(match=2, mismatch=-3, gap=-5, read_len=40)
    with pytest.raises(ValueError, match="tile must be >= 1"):
        tb.bitpal_tiled_ref(eq, q, tile=0, **kw)
    with pytest.raises(ValueError, match="tile must be >= 1"):
        tbp.bitpal_packed_tiled_ref(eq, q, tile=-1, **kw)
    # the kernels' tile is their library's tile_columns: no wrapper takes one
    with pytest.raises(TypeError):
        tb.bitpal(eq, q, tile=2, **kw)
    with pytest.raises(TypeError):
        tbp.bitpal_packed(eq, q, tile=2, **kw)


@pytest.mark.parametrize("word_bits", [31, 32])
@pytest.mark.parametrize("M,I,G", [(2, -3, -5), (5, -4, -10)])
def test_word_major_model_crosses_the_kernels_tile(M, I, G, word_bits):
    # 40 columns at the kernels' 32-column tile: the planes go through the
    # scratch once, and a last tile of 8 columns folds the epilogue
    rng = np.random.default_rng(word_bits)
    q, s = torch.from_numpy(codes(rng, (2, 40))), codes(rng, (6, 70))
    eq = pack.eq_from_numpy(host_pack.pack_eq(s, word_bits))
    for semi in (False, True):
        kw = dict(match=M, mismatch=I, gap=G, read_len=70, semi_global=semi,
                  word_bits=word_bits)
        want = tb.bitpal_ref(eq, q, **kw)
        for name, _, model, _ in models(M, I, G):
            assert torch.equal(model(eq, q, tile=32, **kw), want), (name, semi)
