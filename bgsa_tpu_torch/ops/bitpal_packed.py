"""BitPAl packed representation (delta classes as bit planes): torch and CUDA.

Counterpart of ``bgsa_tpu/ops/bitpal_packed.py``. Instead of one indicator
plane per delta value, each row's delta class is stored in
``nbits = bit_length(M - 2G) + 1`` two's-complement planes (value v as
``-(v - G) mod 2^nbits``), and a column runs a class-decode network, a
plane ripple adder, a clamp, a one-row shift and a second adder. Only for
``M <= 2I - 2G + 1`` (``packed_supported``); the engine takes the
non-packed kernel elsewhere. Same I/O contract and word layouts as
``ops.bitpal``.

``bitpal_packed_ref`` is the plain torch version: ``_packed_column`` of the
JAX module line for line (its dead-plane and last-word surgery included),
with the queries axis as a batch dimension and the int32 rewrites of
``ops.bitpal`` (masked right shifts, unsigned compare carry, SWAR
popcount). ``bitpal_packed`` runs it for a CPU tensor and launches
``csrc/bitpal_packed.cu`` (built per scheme) for a CUDA tensor, counting
launches in ``LAUNCHES``.
"""

from __future__ import annotations

import torch

from .bitpal import (WORD_BITS, BitpalParams, _check, add_carry, bit, carry_layout, launch,
                     popcount, valid_masks, word_major_ref, word_mask)

# Kernel launches made by ``bitpal_packed`` (CUDA tensors only).
LAUNCHES = 0


def packed_supported(p: BitpalParams) -> bool:
    return p.match <= 2 * p.mismatch - 2 * p.gap + 1


def _bits_num(p: BitpalParams) -> int:
    # ceil(log2(maxLength + 1)) planes for the magnitude plus one for the
    # negated encoding's sign (the generator's maxBitsNum: 5 for (2,-3,-5)).
    return max((p.maxv - p.minv).bit_length() + 1, 2)


def _packed_word(dhbit, matches, carry, p: BitpalParams, nbits: int,
                 word_bits: int = WORD_BITS):
    """One word of one query column (the loop body of
    ``bgsa_tpu.ops.bitpal_packed._packed_column``).

    dhbit: the word's nbits (Q, S) int32 planes at the previous column;
    matches: its (Q, S) match words; carry: the carries from the word below,
    (``"add"``, key), (``"prev"``, value) and (``"row"``, plane) -> 0/1 words
    (a missing one is zero). Returns (the new planes, the carries out). The
    top plane of the DV encoding is identically zero and the clamp zeroes
    the top sum plane, so their ops are skipped; the column drops the last
    word's carries out, as the JAX network never computes them.
    """
    minv, midv, maxv = p.minv, p.midv, p.maxv
    CM = word_mask(word_bits)
    zeros = torch.zeros_like(matches)
    top_plane = nbits - 1
    out = {}

    def carry_in(key):
        return carry.get(key, zeros)

    not_matches = ~matches

    # Decode the phase-A class indicators: AND over the planes, msb
    # first, of the plane or its complement per the class's pattern.
    prefix_cache: dict = {}

    def chain(bits: tuple):
        if bits in prefix_cache:
            return prefix_cache[bits]
        plane = nbits - len(bits)
        term = dhbit[plane] if bits[-1] else ~dhbit[plane]
        if len(bits) > 1:
            term = chain(bits[:-1]) & term
        prefix_cache[bits] = term
        return term

    dh = {}
    for v in range(minv, minv + (maxv - midv)):
        pattern = (-(v - minv)) & ((1 << nbits) - 1)
        dh[v] = chain(tuple((pattern >> i) & 1 for i in reversed(range(nbits))))
    dh[minv] = dh[minv] & CM

    # Union of all low classes [minv, midv]: stored == 0 or stored >=
    # 2^nbits - (midv - minv), the >= as a plane comparator built lsb first.
    thresh = (1 << nbits) - (midv - minv)
    ge = None
    for i in range(nbits):
        if (thresh >> i) & 1:
            ge = dhbit[i] if ge is None else dhbit[i] & ge
        elif ge is not None:
            ge = dhbit[i] | ge
    lo_mid = (chain((0,) * nbits) | ge) & not_matches

    # Phase A: horizontal-delta classes (midv, maxv].
    dv_shift = {}
    init_max = dh[minv] & matches
    s, out[("add", 0)] = add_carry(init_max, dh[minv], carry_in(("add", 0)), word_bits)
    dv_shift[maxv] = (s ^ dh[minv] ^ init_max) & CM
    remain = dh[minv] ^ init_max
    dv_max_or_match = dv_shift[maxv] | matches

    oi = 1
    for i in range(maxv - 1, midv, -1):
        cnt = minv + (maxv - i)
        init_i = dh[cnt] & dv_max_or_match
        for x in range(1, maxv - i):
            init_i = init_i | (dh[cnt - x] & dv_shift[maxv - x])
        init_val = ((init_i << 1) | carry_in(("prev", i))) & CM
        out[("prev", i)] = bit(init_i, word_bits - 1)  # the top row bit leaves the word
        s, out[("add", oi)] = add_carry(init_val, remain, carry_in(("add", oi)), word_bits)
        dv_shift[i] = (s ^ remain) & not_matches
        oi += 1

    acc = dv_max_or_match
    for i in range(maxv - 1, midv, -1):
        acc = acc | dv_shift[i]
    dv_not_hi = ~acc

    def dv_name(v):
        if v == midv:
            return dv_not_hi
        if v == maxv:
            return dv_max_or_match
        return dv_shift[v]

    # Encode the horizontal classes into planes (mapped = v - minv); the
    # top plane is identically zero.
    dv_bit = []
    for i in range(top_plane):
        acc = None
        for v in range(midv, maxv + 1):
            if ((v - minv) >> i) & 1:
                acc = dv_name(v) if acc is None else acc | dv_name(v)
        dv_bit.append(acc if acc is not None else zeros)

    # mapped(DHin) + mapped(DV): ripple adder over the planes.
    carry_bit = dhbit[0] & dv_bit[0]
    sumbit = [dhbit[0] ^ dv_bit[0]]
    for i in range(1, top_plane):
        x = dhbit[i] ^ dv_bit[i]
        sumbit.append(x ^ carry_bit)
        carry_bit = (dhbit[i] & dv_bit[i]) | (x & carry_bit)
    sum_top = dhbit[top_plane] ^ carry_bit

    # Clamp rows whose sum overflowed, then shift one row up with
    # cross-word row carries.
    comp = ~sum_top
    shifted = []
    for i in range(top_plane):
        sb = sumbit[i] & comp
        shifted.append((sb << 1) | carry_in(("row", i)))
        out[("row", i)] = bit(sb, word_bits - 1)

    # Subtract mapped(H) at the same row: add its negation, built from
    # the mark patterns.
    comp_lo_mid = ~lo_mid
    mark1 = midv - minv - 1
    mark2 = (maxv - minv) - 1
    adj = []
    for i in range(nbits):
        b = dhbit[i]
        b = b & comp_lo_mid if (mark1 >> i) & 1 else b | lo_mid
        b = b & not_matches if (mark2 >> i) & 1 else b | matches
        adj.append(b)

    carry_bit = adj[0] & shifted[0]
    sumbit = [adj[0] ^ shifted[0]]
    for i in range(1, top_plane):
        x = adj[i] ^ shifted[i]
        sumbit.append(x ^ carry_bit)
        carry_bit = (adj[i] & shifted[i]) | (x & carry_bit)
    top = adj[top_plane] ^ carry_bit
    return [sb & top for sb in sumbit] + [top], out


def _packed_column(state_w, matches_w, p: BitpalParams, nbits: int,
                   word_bits: int = WORD_BITS):
    """One query column over all words (``bgsa_tpu.ops.bitpal_packed._packed_column``).

    state_w: per word, a list of nbits (Q, S) int32 planes; matches_w: per
    word, the (Q, S) match words. Returns the new state (same structure).
    """
    out, carry = [], {}
    for planes, matches in zip(state_w, matches_w):
        new, carry = _packed_word(planes, matches, carry, p, nbits, word_bits)
        out.append(new)
    return out


def _packed_init(p: BitpalParams, nbits: int, like: torch.Tensor, W: int, semi_global: bool,
                 word_bits: int = WORD_BITS):
    # semi-global: stored(-(0 - minv)) = minv mod 2^n; global: 0 (DV = G)
    pattern = p.minv & ((1 << nbits) - 1) if semi_global else 0
    CM = word_mask(word_bits)
    planes = [torch.full_like(like, CM if (pattern >> i) & 1 else 0) for i in range(nbits)]
    return [planes] * W


def _weight(i: int, nbits: int) -> int:
    return (1 << i) if i == nbits - 1 else -(1 << i)


def _packed_global_score(state_w, p: BitpalParams, nbits: int, read_len: int, q_len: int,
                         factor: int, word_bits: int = WORD_BITS):
    """score = G*m + sum_rows(2^top*b_top - sum_low 2^i*b_i - |G|)."""
    masks = valid_masks(read_len, len(state_w), word_bits)
    score = torch.full_like(state_w[0][0], p.gap * q_len + p.gap * read_len)
    for planes, mask in zip(state_w, masks):
        for i in range(nbits):
            score = score + _weight(i, nbits) * popcount(planes[i] & mask)
    return score * factor


def _packed_semiglobal_score(state_w, p: BitpalParams, nbits: int, read_len: int,
                             q_len: int, factor: int, word_bits: int = WORD_BITS):
    score = torch.full_like(state_w[0][0], p.gap * q_len)
    best = score
    for w, planes in enumerate(state_w):
        bits = min(read_len - w * word_bits, word_bits)
        for b in range(max(bits, 0)):
            delta = torch.full_like(score, p.gap)
            for i in range(nbits):
                delta = delta + _weight(i, nbits) * bit(planes[i], b)
            score = score + delta
            best = torch.maximum(best, score)
    return best * factor


def _packed_params(match: int, mismatch: int, gap: int) -> BitpalParams:
    p = BitpalParams(match, mismatch, gap)
    if not packed_supported(p):
        raise ValueError(f"packed BitPAl requires M <= 2I - 2G + 1, got {p}")
    return p


def bitpal_packed_ref(eq, queries, *, match: int, mismatch: int, gap: int, read_len: int,
                      factor: int = 1, semi_global: bool = False,
                      word_bits: int = WORD_BITS):
    """Plain torch version. eq (5, W, S) int32, queries (Q, m) -> (Q, S) int32."""
    p = _packed_params(match, mismatch, gap)
    nbits = _bits_num(p)
    _, W, S = eq.shape
    Q, m = queries.shape
    q = queries.to(device=eq.device, dtype=torch.long)
    like = torch.zeros((Q, S), dtype=torch.int32, device=eq.device)
    state = _packed_init(p, nbits, like, W, semi_global, word_bits)
    for i in range(m):
        eq_c = eq[q[:, i]]  # (Q, W, S)
        state = _packed_column(state, [eq_c[:, w] for w in range(W)], p, nbits, word_bits)
    if semi_global:
        return _packed_semiglobal_score(state, p, nbits, read_len, m, factor, word_bits)
    return _packed_global_score(state, p, nbits, read_len, m, factor, word_bits)


class PackedNet:
    """The packed network, one word at a time, for ``bitpal.word_major_ref``:
    a word's state is its list of nbits (Q, S) int32 planes."""

    packed = True

    def __init__(self, p: BitpalParams, word_bits: int):
        self.p, self.word_bits = p, word_bits
        self.nbits = _bits_num(p)
        self.layout = carry_layout(p, packed=True)

    def init(self, like, semi_global: bool):
        return _packed_init(self.p, self.nbits, like, 1, semi_global, self.word_bits)[0]

    def word(self, planes, matches, carry):
        return _packed_word(planes, matches, carry, self.p, self.nbits, self.word_bits)

    def global_base(self, q_len: int, read_len: int) -> int:
        return self.p.gap * q_len + self.p.gap * read_len

    def word_score(self, planes, mask: int):
        return sum(_weight(i, self.nbits) * popcount(planes[i] & mask) for i in range(self.nbits))

    def row_delta(self, planes, b: int):
        return self.p.gap + sum(_weight(i, self.nbits) * bit(planes[i], b)
                                for i in range(self.nbits))


def bitpal_packed_tiled_ref(eq, queries, *, match: int, mismatch: int, gap: int, read_len: int,
                            factor: int = 1, semi_global: bool = False,
                            word_bits: int = WORD_BITS, tile: int = 32):
    """``bitpal_packed_ref``'s scores in the tiled kernel's word-major order
    (``bitpal.word_major_ref``)."""
    net = PackedNet(_packed_params(match, mismatch, gap), word_bits)
    return word_major_ref(net, eq, queries, read_len=read_len, factor=factor,
                          semi_global=semi_global, tile=tile)


def bitpal_packed(eq, queries, *, match: int, mismatch: int, gap: int, read_len: int,
                  factor: int = 1, semi_global: bool = False, word_bits: int = WORD_BITS):
    """(5, W, S) int32 Eq words x (Q, m) query codes -> (Q, S) int32 scores.

    CPU tensors run the plain version; CUDA tensors launch the scheme's
    kernel (built on first use, and raising if it cannot build or launch).
    """
    p = _packed_params(match, mismatch, gap)
    _check(eq, queries, read_len, word_bits)
    kw = dict(read_len=read_len, factor=factor, semi_global=semi_global, word_bits=word_bits)
    if eq.device.type == "cpu":
        return bitpal_packed_ref(eq, queries, match=match, mismatch=mismatch, gap=gap, **kw)
    if eq.device.type != "cuda":
        raise ValueError(f"no bitpal_packed for device {eq.device}")
    out = launch("bitpal_packed", p, _bits_num(p), eq, queries, **kw)
    global LAUNCHES
    LAUNCHES += 1
    return out
