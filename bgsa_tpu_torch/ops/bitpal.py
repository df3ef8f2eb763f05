"""BitPAl general integer scoring (match M, mismatch I, gap G), non-packed: torch and CUDA.

Counterpart of ``bgsa_tpu/ops/bitpal.py``. Same I/O contract: ``eq`` (5, W,
S) Eq words packed to ``word_bits`` usable bits (31: reserved carry bit, the
default; 32: compare carry), held as int32 (``bgsa_tpu_torch.pack``);
``queries`` (Q, m) codes 0..4; the result is (Q, S) int32, ``factor`` times
the score. The state is one indicator plane per vertical-delta value v in
[G, M - G] (M - 2G + 1 planes); the global score is G*m plus the weighted
popcount of the final column, the semi-global score the best prefix of a
bit-serial walk down it.

``bitpal_ref`` is the plain torch version: the JAX column network
(``_bitpal_column``) line for line, with the queries axis as a batch
dimension. int32 words change the meaning of three uint32 operations, and
each is rewritten here: right shifts are masked (int32 shifts are
arithmetic; in the 31-bit layout ``a + b + carry`` can reach 2^32 - 1 and
wraps negative), the compare carry compares unsigned (both sides ``^
INT32_MIN``), and popcount is SWAR (torch has none). ``bitpal`` dispatches
on the tensor's device: the plain version for a CPU tensor, the
hand-written kernel (``csrc/bitpal.cu``, built per scheme) for a CUDA
tensor, counting launches in ``LAUNCHES``. Nothing is routed to the plain
version on the card.

Past the register bound the kernel runs word-major over tiles of query
columns and passes each column's cross-word carries to the next word in
packed words. ``word_major_ref`` is that order in plain torch (over either
network: ``UnpackedNet`` here, ``bitpal_packed.PackedNet``), with the
carries packed by ``pack_carries`` in the kernel's bit order
(``carry_layout``); it is used by the tests and ``chip_smoke.py``, never on
the main path.

``BitpalParams`` is redefined here: ``bgsa_tpu.ops.bitpal`` imports jax.
"""

from __future__ import annotations

import dataclasses

import torch

from ..pack import CHAR_NUM, word_count

WORD_BITS = 31
INT32_MIN = -(1 << 31)

# Kernel launches made by ``bitpal`` (CUDA tensors only).
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class BitpalParams:
    match: int
    mismatch: int
    gap: int

    def __post_init__(self):
        if not (self.match > self.mismatch > 2 * self.gap):
            raise ValueError(
                f"BitPAl requires M > I > 2G, got ({self.match},{self.mismatch},{self.gap})"
            )

    @property
    def minv(self) -> int:  # lowest delta value = G
        return self.gap

    @property
    def maxv(self) -> int:  # highest delta value = M - G
        return self.match - self.gap

    @property
    def midv(self) -> int:  # mismatch class = I - G
        return self.mismatch - self.gap

    @property
    def max_sub_mid(self) -> int:
        return self.maxv - self.midv

    @property
    def values(self):
        return range(self.minv, self.maxv + 1)


def word_mask(word_bits: int) -> int:
    """The int32 whose bits are a word's ``word_bits`` usable bits."""
    return -1 if word_bits == 32 else (1 << word_bits) - 1


def bit(x: torch.Tensor, b: int) -> torch.Tensor:
    """Bit b (0..31) of int32 words, as 0/1."""
    return (x >> b) & 1


def add_carry(a, b, cin, word_bits: int):
    """(a + b + cin, carry-out) of ``word_bits``-bit words: the reserved bit 31
    in the 31-bit layout, unsigned compares in the 32-bit one (the partial
    adds cannot both wrap, so OR of the compares is exact)."""
    if word_bits == 32:
        s1 = a + b
        s = s1 + cin
        carry = ((s1 ^ INT32_MIN) < (a ^ INT32_MIN)) | ((s ^ INT32_MIN) < (s1 ^ INT32_MIN))
        return s, carry.to(torch.int32)
    s = a + b + cin
    return s, bit(s, word_bits)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR; every mask drops the sign copies
    that the arithmetic shifts bring in)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _bitpal_word(dh, matches, carry, p: BitpalParams, word_bits: int = WORD_BITS):
    """One word of one query column (the loop body of
    ``bgsa_tpu.ops.bitpal._bitpal_column``).

    dh: value -> the word's (Q, S) int32 indicator plane at the previous
    column; matches: the word's (Q, S) match words for the column's
    characters; carry: the cross-word carries from the word below,
    (``"add"``, key) and (``"prev"``, value) -> 0/1 words (a missing one is
    zero). Returns (the new planes dict, the carries out to the word above).
    """
    minv, midv, maxv = p.minv, p.midv, p.maxv
    CM = word_mask(word_bits)
    zeros = torch.zeros_like(matches)
    out = {}

    def add3(a, b, key):
        s, out[("add", key)] = add_carry(a, b, carry.get(("add", key), zeros), word_bits)
        return s

    def prevbit(v):
        return carry.get(("prev", v), zeros)

    not_matches = ~matches

    # ---- Phase A: horizontal-delta ("dv_shift") indicators ----
    dv_shift = {}
    dvsnm = {}  # dv_<v>_shift & not_matches
    init_max = dh[minv] & matches
    s = add3(init_max, dh[minv], 0)
    dv_shift[maxv] = (s ^ dh[minv] ^ init_max) & CM
    remain = (init_max & CM) ^ dh[minv]
    dv_max_or_match = dv_shift[maxv] | matches

    oi = 1
    for i in range(maxv - 1, midv, -1):
        cnt = minv + (maxv - i)
        init_i = dh[cnt] & dv_max_or_match
        for x in range(1, maxv - i):
            init_i = init_i | (dh[cnt - x] & dvsnm[maxv - x])
        # the bit that leaves the word on the one-row shift
        init_val = ((init_i << 1) | prevbit(i)) & CM
        out[("prev", i)] = bit(init_i, word_bits - 1)
        s = add3(init_val, remain, oi)
        dv_shift[i] = s ^ remain
        dvsnm[i] = dv_shift[i] & not_matches
        oi += 1

    acc = dv_max_or_match
    for i in range(maxv - 1, midv, -1):
        acc = acc | dv_shift[i]
    dv_not_hi = ~acc

    index = minv + p.match - p.mismatch
    for i in range(midv, minv, -1):
        init_i = dh[index] & dv_max_or_match
        dhi = index - 1
        for j in range(maxv - 1, midv, -1):
            init_i = init_i | (dh[dhi] & dvsnm[j])
            dhi -= 1
        init_i = init_i | (dh[dhi] & dv_not_hi)
        dv_shift[i] = (init_i << 1) | prevbit(i)
        out[("prev", i)] = bit(init_i, word_bits - 1)
        index += 1

    acc = dv_shift[maxv]
    for i in range(maxv - 1, minv, -1):
        acc = acc | dv_shift[i]
    dv_shift[minv] = ~acc

    # ---- Phase B: new vertical-delta planes ----
    dh = dict(dh)
    for i in range(midv + 1, maxv):
        dh[i] = dh[i] & not_matches
    dh_max_or_match = dh[maxv] | matches
    acc = dh_max_or_match
    for i in range(maxv - 1, midv, -1):
        acc = acc | dh[i]
    dh_lo_mask = ~acc

    new = {}
    index = maxv - 1
    for i in range(minv + 1, midv + 1):
        t1 = dv_shift[index] & dh_max_or_match
        dhi = maxv - 1
        for j in range(1, p.max_sub_mid):
            t1 = t1 | (dv_shift[index - j] & dh[dhi])
            dhi -= 1
        new[i] = t1 | (dv_shift[index - p.max_sub_mid] & dh_lo_mask)
        index -= 1

    value = p.max_sub_mid
    for i in range(midv + 1, maxv + 1):
        t1 = dv_shift[index] & dh_max_or_match
        dhi = maxv - 1
        for j in range(1, value):
            t1 = t1 | (dv_shift[index - j] & dh[dhi])
            dhi -= 1
        new[i] = t1
        value -= 1
        index -= 1

    acc = new[maxv]
    for i in range(maxv - 1, minv, -1):
        acc = acc | new[i]
    new[minv] = (~acc) & CM
    return new, out


def _bitpal_column(planes, matches_w, p: BitpalParams, word_bits: int = WORD_BITS):
    """One query column over all words (``bgsa_tpu.ops.bitpal._bitpal_column``).

    planes: dict value -> list of per-word (Q, S) int32 indicator planes;
    matches_w: list of per-word (Q, S) match words for the column's
    characters. Returns the new planes dict. The carries start at zero and
    pass from each word to the next.
    """
    out = {v: [] for v in p.values}
    carry = {}
    for w, matches in enumerate(matches_w):
        new, carry = _bitpal_word({v: planes[v][w] for v in p.values}, matches, carry, p,
                                  word_bits)
        for v in p.values:
            out[v].append(new[v])
    return out


# -- the cross-word carries, packed as the tiled kernel passes them ------------

def carry_layout(p: BitpalParams, packed: bool = False) -> list:
    """The carries a word passes to the next, in the order of their bits in
    the packed carry words (each Net's ``each_carry`` in ``csrc``): the
    run-propagation add carries (``"add"``, key), then the one-row shift
    carries the network reads (``"prev"``, value): of the values
    minv+1 .. maxv-1, or for the packed network midv+1 .. maxv-1 followed by
    its sum planes' row carries (``"row"``, plane)."""
    adds = [("add", key) for key in range(p.maxv - p.midv)]
    if not packed:
        return adds + [("prev", v) for v in range(p.minv + 1, p.maxv)]
    nbits = max((p.maxv - p.minv).bit_length() + 1, 2)
    return (adds + [("prev", v) for v in range(p.midv + 1, p.maxv)]
            + [("row", i) for i in range(nbits - 1)])


def carry_words(layout) -> int:
    """int32 words that hold a layout's carry bits."""
    return -(-len(layout) // 32)


def pack_carries(carries: dict, layout) -> list:
    """0/1 carries (key -> (Q, S) int32; a missing one is zero) -> the packed
    carry words, carry i of ``layout`` at bit i % 32 of word i // 32."""
    like = next(iter(carries.values()), None)
    words = []
    for w in range(carry_words(layout)):
        acc = 0
        for i, key in enumerate(layout[32 * w:32 * (w + 1)]):
            if key in carries:
                acc = acc | (carries[key].long() << i)
        if isinstance(acc, int):
            acc = torch.zeros((), dtype=torch.long) if like is None else torch.zeros_like(
                like, dtype=torch.long)
        words.append((acc & 0xFFFFFFFF).to(torch.int32))
    return words


def unpack_carries(words, layout) -> dict:
    """The packed carry words -> key -> 0/1 (Q, S) int32 carries."""
    return {key: bit(words[i // 32], i % 32) for i, key in enumerate(layout)}


def valid_masks(read_len: int, W: int, word_bits: int = WORD_BITS) -> list[int]:
    """Per word, the int32 mask of the bits that hold subject rows."""
    masks = []
    for w in range(W):
        bits = min(read_len - w * word_bits, word_bits)
        masks.append(-1 if bits >= 32 else (1 << max(bits, 0)) - 1)
    return masks


def _global_score(planes, p: BitpalParams, read_len: int, q_len: int, factor: int,
                  word_bits: int = WORD_BITS):
    """S[n][m] = G*m + sum of final-column vertical deltas (weighted popcount)."""
    masks = valid_masks(read_len, len(planes[p.minv]), word_bits)
    score = torch.full_like(planes[p.minv][0], p.gap * q_len)
    for v in p.values:
        if v == 0:
            continue
        cnt = sum(popcount(word & mask) for word, mask in zip(planes[v], masks))
        score = score + v * cnt
    return score * factor


def _semiglobal_score(planes, p: BitpalParams, read_len: int, q_len: int, factor: int,
                      word_bits: int = WORD_BITS):
    """max over subject prefixes: bit-serial walk down the final column."""
    score = torch.full_like(planes[p.minv][0], p.gap * q_len)
    best = score
    for w in range(len(planes[p.minv])):
        bits = min(read_len - w * word_bits, word_bits)
        for b in range(max(bits, 0)):
            delta = torch.zeros_like(score)
            for v in p.values:
                if v != 0:
                    delta = delta + v * bit(planes[v][w], b)
            score = score + delta
            best = torch.maximum(best, score)
    return best * factor


def _init_planes(p: BitpalParams, like: torch.Tensor, W: int, semi_global: bool,
                 word_bits: int = WORD_BITS):
    boundary = 0 if semi_global else p.minv
    CM = word_mask(word_bits)
    return {v: [torch.full_like(like, CM if v == boundary else 0)] * W for v in p.values}


def _check(eq, queries, read_len: int, word_bits: int) -> None:
    C, W, _ = eq.shape
    if C != CHAR_NUM or eq.dtype != torch.int32:
        raise ValueError(f"eq must be ({CHAR_NUM}, W, S) int32, got {tuple(eq.shape)} {eq.dtype}")
    if queries.dim() != 2:
        raise ValueError(f"queries must be (Q, m), got {tuple(queries.shape)}")
    if word_bits not in (31, 32):
        raise ValueError(f"word_bits must be 31 or 32, got {word_bits}")
    if word_count(read_len, word_bits) != W:
        raise ValueError(f"read_len {read_len} does not fill {W} {word_bits}-bit words")


def bitpal_ref(eq, queries, *, match: int, mismatch: int, gap: int, read_len: int,
               factor: int = 1, semi_global: bool = False, word_bits: int = WORD_BITS):
    """Plain torch version. eq (5, W, S) int32, queries (Q, m) -> (Q, S) int32."""
    p = BitpalParams(match, mismatch, gap)
    _, W, S = eq.shape
    Q, m = queries.shape
    q = queries.to(device=eq.device, dtype=torch.long)
    like = torch.zeros((Q, S), dtype=torch.int32, device=eq.device)
    planes = _init_planes(p, like, W, semi_global, word_bits)
    for i in range(m):
        eq_c = eq[q[:, i]]  # (Q, W, S)
        planes = _bitpal_column(planes, [eq_c[:, w] for w in range(W)], p, word_bits)
    if semi_global:
        return _semiglobal_score(planes, p, read_len, m, factor, word_bits)
    return _global_score(planes, p, read_len, m, factor, word_bits)


class UnpackedNet:
    """The non-packed network, one word at a time, for ``word_major_ref``:
    a word's state is its planes dict (value -> (Q, S) int32)."""

    packed = False

    def __init__(self, p: BitpalParams, word_bits: int):
        self.p, self.word_bits = p, word_bits
        self.layout = carry_layout(p)

    def init(self, like, semi_global: bool):
        return {v: planes[0] for v, planes in
                _init_planes(self.p, like, 1, semi_global, self.word_bits).items()}

    def word(self, planes, matches, carry):
        return _bitpal_word(planes, matches, carry, self.p, self.word_bits)

    def global_base(self, q_len: int, read_len: int) -> int:
        return self.p.gap * q_len

    def word_score(self, planes, mask: int):
        return sum(v * popcount(planes[v] & mask) for v in self.p.values if v != 0)

    def row_delta(self, planes, b: int):
        return sum(v * bit(planes[v], b) for v in self.p.values if v != 0)


def word_major_ref(net, eq, queries, *, read_len: int, factor: int = 1,
                   semi_global: bool = False, tile: int):
    """The tiled kernel's loop order in plain torch (``csrc/bitpal_common.cuh``
    ``bitpal_tiled_kernel``), for ``net`` (``UnpackedNet`` or
    ``bitpal_packed.PackedNet``): over tiles of ``tile`` query columns, words
    in order, each word's planes kept across the tile's columns (and from one
    tile to the next), each column's carries read from and written to its
    packed carry words (``pack_carries``, word 0 reading zeros), the
    epilogue folded into the last tile's word loop. Scores equal the
    column-major plain versions bit for bit."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    _, W, S = eq.shape
    Q, m = queries.shape
    q = queries.to(device=eq.device, dtype=torch.long)
    like = torch.zeros((Q, S), dtype=torch.int32, device=eq.device)
    masks = valid_masks(read_len, W, net.word_bits)
    score = torch.full_like(like, net.p.gap * m if semi_global else net.global_base(m, read_len))
    best = score
    tiles = max(1, -(-m // tile))
    state = [None] * W  # the scratch: each word's planes between tiles
    for k in range(tiles):
        columns = range(k * tile, min(m, (k + 1) * tile))
        slots = {c: pack_carries({}, net.layout) for c in columns}
        for w in range(W):
            planes = net.init(like, semi_global) if k == 0 else state[w]
            for c in columns:
                matches = eq[q[:, c], w]  # (Q, S)
                planes, carry = net.word(planes, matches, unpack_carries(slots[c], net.layout))
                slots[c] = pack_carries(carry, net.layout)
            if k + 1 < tiles:
                state[w] = planes
            elif semi_global:
                for b in range(max(min(read_len - w * net.word_bits, net.word_bits), 0)):
                    score = score + net.row_delta(planes, b)
                    best = torch.maximum(best, score)
            else:
                score = score + net.word_score(planes, masks[w])
    return (best if semi_global else score) * factor


def bitpal_tiled_ref(eq, queries, *, match: int, mismatch: int, gap: int, read_len: int,
                     factor: int = 1, semi_global: bool = False, word_bits: int = WORD_BITS,
                     tile: int = 32):
    """``bitpal_ref``'s scores in the tiled kernel's word-major order
    (``word_major_ref``). eq (5, W, S) int32, queries (Q, m) -> (Q, S) int32."""
    net = UnpackedNet(BitpalParams(match, mismatch, gap), word_bits)
    return word_major_ref(net, eq, queries, read_len=read_len, factor=factor,
                          semi_global=semi_global, tile=tile)


def bitpal(eq, queries, *, match: int, mismatch: int, gap: int, read_len: int,
           factor: int = 1, semi_global: bool = False, word_bits: int = WORD_BITS):
    """(5, W, S) int32 Eq words x (Q, m) query codes -> (Q, S) int32 scores.

    CPU tensors run the plain version; CUDA tensors launch the scheme's
    kernel (built on first use, and raising if it cannot build or launch).
    Query codes outside 0..4 match nothing in the kernel.
    """
    p = BitpalParams(match, mismatch, gap)
    _check(eq, queries, read_len, word_bits)
    kw = dict(read_len=read_len, factor=factor, semi_global=semi_global, word_bits=word_bits)
    if eq.device.type == "cpu":
        return bitpal_ref(eq, queries, match=match, mismatch=mismatch, gap=gap, **kw)
    if eq.device.type != "cuda":
        raise ValueError(f"no bitpal for device {eq.device}")
    out = launch("bitpal", p, len(p.values), eq, queries, **kw)
    global LAUNCHES
    LAUNCHES += 1
    return out


def launch(kernel: str, p: BitpalParams, planes: int, eq, queries, *, read_len, factor,
           semi_global, word_bits):
    """Launch the BitPAl kernel ``kernel`` ("bitpal" or "bitpal_packed") of
    scheme ``p`` on CUDA tensors. Its state of ``planes`` planes per word
    lives in registers up to the library's ``reg_words`` words; past it the
    tiled kernel holds one word's planes, and keeps them between tiles in a
    (planes, W, Q, S) device scratch allocated here when the query spans
    more than one tile."""
    from . import build

    kernels = build.load_scheme(kernel, p.match, p.mismatch, p.gap)
    _, W, S = eq.shape
    Q, m = queries.shape
    eq = eq.contiguous()
    q = queries.to(device=eq.device, dtype=torch.uint8).contiguous()
    out = torch.empty((Q, S), dtype=torch.int32, device=eq.device)
    if Q == 0 or S == 0:
        return out
    scratch = None
    if W > kernels.reg_words and m > kernels.tile_columns:
        scratch = torch.empty((planes, W, Q, S), dtype=torch.int32, device=eq.device)
    with torch.cuda.device(eq.device):
        stream = torch.cuda.current_stream(eq.device).cuda_stream
        rc = getattr(kernels.lib, f"bgsa_{kernel}")(
            eq.data_ptr(), q.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            Q, m, W, S, read_len, factor, int(semi_global), word_bits, stream,
        )
    kernels.check(rc, kernel)
    return out

