"""Symbol mapping, transport packing and Eq packing: host (numpy) and device (torch).

The host half is the port's own copy of ``bgsa_tpu.pack``'s numpy code,
same behaviour: ``encode_ascii``, the 2-bit / nibble / N-sidecar transport
packers and ``select_transport`` (with ``n_shards``, which pre-splits the
sidecar per shard), the Eq and banded packers. The numpy Eq and banded
packers are ``pack_eq_host``, ``unpack_eq_host`` and ``pack_banded_host``
here (``bgsa_tpu.pack.pack_eq``, ``unpack_eq``, ``pack_banded``), because
the bare names belong to the device half, which rebuilds symbol codes and
Eq words in torch on whatever device the packed payload was uploaded to.
The native C++ packers (``native.py``) serve the host half where they
build; every host packer has a numpy fallback.

Word type: 32-bit Eq words are held as ``torch.int32`` (torch's ``uint32``
lacks shifts, add, not and min). Bit patterns are identical to the numpy
uint32 words; ``eq_from_numpy``/``eq_to_numpy`` reinterpret between the two
without changing a bit. Right shifts of int32 are arithmetic, so every
right shift in the port is masked.
"""

from __future__ import annotations

import numpy as np
import torch

CHAR_NUM = 5  # A C G T N, as in the reference (CHAR_NUM, config.h)
PAD_CODE = 255  # matches no character plane

# Characters outside ACGTN map to 0 ('A'), matching the reference's
# zero-initialized mapping table (global.c:6-15).
MAPPING = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    MAPPING[_c] = _i
MAPPING[ord("N")] = 4


def encode_ascii(buf: np.ndarray) -> np.ndarray:
    """Map ASCII bytes (any shape) to symbol codes 0..4."""
    return MAPPING[np.asarray(buf, dtype=np.uint8)]


def word_count(length: int, word_bits: int) -> int:
    """Number of uint words covering ``length`` subject positions."""
    return -(-length // word_bits)


# -- host half (numpy) ---------------------------------------------------------


def pack_eq_host(codes: np.ndarray, word_bits: int = 31) -> np.ndarray:
    """(S, L) integer symbol codes 0..4 -> (CHAR_NUM, W, S) uint32 Eq planes:
    bit b of eq[c, w, s] is set iff codes[s, w*word_bits + b] == c
    (``word_bits``: 31 reserved-carry, 32 full)."""
    codes = np.atleast_2d(np.asarray(codes))
    from . import native

    if codes.size == 0 or (0 <= codes.min() and codes.max() <= 4):
        # The C packer indexes planes by raw code value; out-of-range codes
        # (e.g. PAD_CODE re-packs) take the pure-NumPy path, which maps them
        # to no plane.
        fast = native.pack_eq(codes, word_bits)
        if fast is not None:
            return fast
    S, L = codes.shape
    W = word_count(L, word_bits)
    padded = np.full((S, W * word_bits), PAD_CODE, dtype=np.int16)
    padded[:, :L] = codes
    padded = padded.reshape(S, W, word_bits)
    weights = (np.uint32(1) << np.arange(word_bits, dtype=np.uint32))
    eq = np.zeros((CHAR_NUM, W, S), dtype=np.uint32)
    for c in range(CHAR_NUM):
        # Distinct powers of two: plain sum assembles the word without carries.
        eq[c] = np.sum((padded == c) * weights, axis=2, dtype=np.uint32).T
    return eq


def unpack_eq_host(eq: np.ndarray, length: int, word_bits: int = 31) -> np.ndarray:
    """Inverse of pack_eq_host (testing aid): (C, W, S) -> (S, length) codes."""
    C, W, S = eq.shape
    bits = np.arange(word_bits, dtype=np.uint32)
    # (C, W, S, word_bits) -> (C, S, W*word_bits)
    planes = ((eq[..., None] >> bits) & 1).transpose(0, 2, 1, 3).reshape(C, S, W * word_bits)
    codes = np.full((S, W * word_bits), PAD_CODE, dtype=np.int16)
    for c in range(C):
        codes[planes[c] == 1] = c
    return codes[:, :length]


def nibble_pack(codes: np.ndarray, threads: int = 1) -> np.ndarray:
    """Transport packing: two symbol codes (0..4) per byte, 8x smaller than
    int32 codes. ``threads`` fans the native packer over host cores (the
    reference's -N)."""
    codes = np.asarray(codes, dtype=np.uint8)
    from . import native

    fast = native.transport_pack(codes, two_bit=False, threads=threads)
    if fast is not None:
        return fast
    S, n = codes.shape
    if n % 2:
        codes = np.concatenate([codes, np.full((S, 1), 0, np.uint8)], axis=1)
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


def two_bit_pack(codes: np.ndarray, threads: int = 1) -> np.ndarray:
    """Transport packing for N-free data: four codes (0..3) per byte. Codes
    above 3 would be corrupted: callers check (``select_transport``)."""
    codes = np.asarray(codes, dtype=np.uint8)
    from . import native

    fast = native.transport_pack(codes, two_bit=True, threads=threads)
    if fast is not None:
        return fast
    S, n = codes.shape
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros((S, pad), np.uint8)], axis=1)
    c = codes.reshape(S, -1, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


# N-position sidecar rows are padded to this granularity so the device step
# sees a bounded set of sidecar shapes (per-shard granularity shrinks with
# the shard count so the padded total stays ~constant).
SIDECAR_QUANT = 1024


def _sidecar_quant(n_shards: int) -> int:
    return max(SIDECAR_QUANT // n_shards, 128)


def sidecar_pack(codes: np.ndarray, n_shards: int = 1) -> np.ndarray:
    """(K', 2) int32 positions of the N characters (row, col), K' padded up
    to a quant multiple with out-of-range rows (dropped by the unpacker).

    With ``n_shards > 1`` the batch is row-split into n_shards equal groups
    and the result is the concatenation of n_shards equal-size per-shard
    position lists with *shard-local* row indices, so each shard's slice of
    the sidecar holds exactly its own N fix-ups.
    """
    codes = np.asarray(codes)
    S = codes.shape[0]
    quant = _sidecar_quant(n_shards)
    if n_shards == 1:
        rows, cols = np.nonzero(codes > 3)
        k = len(rows)
        padded = max(-(-k // quant), 1) * quant
        pos = np.full((padded, 2), S, np.int32)  # row == S -> dropped
        pos[:k, 0] = rows
        pos[:k, 1] = cols
        return pos
    if S % n_shards:
        raise ValueError(f"sidecar_pack: {S} rows not divisible by {n_shards} shards")
    per = S // n_shards
    parts = [np.nonzero(codes[i * per : (i + 1) * per] > 3) for i in range(n_shards)]
    k_pad = max(-(-max(len(r) for r, _ in parts) // quant), 1) * quant
    pos = np.full((n_shards * k_pad, 2), per, np.int32)  # row == per -> dropped
    for i, (r, c) in enumerate(parts):
        pos[i * k_pad : i * k_pad + len(r), 0] = r
        pos[i * k_pad : i * k_pad + len(r), 1] = c
    return pos


def select_transport(codes: np.ndarray, allow_sidecar: bool = True,
                     n_shards: int = 1, threads: int = 1):
    """Pick the host->device subject encoding for a batch.

    * N-free: 4 codes/byte ("2bit").
    * rare N (sidecar smaller than the nibble-vs-2bit delta): 4 codes/byte
      plus a sparse N fix-up list ("2bitN", payload is a (packed, positions)
      tuple).
    * otherwise: 2 codes/byte ("nib").

    Returns (name, payload); pair with ``transport_unpack(name)`` on the
    device. ``n_shards`` pre-splits the sidecar into shard-local position
    lists (see sidecar_pack); ``allow_sidecar=False`` restricts to the
    single-array transports.
    """
    codes = np.asarray(codes)
    from . import native

    n_count = None
    if codes.dtype == np.uint8 and codes.flags.c_contiguous:
        n_count = native.count_n(codes)
    if n_count is None:
        n_count = int(np.count_nonzero(codes > 3))
    if n_count == 0:
        return "2bit", two_bit_pack(codes, threads)
    S, L = codes.shape
    delta = S * (-(-L // 2) - (-(-L // 4)))  # nibble bytes minus 2bit bytes
    # Cheap lower bound on the padded sidecar size gates the exact check.
    min_rows = n_shards * _sidecar_quant(n_shards)
    if allow_sidecar and min_rows * 8 <= delta and n_count * 8 <= delta:
        pos = sidecar_pack(codes, n_shards)
        if pos.shape[0] * 8 <= delta:
            clean = np.where(codes > 3, 0, codes).astype(np.uint8)
            return "2bitN", (two_bit_pack(clean, threads), pos)
    return "nib", nibble_pack(codes, threads)


def transport_width(name: str, length: int) -> int:
    """Packed bytes per subject for a transport."""
    return -(-length // 4) if name in ("2bit", "2bitN") else -(-length // 2)


def transport_specs(name: str, rows: int, length: int, sidecar: int = 0):
    """(shape, dtype) leaves of a transport payload."""
    main = ((rows, transport_width(name, length)), np.uint8)
    if name == "2bitN":
        return [main, ((sidecar, 2), np.int32)]
    return [main]


def pack_banded_host(codes: np.ndarray, threshold: int, query_len: int,
                     threads: int = 1):
    """Banded packing: initial 64-bit Peq window + per-column injection bits.

    Mirrors the reference's banded layout (``banded/BGSA_CPU/global.c:25-85``):
    word 0 holds subject[0..k-1] pre-shifted to bits k+1..2k of a 64-bit band
    register; the remaining subject characters are consumed one bit per query
    column as the band slides. Unlike the reference it never reads past the
    subject; beyond the subject end it injects zero bits.

    Returns init_lo, init_hi (CHAR_NUM, S) uint32 (the initial Peq window)
    and inj (CHAR_NUM, W, S) uint32, injection bit w*32+b = column t's,
    i.e. subject[k + t] == c; W = ceil(max(query_len - k, 1) / 32).
    """
    codes = np.atleast_2d(np.asarray(codes))
    if threshold + min(threshold, codes.shape[1]) > 63:
        raise ValueError(
            f"banded preload needs bit {threshold + min(threshold, codes.shape[1])} "
            f"(> 63): threshold {threshold} with {codes.shape[1]}bp subjects "
            "exceeds the 64-bit band register"
        )
    from . import native

    fast = native.pack_banded(codes, threshold, query_len, threads=threads)
    if fast is not None:
        return fast
    S, L = codes.shape
    k = threshold
    init = np.zeros((CHAR_NUM, S), dtype=np.uint64)
    for i in range(min(k, L)):
        for c in range(CHAR_NUM):
            init[c] |= (codes[:, i] == c).astype(np.uint64) << np.uint64(k + 1 + i)
    n_inj = max(query_len - k, 1)
    W = -(-n_inj // 32)
    inj = np.zeros((CHAR_NUM, W, S), dtype=np.uint32)
    for t in range(min(n_inj, max(L - k, 0))):
        idx = k + t
        w, b = divmod(t, 32)
        for c in range(CHAR_NUM):
            inj[c, w] |= (codes[:, idx] == c).astype(np.uint32) << np.uint32(b)
    return ((init & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (init >> np.uint64(32)).astype(np.uint32), inj)


# -- device half (torch) -------------------------------------------------------


def eq_from_numpy(eq_u32: np.ndarray) -> torch.Tensor:
    """(C, W, S) uint32 Eq planes (``pack_eq_host``) -> int32 tensor."""
    eq = np.ascontiguousarray(eq_u32, dtype=np.uint32)
    return torch.from_numpy(eq.view(np.int32))


def eq_to_numpy(eq: torch.Tensor) -> np.ndarray:
    """Inverse of eq_from_numpy: int32 tensor (any device) -> uint32 numpy."""
    return eq.detach().cpu().contiguous().numpy().view(np.uint32)


def two_bit_unpack(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of ``two_bit_pack``: (S, ceil(n/4)) uint8 -> (S, n) int32."""
    p = packed.to(torch.int32)
    parts = [(p >> (2 * i)) & 3 for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(p.shape[0], -1)[:, :length]


def nibble_unpack(nib: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of ``nibble_pack``: (S, ceil(n/2)) uint8 -> (S, n) int32."""
    p = nib.to(torch.int32)
    out = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(p.shape[0], -1)
    return out[:, :length]


def two_bit_sidecar_unpack(payload, length: int) -> torch.Tensor:
    """Inverse of the "2bitN" transport: 2-bit unpack, then code 4 at the
    sidecar's (row, col) positions. Rows past the batch are the sidecar's
    padding and are dropped (the JAX scatter's ``mode="drop"``): they land
    in one spare slot past the end instead, so no host sync is needed."""
    packed, pos = payload
    out = two_bit_unpack(packed, length)
    S = out.shape[0]
    rows, cols = pos[:, 0].long(), pos[:, 1].long()
    spare = S * length
    flat = torch.cat([out.reshape(-1), out.new_zeros(1)])
    flat[torch.where(rows < S, rows * length + cols, spare)] = 4
    return flat[:spare].reshape(S, length)


_UNPACKERS = {
    "2bit": two_bit_unpack,
    "2bitN": two_bit_sidecar_unpack,
    "nib": nibble_unpack,
}


def transport_unpack(name: str):
    """Device-side unpacker matching ``select_transport``'s name."""
    return _UNPACKERS[name]


def pack_eq(codes: torch.Tensor, word_bits: int = 32) -> torch.Tensor:
    """(S, L) symbol codes -> (CHAR_NUM, W, S) int32 Eq words.

    Bit b of eq[c, w, s] is set iff codes[s, w*word_bits + b] == c. Words are
    assembled one bit position at a time over (C, S, W) planes, so no
    (C, S, W, word_bits) one-hot intermediate is materialized; they are
    built in int64 so that bit 31 is an ordinary bit, then reinterpreted as
    int32.
    """
    S, L = codes.shape
    W = word_count(L, word_bits)
    cw = torch.full((S, W * word_bits), PAD_CODE, dtype=torch.int32, device=codes.device)
    cw[:, :L] = codes
    cw = cw.reshape(S, W, word_bits)
    chars = torch.arange(CHAR_NUM, dtype=torch.int32, device=codes.device).view(CHAR_NUM, 1, 1)
    words = torch.zeros((CHAR_NUM, S, W), dtype=torch.int64, device=codes.device)
    for b in range(word_bits):
        words |= (cw[:, :, b] == chars).to(torch.int64) << b
    return int32_words(words).transpose(1, 2).contiguous()


def int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _pack_at(codes: torch.Tensor, offset: int, W: int) -> torch.Tensor:
    """Eq words (5, W, S) of ``codes`` placed at stream bit ``offset``;
    words past the codes are zero."""
    S = codes.shape[0]
    if codes.shape[1] == 0:
        return torch.zeros((CHAR_NUM, W, S), dtype=torch.int32, device=codes.device)
    lead = torch.full((S, offset), PAD_CODE, dtype=torch.int32, device=codes.device)
    eq = pack_eq(torch.cat([lead, codes.to(torch.int32)], dim=1), 32)
    if eq.shape[1] < W:
        eq = torch.cat([eq, eq.new_zeros((CHAR_NUM, W - eq.shape[1], S))], dim=1)
    return eq


def _stream_geometry(L: int, threshold: int, query_len: int):
    """(band_down, nA, nB, W) of the banded bit-streams: nA preload and nB
    injected characters; W words with two of zero padding (funnel overrun)."""
    k, m = threshold, query_len
    band_down = 2 * k + L - m  # k + h
    nA = min(k, L)
    nB = min(max(m - k, 0), max(L - k, 0))
    total = max(k + 1 + nA, band_down + 1 + nB, 1)
    return band_down, nA, nB, word_count(total, 32) + 2


def pack_banded_stream(codes: torch.Tensor, threshold: int, query_len: int) -> torch.Tensor:
    """(S, L) codes -> (5, W, S) int32: the banded Eq window as one flat
    bit-stream per character (``bgsa_tpu.pack.pack_banded_stream_jax``).

    Subject[i] sits at stream position k+1+i (the preload) and subject[k+t]
    at band_down+1+t (the injection of column t), so column t's 64-bit Eq
    window is stream bits [t, t+63]. Needs s_len >= q_len - k.
    """
    k = threshold
    band_down, nA, nB, W = _stream_geometry(codes.shape[1], k, query_len)
    stream = _pack_at(codes[:, :nA], k + 1, W)
    if nB:
        stream = stream | _pack_at(codes[:, k:k + nB], band_down + 1, W)
    return stream


def pack_banded_streams(codes: torch.Tensor, threshold: int, query_len: int) -> torch.Tensor:
    """(S, L) codes -> (2, 5, W, S) int32: the preload stream A and the
    injection stream B apart (``bgsa_tpu.pack.pack_banded_streams_jax``),
    for s_len < q_len, where the flat stream's two ranges collide."""
    k = threshold
    band_down, nA, nB, W = _stream_geometry(codes.shape[1], k, query_len)
    return torch.stack([
        _pack_at(codes[:, :nA], k + 1, W),
        _pack_at(codes[:, k:k + nB], band_down + 1, W),
    ])


def pack_banded(codes: torch.Tensor, threshold: int, query_len: int):
    """(S, L) codes -> (init_lo (5, S), init_hi (5, S), inj (5, W, S)) int32
    (``bgsa_tpu.pack.pack_banded_jax``): the initial 64-bit Peq window
    (subject[i] at bit k+1+i for i < k) in two 32-bit halves, and the
    injection bits, bit t % 32 of word t // 32 being subject[k + t]'s,
    W = ceil(max(query_len - k, 1) / 32)."""
    S, L = codes.shape
    k = threshold
    if k + min(k, L) > 63:
        raise ValueError(
            f"banded preload needs bit {k + min(k, L)} (> 63): threshold {k} "
            f"with {L}bp subjects exceeds the 64-bit band register"
        )
    chars = torch.arange(CHAR_NUM, dtype=torch.int32, device=codes.device).view(CHAR_NUM, 1)
    init = torch.zeros((CHAR_NUM, S), dtype=torch.int64, device=codes.device)
    for i in range(min(k, L)):
        init |= (codes[:, i].to(torch.int32) == chars).to(torch.int64) << (k + 1 + i)
    lo, hi = init & 0xFFFFFFFF, (init >> 32) & 0xFFFFFFFF
    n_inj = max(query_len - k, 1)
    W = word_count(n_inj, 32)
    avail = max(min(n_inj, L - k), 0)
    inj = _pack_at(codes[:, k:k + avail], 0, W)
    return int32_words(lo), int32_words(hi), inj
