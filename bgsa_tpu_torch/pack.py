"""Device half of ``bgsa_tpu.pack``: transport unpacking and Eq packing in torch.

The host half (``select_transport``, the 2-bit / nibble / sidecar packers,
``encode_ascii``) is jax-free and imported from ``bgsa_tpu.pack`` by the
pipeline; this module rebuilds symbol codes and Eq words on whatever device
the packed payload was uploaded to.

Word type: 32-bit Eq words are held as ``torch.int32`` (torch's ``uint32``
lacks shifts, add, not and min). Bit patterns are identical to the JAX
package's uint32 words; ``eq_from_numpy``/``eq_to_numpy`` reinterpret
between the two without changing a bit. Right shifts of int32 are
arithmetic, so every right shift in the port is masked.
"""

from __future__ import annotations

import numpy as np
import torch

from bgsa_tpu.pack import CHAR_NUM, PAD_CODE, word_count


def eq_from_numpy(eq_u32: np.ndarray) -> torch.Tensor:
    """(C, W, S) uint32 Eq planes (``bgsa_tpu.pack.pack_eq``) -> int32 tensor."""
    eq = np.ascontiguousarray(eq_u32, dtype=np.uint32)
    return torch.from_numpy(eq.view(np.int32))


def eq_to_numpy(eq: torch.Tensor) -> np.ndarray:
    """Inverse of eq_from_numpy: int32 tensor (any device) -> uint32 numpy."""
    return eq.detach().cpu().contiguous().numpy().view(np.uint32)


def two_bit_unpack(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of ``bgsa_tpu.pack.two_bit_pack``: (S, ceil(n/4)) uint8 -> (S, n) int32."""
    p = packed.to(torch.int32)
    parts = [(p >> (2 * i)) & 3 for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(p.shape[0], -1)[:, :length]


def nibble_unpack(nib: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of ``bgsa_tpu.pack.nibble_pack``: (S, ceil(n/2)) uint8 -> (S, n) int32."""
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
    """Device-side unpacker matching ``bgsa_tpu.pack.select_transport``'s name."""
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
