"""Subject-interleaved packed banded kernel: torch and CUDA.

Counterpart of ``bgsa_tpu/ops/banded_packed.py``. Where the band is narrow
(s_len >= q_len, band_down <= 30), ``n_sub = 64 // (band_down + 2)``
subjects' bands share one 64-bit register at pitch ``band_down + 2``, one
guard bit per field; scores equal the one-band-per-register kernels bit for
bit. Errors are counted SWAR (per-field match counters), and "over budget"
is latched per field by a top-bit subtraction.

``banded_stream_packed_ref`` is the plain torch version, after the XLA twin
``banded_packed_xla``: the queries as a batch dimension, the (lo, hi)
uint32 pairs as one native int64 word. ``banded_stream_packed`` runs it for
a CPU tensor and launches ``csrc/banded_packed.cu`` for a CUDA tensor,
counting launches in ``LAUNCHES``.

Two corners where the JAX module's arithmetic leaves the reference
(``bgsa_tpu.banded_ref``) are held to the reference here: the final error
count is ``max(q_len, k) - matches`` (the JAX twin takes ``q_len - matches``,
wrong when q_len < k: no column is scored, err stays k), and the latch
threshold ``scored - h - 1`` is clamped at 0 before it is spread over the
fields (no field can be over budget while it is <= 0).
"""

from __future__ import annotations

import torch

from ..banded_ref import MAX_ERROR
from ..pack import CHAR_NUM

from .banded import (MASK32, WORD_BITS, _check_queries, _device_of, const64, geometry,
                     last_checkpoint, launch, shr)

# Kernel launches made by ``banded_stream_packed`` (CUDA tensors only).
LAUNCHES = 0


def packed_subbands(q_len: int, s_len: int, k: int) -> int:
    """Sub-bands per 64-bit register for this geometry; 0 when packing does
    not apply (shorter subjects, fat bands, or match-count overflow)."""
    h = k + s_len - q_len
    if h < 0 or h < k:
        return 0  # needs the single-stream geometry (preload inside band)
    band_down = k + h
    if band_down + 1 > 64:
        return 0
    pitch = band_down + 2  # band bits 0..band_down + 1 guard bit
    n_sub = 64 // pitch
    if n_sub < 2:
        return 0  # no denser than the plain stream kernel
    if q_len >= 1 << (pitch - 1):
        return 0  # matches counter would overflow its field
    return n_sub


def consts(q_len: int, s_len: int, k: int):
    """(h, band_down, max_err, pitch, n_sub, band, xsm, ones, tops) with the
    four masks as unsigned Python ints: band = bits 0..band_down of every
    field, xsm = bits 0..band_down-1, ones = bit 0, tops = the guard bit."""
    h, band_down, max_err = geometry(q_len, s_len, k)
    pitch = band_down + 2
    n_sub = 64 // pitch
    band = xsm = ones = tops = 0
    for j in range(n_sub):
        o = pitch * j
        band |= ((1 << (band_down + 1)) - 1) << o
        xsm |= ((1 << band_down) - 1) << o
        ones |= 1 << o
        tops |= 1 << (o + pitch - 1)
    return h, band_down, max_err, pitch, n_sub, band, xsm, ones, tops


def pack_packed_streams(codes: torch.Tensor, threshold: int, query_len: int,
                        n_sub: int) -> torch.Tensor:
    """Chunked Eq bit-streams for the packed kernel, on the codes' device.

    codes (S, L) with S a multiple of n_sub (no lane rule on the GPU) ->
    (n_sub, 5, W, S // n_sub) int32: ``pack.pack_banded_stream`` of each
    contiguous chunk (the kernel's field j scores chunk j).
    """
    from .. import pack

    S = codes.shape[0]
    if S % n_sub:
        raise ValueError(f"subject count {S} must be a multiple of {n_sub}")
    chunk = S // n_sub
    return torch.stack([
        pack.pack_banded_stream(codes[j * chunk:(j + 1) * chunk], threshold, query_len)
        for j in range(n_sub)
    ])


def _check_streams(streams, q_len, s_len, k) -> int:
    n_sub = packed_subbands(q_len, s_len, k)
    if streams.dim() != 4 or streams.shape[1] != CHAR_NUM or streams.dtype != torch.int32:
        raise ValueError(f"streams must be (n_sub, 5, W, S_sub) int32, got "
                         f"{tuple(streams.shape)} {streams.dtype}")
    if n_sub < 2 or streams.shape[0] != n_sub:
        raise ValueError(
            f"geometry (q_len={q_len}, s_len={s_len}, k={k}) packs "
            f"{n_sub} sub-bands; got {streams.shape[0]} stream chunks"
        )
    return n_sub


def banded_stream_packed_ref(streams, queries, *, q_len: int, s_len: int, k: int):
    """Plain torch version. streams (n_sub, 5, W, S_sub) int32, queries
    (Q, m) -> (Q, n_sub * S_sub) int32 in original subject order."""
    n_sub = _check_streams(streams, q_len, s_len, k)
    h, band_down, _, pitch, _, band, xsm, ones, tops = consts(q_len, s_len, k)
    ones_u = ones
    band, xsm, ones, tops = map(const64, (band, xsm, ones, tops))
    wmask = (1 << (band_down + 1)) - 1
    last_chk = last_checkpoint(q_len, s_len, k)
    st = streams.long() & MASK32  # (n_sub, 5, W, S_sub)
    W, S_sub = st.shape[2:]
    q = queries.to(streams.device).long()
    vp = vn = mt = torch.zeros((q.shape[0], S_sub), dtype=torch.int64, device=streams.device)
    dead = torch.zeros_like(vp)
    for t in range(q_len):
        w, b = min(t // WORD_BITS, W - 2), t % WORD_BITS
        wins = shr(st[:, :, w] | (st[:, :, w + 1] << 32), b) & wmask  # (n_sub, 5, S_sub)
        fields = sum(wins[j] << (pitch * j) for j in range(n_sub))  # disjoint fields
        x = fields[q[:, t]] | vn
        d0 = (((x & vp) + vp) ^ vp) | x
        hn = d0 & vp
        hp = ~(d0 | vp) | vn
        xs = shr(d0 & band, 1) & xsm
        vn = xs & hp
        vp = (~(hp | xs) | hn) & band
        if t >= k:
            mt = mt + (d0 & ones)
        if t + 1 == last_chk:  # matches < thr <=> err > max_err, per field
            thr = const64(max(last_chk - k - h - 1, 0) * ones_u)  # thr in every field
            dead = dead | (~((mt | tops) - thr) & tops)
    outs = []
    for j in range(n_sub):
        o = pitch * j
        err = max(q_len, k) - (shr(mt, o) & ((1 << pitch) - 1))
        cur = mn = err
        for i in range(h + 1):
            cur = cur + (shr(vp, o + i) & 1) - (shr(vn, o + i) & 1)
            mn = torch.minimum(mn, cur)
        outs.append(torch.where(shr(dead, o + pitch - 1) & 1 == 1, MAX_ERROR, mn))
    return torch.cat(outs, dim=1).to(torch.int32)


def banded_stream_packed(streams, queries, *, q_len: int, s_len: int, k: int):
    """(n_sub, 5, W, S_sub) int32 chunked streams (``pack_packed_streams``)
    x (Q, q_len) codes -> (Q, n_sub * S_sub) int32 error counts (127 = over
    budget), in original subject order."""
    global LAUNCHES
    n_sub = _check_streams(streams, q_len, s_len, k)
    _check_queries(queries, q_len)
    if _device_of(streams, "banded_stream_packed") == "cpu":
        return banded_stream_packed_ref(streams, queries, q_len=q_len, s_len=s_len, k=k)
    h, band_down, _ = geometry(q_len, s_len, k)
    W, S_sub = streams.shape[2:]
    Q = queries.shape[0]
    dev = streams.device
    out = torch.empty((Q, n_sub * S_sub), dtype=torch.int32, device=dev)
    if Q == 0 or S_sub == 0:
        return out
    streams = streams.contiguous()
    q = queries.to(device=dev, dtype=torch.uint8).contiguous()
    args = (streams.data_ptr(), q.data_ptr(), out.data_ptr(), Q, q_len, W, S_sub, n_sub,
            k, h, band_down, last_checkpoint(q_len, s_len, k))
    launch("banded_stream_packed", "bgsa_banded_packed", out, args)
    LAUNCHES += 1
    return out
