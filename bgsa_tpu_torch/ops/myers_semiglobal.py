"""Full-word Myers block scoring, global and semi-global: torch and CUDA.

Counterpart of ``bgsa_tpu/ops/myers_semiglobal.py``. Same I/O contract:
``eq`` (5, W, S) 32-bit Eq words (int32 here, see ``bgsa_tpu_torch.pack``),
``queries`` (Q, m) codes 0..4; the result is (Q, S) int32, ``factor`` times
the final last-row score (global) or the running minimum of the last row
(semi-global).

``myers_semiglobal_ref`` is the plain torch version: the JAX column body
word for word, with the queries axis as a batch dimension instead of
``vmap``. ``myers_semiglobal`` dispatches on the tensor's device: the plain
version for a CPU tensor, the hand-written kernel
(``bgsa_tpu_torch/csrc/myers_semiglobal.cu``) for a CUDA tensor. The kernel
takes any S and any W; nothing is routed to the plain version on the card.
Past its register bound (``reg_words``, 32 words) the kernel runs the words
in strips of 32, one strip after another over every column, and passes each
column's hp/hn carries from strip to strip packed 32 columns to a word
(``STRIP_LAUNCHES``); on few pairs (``strip_wave``) a group of 32 subjects'
strips run as a wavefront over four warps (``WAVE_LAUNCHES``).
``myers_strip_ref`` is a plain model of the strips' schedule, for the
tests only.
"""

from __future__ import annotations

import torch

from ..pack import CHAR_NUM, word_count

WORD_BITS = 32
CARRY_BATCH = 32  # query columns one carry word holds

# Kernel launches made by ``myers_semiglobal`` (CUDA tensors only), and
# those of them past the register bound: the strip kernel on one warp a
# group (STRIP_LAUNCHES) and as a wavefront (WAVE_LAUNCHES).
LAUNCHES = 0
STRIP_LAUNCHES = 0
WAVE_LAUNCHES = 0


# The strip kernel runs a group of 32 subjects' strips on one warp, or, on
# few pairs, as a wavefront over a block's four warps: where the groups
# would put fewer warps than this on an SM (and a query has four batches of
# 32 columns, one a warp). On the H100, Q=20 x 1,000 bp (PERF.md §6): the
# wavefront loses at the 5 and 10 kbp buckets (26.7 and 13.3 groups an SM)
# and wins at 20 and 40 kbp (6.7 and 3.0).
THIN_WARPS_PER_SM = 8
WAVE_WARPS = 4


def carry_words(m: int) -> int:
    """Carry words a plane holds for a query of m columns."""
    return -(-m // CARRY_BATCH)


def strip_wave(Q: int, S: int, m: int, sms: int) -> bool:
    """Whether the strip kernel runs as a wavefront over four warps."""
    return Q * -(-S // 32) < THIN_WARPS_PER_SM * sms and carry_words(m) >= WAVE_WARPS


def _column(eq_c, pv, mv, score, min_score, *, read_len, is_global):
    """One query-character column over all words.

    eq_c: (Q, W, S) int32; pv/mv: W-lists of (Q, S) int32; score/min_score:
    (Q, S) int32. The horizontal delta h in {-1, 0, +1} is threaded between
    words as two 0/1 planes (hp_in = "h == +1", hn_in = "h == -1"). Right
    shifts are masked: int32 shifts are arithmetic.
    """
    W = eq_c.shape[1]
    last_shift = (read_len - 1) % WORD_BITS

    hp_in = torch.full_like(score, 1 if is_global else 0)
    hn_in = torch.zeros_like(score)
    new_pv, new_mv = [], []
    for j in range(W):
        pvj, mvj = pv[j], mv[j]
        eq = eq_c[:, j]
        xv = eq | mvj
        eq = eq | hn_in
        xh = (((eq & pvj) + pvj) ^ pvj) | eq
        ph = ~(xh | pvj) | mvj
        mh = pvj & xh
        if j == W - 1:
            ph_bit = (ph >> last_shift) & 1
            mh_bit = (mh >> last_shift) & 1
        else:
            # the last word's outgoing horizontal delta is never consumed
            hp_out = (ph >> (WORD_BITS - 1)) & 1
            hn_out = (mh >> (WORD_BITS - 1)) & 1
        ph = (ph << 1) | hp_in
        mh = (mh << 1) | hn_in
        new_pv.append(~(xv | ph) | mh)
        new_mv.append(ph & xv)
        if j < W - 1:
            hp_in, hn_in = hp_out, hn_out
    score = score + ph_bit - mh_bit
    if min_score is None:  # global mode: the running min is dead state
        return new_pv, new_mv, score, None
    return new_pv, new_mv, score, torch.minimum(min_score, score)


def myers_semiglobal_ref(eq, queries, *, read_len: int, factor: int = -1,
                         is_global: bool = False):
    """Plain torch version. eq (5, W, S) int32, queries (Q, m) -> (Q, S) int32."""
    _, W, S = eq.shape
    Q, m = queries.shape
    q = queries.to(device=eq.device, dtype=torch.long)
    pv = [torch.full((Q, S), -1, dtype=torch.int32, device=eq.device)] * W
    mv = [torch.zeros((Q, S), dtype=torch.int32, device=eq.device)] * W
    score = torch.full((Q, S), read_len, dtype=torch.int32, device=eq.device)
    mins = None if is_global else score
    for i in range(m):
        pv, mv, score, mins = _column(
            eq[q[:, i]], pv, mv, score, mins, read_len=read_len, is_global=is_global
        )
    return (score if is_global else mins) * factor


def _word(eq, pv, mv, hp, hn):
    """One word of one column (the kernel's ``myers_word``): (pv, mv,
    outgoing hp, outgoing hn, ph, mh), the last two before the shift."""
    xv = eq | mv
    eq = eq | hn
    xh = (((eq & pv) + pv) ^ pv) | eq
    ph = ~(xh | pv) | mv
    mh = pv & xh
    phs = (ph << 1) | hp
    mhs = (mh << 1) | hn
    return ~(xv | phs) | mhs, phs & xv, (ph >> 31) & 1, (mh >> 31) & 1, ph, mh


def myers_strip_ref(eq, queries, *, read_len: int, factor: int = -1, is_global: bool = False,
                    strip: int = 32):
    """Plain model of the strip kernel's schedule (tests only): the words in
    strips of ``strip`` (the last may be narrower), one strip after another
    over every column, each strip's pv/mv kept from its first column to its
    last. Strip 0 takes the top boundary at every column; each later strip
    takes the hp/hn carries of the previous strip's last word, which that
    strip packed one bit a column into (2, carry_words(m), Q, S) words and
    which the next overwrites in place, as the kernel does. Only the last
    strip moves the score. Query codes outside 0..4 match nothing, as in the
    kernel. eq (5, W, S) int32, queries (Q, m) -> (Q, S) int32."""
    _, W, S = eq.shape
    Q, m = queries.shape
    dev = eq.device
    q = queries.to(device=dev, dtype=torch.long)
    keep = torch.where(q < CHAR_NUM, -1, 0).to(torch.int32)
    q = q.clamp(0, CHAR_NUM - 1)
    last_shift = (read_len - 1) % WORD_BITS
    zeros = torch.zeros((Q, S), dtype=torch.int32, device=dev)
    carries = torch.zeros((2, carry_words(m), Q, S), dtype=torch.int32, device=dev)
    score = torch.full((Q, S), read_len, dtype=torch.int32, device=dev)
    mins = score
    for w0 in range(0, W, strip):
        sw = min(strip, W - w0)
        first, last = w0 == 0, w0 + sw == W
        pv, mv = [zeros - 1] * sw, [zeros] * sw
        for b in range(carry_words(m)):
            if first:
                hp_in, hn_in = zeros - 1 if is_global else zeros, zeros
            else:
                hp_in, hn_in = carries[0, b].clone(), carries[1, b].clone()
            hp_out, hn_out = zeros, zeros
            for t in range(min(CARRY_BATCH, m - CARRY_BATCH * b)):
                i = CARRY_BATCH * b + t
                eq_c = eq[q[:, i], w0:w0 + sw] & keep[:, i, None, None]
                hp, hn = (hp_in >> t) & 1, (hn_in >> t) & 1
                for j in range(sw):
                    pv[j], mv[j], hp, hn, ph, mh = _word(eq_c[:, j], pv[j], mv[j], hp, hn)
                hp_out, hn_out = hp_out | (hp << t), hn_out | (hn << t)
                if last:
                    score = score + ((ph >> last_shift) & 1) - ((mh >> last_shift) & 1)
                    mins = torch.minimum(mins, score)
            if not last:
                carries[0, b], carries[1, b] = hp_out, hn_out
    return (score if is_global else mins) * factor


def myers_semiglobal(eq, queries, *, read_len: int, factor: int = -1,
                     is_global: bool = False):
    """(5, W, S) int32 Eq words x (Q, m) query codes -> (Q, S) int32 scores.

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    raise if it cannot launch). Query codes outside 0..4 match nothing in
    the kernel.
    """
    C, W, S = eq.shape
    if C != CHAR_NUM or eq.dtype != torch.int32:
        raise ValueError(f"eq must be ({CHAR_NUM}, W, S) int32, got {tuple(eq.shape)} {eq.dtype}")
    if queries.dim() != 2:
        raise ValueError(f"queries must be (Q, m), got {tuple(queries.shape)}")
    if word_count(read_len, WORD_BITS) != W:
        raise ValueError(f"read_len {read_len} does not fill {W} 32-bit words")
    if eq.device.type == "cpu":
        return myers_semiglobal_ref(
            eq, queries, read_len=read_len, factor=factor, is_global=is_global
        )
    if eq.device.type != "cuda":
        raise ValueError(f"no myers_semiglobal for device {eq.device}")
    return _launch(eq, queries, read_len=read_len, factor=factor, is_global=is_global)


def _launch(eq, queries, *, read_len, factor, is_global):
    global LAUNCHES, STRIP_LAUNCHES, WAVE_LAUNCHES
    from . import build

    kernels = build.load()
    _, W, S = eq.shape
    Q, m = queries.shape
    eq = eq.contiguous()
    q = queries.to(device=eq.device, dtype=torch.uint8).contiguous()
    out = torch.empty((Q, S), dtype=torch.int32, device=eq.device)
    if Q == 0 or S == 0:
        return out
    carries, wave = None, False
    if W > kernels.reg_words:  # strips of pv/mv in registers; the carries between them
        carries = torch.empty((2, carry_words(m), Q, S), dtype=torch.int32, device=eq.device)
        wave = strip_wave(
            Q, S, m, torch.cuda.get_device_properties(eq.device).multi_processor_count)
    with torch.cuda.device(eq.device):
        stream = torch.cuda.current_stream(eq.device).cuda_stream
        rc = kernels.lib.bgsa_myers_semiglobal(
            eq.data_ptr(), q.data_ptr(), out.data_ptr(),
            None if carries is None else carries.data_ptr(),
            Q, m, W, S, read_len, factor, int(is_global), int(wave), stream,
        )
    kernels.check(rc, "myers_semiglobal")
    LAUNCHES += 1
    STRIP_LAUNCHES += carries is not None and not wave
    WAVE_LAUNCHES += wave
    return out
