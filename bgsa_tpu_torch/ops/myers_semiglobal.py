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
"""

from __future__ import annotations

import torch

from bgsa_tpu.pack import CHAR_NUM, word_count

WORD_BITS = 32

# Kernel launches made by ``myers_semiglobal`` (CUDA tensors only).
LAUNCHES = 0


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
    global LAUNCHES
    from . import build

    kernels = build.load()
    _, W, S = eq.shape
    Q, m = queries.shape
    eq = eq.contiguous()
    q = queries.to(device=eq.device, dtype=torch.uint8).contiguous()
    out = torch.empty((Q, S), dtype=torch.int32, device=eq.device)
    if Q == 0 or S == 0:
        return out
    scratch = None
    if W > kernels.reg_words:  # pv/mv of long subjects live in device memory
        scratch = torch.empty((2, W, Q, S), dtype=torch.int32, device=eq.device)
    with torch.cuda.device(eq.device):
        stream = torch.cuda.current_stream(eq.device).cuda_stream
        rc = kernels.lib.bgsa_myers_semiglobal(
            eq.data_ptr(), q.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            Q, m, W, S, read_len, factor, int(is_global), stream,
        )
    kernels.check(rc, "myers_semiglobal")
    LAUNCHES += 1
    return out
