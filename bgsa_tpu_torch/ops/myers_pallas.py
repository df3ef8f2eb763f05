"""Global unit-cost Myers in the reference's 31-bit reserved-carry layout: torch and CUDA.

Counterpart of ``bgsa_tpu/ops/myers_pallas.py`` (``myers_global``), the
reference-layout kernel the device mesh (``parallel.mesh``) runs. Same I/O
contract: ``eq`` (5, W, S) words of 31 usable bits (``pack.pack_eq(codes,
31)``, held as int32), ``queries`` (Q, m) codes 0..4; the result is (Q, S)
int32, ``factor`` times the final last-row score. Per word and column:
``s = (vp & pm) + vp + carry``, ``carry = s >> 31``, with no mask on ``s``
(bit 31 leaks into d0/hp and every consumer masks or shifts it out); VP
starts at the 31-bit carry mask, VN at 0, the score at ``read_len``, and the
score bit is ``(read_len - 1) % 31`` of the last word.

``myers_global_ref`` is the plain torch version of ``_column_words``, the
queries axis as a batch dimension. ``myers_global`` runs it for a CPU
tensor and launches ``csrc/myers_pallas.cu`` for a CUDA tensor (raising if
the build or launch fails), counting launches in ``LAUNCHES``. The kernel
takes any S and any W: state in registers up to ``reg_words`` words, in a
device scratch beyond, where the TPU wrapper routes to the XLA scan twin.
The JAX wrapper's ``S % 128`` rule is its TPU tiling and is not kept, and
its ``rows_per_block``, ``unroll`` and ``interpret`` (VMEM, VPU and
interpreter knobs) have no counterpart, and neither has its ``word_bits``:
the words are 31 bits, the layout whose carries the recurrence is written
for (``bgsa_tpu``'s other sizes score multiword subjects wrong).
"""

from __future__ import annotations

import torch

from ..pack import CHAR_NUM, word_count

WORD_BITS = 31
CARRY_MASK = (1 << WORD_BITS) - 1

# Kernel launches made by ``myers_global`` (CUDA tensors only).
LAUNCHES = 0


def _column_words(eq_c, vp, vn, score, *, maskh):
    """One query-character column over all words (``_column_words`` of the
    JAX module). eq_c: (Q, W, S) int32; vp/vn: W-lists of (Q, S) int32;
    score: (Q, S) int32. Right shifts are masked: int32 shifts are
    arithmetic, and ``s`` and ``hp << 1`` do set bit 31."""
    W = eq_c.shape[1]
    hp_shift = torch.ones_like(score)
    hn_shift = torch.zeros_like(score)
    add_carry = torch.zeros_like(score)
    new_vp, new_vn = [], []
    for j in range(W):
        pm = eq_c[:, j] | vn[j]
        s = (vp[j] & pm) + vp[j] + add_carry
        if j < W - 1:  # the last word's outgoing carries are unused
            add_carry = (s >> WORD_BITS) & 1
        d0 = (s ^ vp[j]) | pm
        hp = ~(d0 | vp[j]) | vn[j]
        hn = d0 & vp[j]
        if j == W - 1:
            hn_hit = ((hn & maskh) != 0).to(torch.int32)
            hp_hit = ((hp & maskh) != 0).to(torch.int32)
            score = score - hn_hit + hp_hit * (1 - hn_hit)
        hp = (hp << 1) | hp_shift
        hn = (hn << 1) | hn_shift
        if j < W - 1:
            hp_shift = (hp >> WORD_BITS) & 1
            hn_shift = (hn >> WORD_BITS) & 1
        new_vp.append((~(d0 | hp) | hn) & CARRY_MASK)
        new_vn.append((d0 & hp) & CARRY_MASK)
    return new_vp, new_vn, score


def myers_global_ref(eq, queries, *, read_len: int, factor: int = -1):
    """Plain torch version. eq (5, W, S) int32, queries (Q, m) -> (Q, S) int32."""
    _, W, S = eq.shape
    Q, m = queries.shape
    q = queries.to(device=eq.device, dtype=torch.long)
    maskh = 1 << ((read_len - 1) % WORD_BITS)
    vp = [torch.full((Q, S), CARRY_MASK, dtype=torch.int32, device=eq.device)] * W
    vn = [torch.zeros((Q, S), dtype=torch.int32, device=eq.device)] * W
    score = torch.full((Q, S), read_len, dtype=torch.int32, device=eq.device)
    for i in range(m):
        vp, vn, score = _column_words(eq[q[:, i]], vp, vn, score, maskh=maskh)
    return score * factor


def myers_global(eq, queries, *, read_len: int, factor: int = -1):
    """(5, W, S) int32 31-bit Eq words x (Q, m) query codes -> (Q, S) int32
    scores (= factor * edit distance).

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    raise if it cannot launch). Query codes outside 0..4 match nothing in
    the kernel.
    """
    if eq.dim() != 3 or eq.shape[0] != CHAR_NUM or eq.dtype != torch.int32:
        raise ValueError(f"eq must be ({CHAR_NUM}, W, S) int32, got {tuple(eq.shape)} {eq.dtype}")
    W = eq.shape[1]
    if queries.dim() != 2:
        raise ValueError(f"queries must be (Q, m), got {tuple(queries.shape)}")
    if read_len < 1 or word_count(read_len, WORD_BITS) != W:
        raise ValueError(f"read_len {read_len} does not fill {W} 31-bit words")
    if eq.device.type == "cpu":
        return myers_global_ref(eq, queries, read_len=read_len, factor=factor)
    if eq.device.type != "cuda":
        raise ValueError(f"no myers_global for device {eq.device}")
    return _launch(eq, queries, read_len=read_len, factor=factor)


def _launch(eq, queries, *, read_len, factor):
    global LAUNCHES
    from . import build

    kernels = build.load()
    reg_words = kernels.lib.bgsa_myers_global_reg_words()
    _, W, S = eq.shape
    Q, m = queries.shape
    eq = eq.contiguous()
    q = queries.to(device=eq.device, dtype=torch.uint8).contiguous()
    out = torch.empty((Q, S), dtype=torch.int32, device=eq.device)
    if Q == 0 or S == 0:
        return out
    scratch = None
    if W > reg_words:  # vp/vn of long subjects live in device memory
        scratch = torch.empty((2, W, Q, S), dtype=torch.int32, device=eq.device)
    with torch.cuda.device(eq.device):
        stream = torch.cuda.current_stream(eq.device).cuda_stream
        rc = kernels.lib.bgsa_myers_global(
            eq.data_ptr(), q.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            Q, m, W, S, read_len, factor, stream,
        )
    kernels.check(rc, "myers_global")
    LAUNCHES += 1
    return out
