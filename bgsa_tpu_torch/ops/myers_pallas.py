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
takes any S and any W: all W words' state in registers up to ``reg_words``
(32) words; beyond (where the TPU wrapper routes to the XLA scan twin) the
words run in strips of 32, one strip after another over every column, each
column's add/hp/hn carries passed from strip to strip packed 32 columns to
a word (``STRIP_LAUNCHES``), on few pairs as a wavefront over four warps
(``WAVE_LAUNCHES``, the rule of ``myers_semiglobal.strip_wave``);
``myers_global_strip_ref`` is a plain model of the strips' schedule, for
the tests only.
The JAX wrapper's ``S % 128`` rule is its TPU tiling and is not kept, and
its ``rows_per_block``, ``unroll`` and ``interpret`` (VMEM, VPU and
interpreter knobs) have no counterpart, and neither has its ``word_bits``:
the words are 31 bits, the layout whose carries the recurrence is written
for (``bgsa_tpu``'s other sizes score multiword subjects wrong).
"""

from __future__ import annotations

import torch

from ..pack import CHAR_NUM, word_count
from .myers_semiglobal import CARRY_BATCH, carry_words, strip_wave

WORD_BITS = 31
CARRY_MASK = (1 << WORD_BITS) - 1

# Kernel launches made by ``myers_global`` (CUDA tensors only), and those of
# them past the register bound: the strip kernel on one warp a group
# (STRIP_LAUNCHES) and as a wavefront (WAVE_LAUNCHES).
LAUNCHES = 0
STRIP_LAUNCHES = 0
WAVE_LAUNCHES = 0


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


def myers_global_strip_ref(eq, queries, *, read_len: int, factor: int = -1, strip: int = 32):
    """Plain model of the strip kernel's schedule (tests only): the words in
    strips of ``strip`` (the last may be narrower), one strip after another
    over every column, each strip's vp/vn kept from its first column to its
    last. Strip 0 takes the top boundary (add 0, hp 1, hn 0) at every column;
    each later strip takes the add/hp/hn carries of the previous strip's last
    word, which that strip packed one bit a column into (3, carry_words(m),
    Q, S) words and which the next overwrites in place, as the kernel does.
    Only the last strip's last word moves the score. Query codes outside
    0..4 match nothing, as in the kernel. eq (5, W, S) int32, queries (Q, m)
    -> (Q, S) int32."""
    _, W, S = eq.shape
    Q, m = queries.shape
    dev = eq.device
    q = queries.to(device=dev, dtype=torch.long)
    keep = torch.where(q < CHAR_NUM, -1, 0).to(torch.int32)
    q = q.clamp(0, CHAR_NUM - 1)
    maskh = 1 << ((read_len - 1) % WORD_BITS)
    zeros = torch.zeros((Q, S), dtype=torch.int32, device=dev)
    carries = torch.zeros((3, carry_words(m), Q, S), dtype=torch.int32, device=dev)
    score = torch.full((Q, S), read_len, dtype=torch.int32, device=dev)
    for w0 in range(0, W, strip):
        sw = min(strip, W - w0)
        first, last = w0 == 0, w0 + sw == W
        vp, vn = [zeros + CARRY_MASK] * sw, [zeros] * sw
        for b in range(carry_words(m)):
            ins = (zeros, zeros - 1, zeros) if first else carries[:, b].clone().unbind(0)
            outs = [zeros] * 3
            for t in range(min(CARRY_BATCH, m - CARRY_BATCH * b)):
                i = CARRY_BATCH * b + t
                eq_c = eq[q[:, i], w0:w0 + sw] & keep[:, i, None, None]
                add, hp_shift, hn_shift = ((x >> t) & 1 for x in ins)
                for j in range(sw):
                    pm = eq_c[:, j] | vn[j]
                    s = (vp[j] & pm) + vp[j] + add
                    add = (s >> WORD_BITS) & 1
                    d0 = (s ^ vp[j]) | pm
                    hp = ~(d0 | vp[j]) | vn[j]
                    hn = d0 & vp[j]
                    if last and j == sw - 1:
                        hn_hit = ((hn & maskh) != 0).to(torch.int32)
                        hp_hit = ((hp & maskh) != 0).to(torch.int32)
                        score = score - hn_hit + hp_hit * (1 - hn_hit)
                    hp = (hp << 1) | hp_shift
                    hn = (hn << 1) | hn_shift
                    hp_shift, hn_shift = (hp >> WORD_BITS) & 1, (hn >> WORD_BITS) & 1
                    vp[j] = (~(d0 | hp) | hn) & CARRY_MASK
                    vn[j] = (d0 & hp) & CARRY_MASK
                outs = [o | (x << t) for o, x in zip(outs, (add, hp_shift, hn_shift))]
            if not last:
                carries[:, b] = torch.stack(outs)
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
    global LAUNCHES, STRIP_LAUNCHES, WAVE_LAUNCHES
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
    carries, wave = None, False
    if W > reg_words:  # strips of vp/vn in registers; the carries between them
        carries = torch.empty((3, carry_words(m), Q, S), dtype=torch.int32, device=eq.device)
        wave = strip_wave(
            Q, S, m, torch.cuda.get_device_properties(eq.device).multi_processor_count)
    with torch.cuda.device(eq.device):
        stream = torch.cuda.current_stream(eq.device).cuda_stream
        rc = kernels.lib.bgsa_myers_global(
            eq.data_ptr(), q.data_ptr(), out.data_ptr(),
            None if carries is None else carries.data_ptr(),
            Q, m, W, S, read_len, factor, int(wave), stream,
        )
    kernels.check(rc, "myers_global")
    LAUNCHES += 1
    STRIP_LAUNCHES += carries is not None and not wave
    WAVE_LAUNCHES += wave
    return out
