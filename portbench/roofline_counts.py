"""Frozen operation counts: the least integer work the Myers recurrence
needs, whatever kernel computes it, and the card's peak to set it against.

One column of the block-based Myers algorithm over one 32-bit word of the
subject (Myers 1999, "A fast bit-vector algorithm for approximate string
matching based on dynamic programming", J. ACM 46(3), Fig. 3 and section 4,
the blocks; in the form of Hyyro 2003, "A bit-vector algorithm for
computing Levenshtein and Damerau edit distances", Nordic J. Computing
10(1), Fig. 3), each op at the fewest instructions any implementation needs
on Hopper: one LOP3 for any logic function of up to three inputs, one add
(IADD3, the add and its carry), one SHF for a shift or a funnel shift.
``hp``/``hn`` are the horizontal deltas entering the word from the word
below (0/1), ``ph_prev``/``mh_prev`` the words whose top bits they are.

The integer ALU pipe retires 64 results per clock per SM; LOP3 and SHF run
only there. The add may issue on the FMA pipe (IMAD.IADD) at another 64, so
the floor counts it apart and the ALU pipe sets the time:
ALU ops / (64 x SMs x the card's maximum SM clock). The whole issue rate,
128 per clock per SM, bounds all the ops less tightly.
"""

from __future__ import annotations

# (op, instructions, pipe, source) of one word of one column
MYERS_WORD_OPS = (
    ("xv = eq | mv", 1, "alu", "Myers 1999 Fig. 3, Xv"),
    ("a = eq | hn  (the negative carry in)", 1, "alu", "Myers 1999 sec. 4; Hyyro 2003 Fig. 3"),
    ("t = a & pv", 1, "alu", "Myers 1999 Fig. 3, Xh's and"),
    ("t + pv", 1, "add", "Myers 1999 Fig. 3, Xh's add"),
    ("xh = ((t + pv) ^ pv) | a", 1, "alu", "Myers 1999 Fig. 3, Xh"),
    ("ph = mv | ~(xh | pv)", 1, "alu", "Myers 1999 Fig. 3, Ph"),
    ("mh = pv & xh", 1, "alu", "Myers 1999 Fig. 3, Mh"),
    ("hn_out = mh >> 31", 1, "alu", "Myers 1999 sec. 4, the carry out"),
    ("phs = (ph << 1) | hp  (funnel of ph, ph_prev)", 1, "alu", "Myers 1999 Fig. 3, Ph <<= 1"),
    ("mhs = (mh << 1) | hn  (funnel of mh, mh_prev)", 1, "alu", "Myers 1999 Fig. 3, Mh <<= 1"),
    ("pv = mhs | ~(xv | phs)", 1, "alu", "Myers 1999 Fig. 3, Pv"),
    ("mv = phs & xv", 1, "alu", "Myers 1999 Fig. 3, Mv"),
)
# (op, instructions, pipe, source) once a column: the score moves by the
# last word's bit of the last row in ph less that in mh
MYERS_COLUMN_OPS = (
    ("ph >> last_bit", 1, "alu", "Myers 1999 Fig. 3, Score += 1"),
    ("mh >> last_bit", 1, "alu", "Myers 1999 Fig. 3, Score -= 1"),
    ("score += bit(ph) - bit(mh)", 1, "add", "Myers 1999 Fig. 3, Score"),
)
WORD_BITS = 32
ALU_PER_CLOCK_PER_SM = 64
MEMORY_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3 (NVIDIA's data sheet)
EQ_PLANES = 5  # A, C, G, T, N


def alu_ops(ops) -> int:
    return sum(n for _, n, pipe, _ in ops if pipe == "alu")


def all_ops(ops) -> int:
    return sum(n for _, n, _, _ in ops)


def words(subject_len: int) -> int:
    return -(-subject_len // WORD_BITS)


def myers_alu_ops(queries: int, query_len: int, subjects: int, subject_len: int) -> int:
    """ALU-pipe instructions that Q x S pairs need at the least: every column
    of every pair, over the words the subject length needs."""
    per_column = alu_ops(MYERS_WORD_OPS) * words(subject_len) + alu_ops(MYERS_COLUMN_OPS)
    return per_column * query_len * queries * subjects


def myers_bytes(launches, query_len: int, subject_len: int) -> int:
    """Bytes a kernel launch must move at the least, summed over ``launches``
    of (queries, subjects): its Eq words and query codes read once, its
    int32 scores written once."""
    w = words(subject_len)
    return sum(EQ_PLANES * w * 4 * s + q * query_len + 4 * q * s for q, s in launches)


def alu_peak(sms: int, clock_mhz: float) -> float:
    """int32 ALU results per second: 64 x SMs x the maximum SM clock."""
    return ALU_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6


def myers_floor_s(queries, query_len, subjects, subject_len, launches, sms, clock_mhz) -> float:
    """The least seconds the card could take: the larger of the ALU floor at
    the peak and the bytes at the memory rate."""
    ops_s = myers_alu_ops(queries, query_len, subjects, subject_len) / alu_peak(sms, clock_mhz)
    bytes_s = myers_bytes(launches, query_len, subject_len) / MEMORY_BYTES_PER_S
    return max(ops_s, bytes_s)
