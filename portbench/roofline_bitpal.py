"""Frozen operation counts of the packed BitPAl network at (M, I, G) =
(2, -3, -5): the least integer work one word-column needs, whatever kernel
computes it, set against the card's peak as ``roofline_counts`` sets Myers.

The network is BitPAl's (Loving, Hernandez and Benson 2014, "BitPAl: a
bit-parallel, general integer-scoring sequence alignment algorithm",
Bioinformatics 30(22): the vertical and horizontal delta classes between G
and M - G, the run-propagation adds, the one-row shift) in its packed form,
as BGSA generates it for this scheme (SURVEY.md R8: each row's vertical
delta held in 5 two's-complement planes d0..d4, the decode of the classes
dh_neg5..dh_neg1, staged adds with carries across words, and two 5-plane
adders, DV = DH + delta and DH' = DV + delta'). Its lattice: lo = G = -5,
mid = I - G = 2, hi = M - G = 7; 13 values, 5 planes, 5 adds a word. Words
hold 31 subject rows (bit 31 is the add carry), so W = ceil(n / 31).

Each op is counted at the fewest instructions any implementation needs on
Hopper, as ``roofline_counts`` counts Myers: one LOP3 for any logic function
of up to three inputs (a 32-bit immediate mask counts as one), one add
(IADD3: two words and the carry in), one SHF for a shift or for a carry
bit taken out (its & 1 left out), one LEA for a shift by one that takes in
a carry bit. Logic that only complements an input is folded into its
consumer. LOP3, SHF and LEA run on the integer ALU pipe, 64 results per
clock per SM; the adds may run on the FMA pipe and are counted apart. The
floor is ALU ops / (64 x SMs x the card's maximum SM clock), or, where
larger, the launches' least bytes at 3.35 TB/s: Eq, query codes and int32
scores, each once. The tiled kernel's scratch is not in the floor: a
register implementation needs none.
"""

from __future__ import annotations

from . import roofline_counts

SCHEME = (2, -3, -5)
WORD_BITS = 31
LOVING = "Loving 2014"
BGSA = "BGSA packed network (SURVEY.md R8)"

# (op, instructions, pipe, source) of one word of one column. d0..d4: the
# word's planes; m: its match word; CM: the 31-bit mask; dvK: the
# horizontal class K indicator.
PACKED_WORD_OPS = (
    # the phase-A classes -5 .. -1 decoded from the planes (patterns 0, 31..28)
    ("p = d4 & d3 & d2", 1, "alu", BGSA + ", decode dh_neg4..dh_neg1"),
    ("z = ~(d4 | d3 | d2)", 1, "alu", BGSA + ", decode dh_neg5"),
    ("zero = z & ~d1 & ~d0  (class G)", 1, "alu", BGSA + ", decode dh_neg5"),
    ("dh[-5] = zero & CM", 1, "alu", BGSA + ", the 31-bit word"),
    ("dh[-4..-1] = p & (d1 | ~d1) & (d0 | ~d0), one a class", 4, "alu",
     BGSA + ", decode dh_neg4..dh_neg1"),
    # the rows of the low classes G .. I - G: stored 0 or >= 25
    ("t = d2 | d1 | d0", 1, "alu", BGSA + ", the low-class compare"),
    ("ge = d4 & d3 & t", 1, "alu", BGSA + ", the low-class compare"),
    ("lo_mid = (zero | ge) & ~m", 1, "alu", LOVING + ", the mismatch class and below"),
    # phase A: horizontal class hi = 7 by the first run-propagation add
    ("init_max = dh[-5] & m", 1, "alu", LOVING + ", the matches that start a run"),
    ("remain = dh[-5] & ~m", 1, "alu", LOVING + ", the run's other rows"),
    ("s = init_max + dh[-5] + carry", 1, "add", LOVING + ", run propagation by addition"),
    ("carry out = s >> 31", 1, "alu", BGSA + ", the add carry across words"),
    ("dv7 = (s ^ remain) & CM", 1, "alu", LOVING + ", the class hi rows"),
    ("dvm = dv7 | m", 1, "alu", LOVING + ", class hi or a match"),
    # phase A: classes 6, 5, 4, 3; class i ORs 7 - i terms dh & dv, one LOP3 a term
    ("init_i = OR of 1, 2, 3, 4 terms dh & dv", 10, "alu", LOVING + ", the run starts of class i"),
    ("x_i = (init_i << 1) | prev carry  (LEA)", 4, "alu", LOVING + ", the one-row shift"),
    ("val_i = x_i & CM", 4, "alu", BGSA + ", the 31-bit word"),
    ("prev carry out = init_i >> 30", 4, "alu", BGSA + ", the shift's carry across words"),
    ("s_i = val_i + remain + carry", 4, "add", LOVING + ", run propagation by addition"),
    ("carry out = s_i >> 31", 4, "alu", BGSA + ", the add carry across words"),
    ("dv_i = (s_i ^ remain) & ~m", 4, "alu", LOVING + ", the class i rows"),
    # the horizontal classes 2 .. 7 into planes (mapped v - lo = 7 .. 12; top plane 0)
    ("h = dvm | dv6 | dv5", 1, "alu", BGSA + ", the DV encode"),
    ("dvb3 = h | dv4 | dv3  (~dvb3 is class 2)", 1, "alu", BGSA + ", the DV encode"),
    ("dvb0 = ~dvb3 | dv4 | dv6", 1, "alu", BGSA + ", the DV encode"),
    ("dvb1 = ~dvb3 | dv5 | dv6", 1, "alu", BGSA + ", the DV encode"),
    ("dvb2 = ~dvb3 | dvm", 1, "alu", BGSA + ", the DV encode"),
    # DH + DV over the planes, clamped where it overflows
    ("sum0 = d0 ^ dvb0; c0 = d0 & dvb0", 2, "alu", BGSA + ", the first 5-plane adder"),
    ("planes 1..3: XOR3 and MAJ3", 6, "alu", BGSA + ", the first 5-plane adder"),
    ("sb_i = sum_i & ~(d4 ^ c3), planes 0..3", 4, "alu", BGSA + ", the clamp"),
    # the sum one row up, with row carries across words
    ("y_i = (sb_i << 1) | row carry  (LEA), planes 0..3", 4, "alu", LOVING + ", the one-row shift"),
    ("row carry out = sb_i >> 30, planes 0..3", 4, "alu", BGSA + ", the row carry across words"),
    # minus the mapped horizontal delta: its negation from the marks 6 and 11
    ("adj_i = d_i with lo_mid and m forced, planes 0..4", 5, "alu", BGSA + ", the negated DH"),
    ("sum0 = adj0 ^ y0; c0 = adj0 & y0", 2, "alu", BGSA + ", the second 5-plane adder"),
    ("planes 1..3: XOR3 and MAJ3", 6, "alu", BGSA + ", the second 5-plane adder"),
    ("top = adj4 ^ c3", 1, "alu", BGSA + ", the second 5-plane adder"),
    ("d_i = sum_i & top, planes 0..3", 4, "alu", BGSA + ", the clamp"),
)


def alu_per_word_column(scoring) -> int:
    """ALU-pipe instructions one word-column of the packed network needs."""
    if tuple(scoring) != SCHEME:
        raise ValueError(f"the frozen count is of {SCHEME}, not {tuple(scoring)}")
    return roofline_counts.alu_ops(PACKED_WORD_OPS)


def words(subject_len: int) -> int:
    return -(-subject_len // WORD_BITS)


def alu_ops(scoring, queries: int, query_len: int, subjects: int, subject_len: int) -> int:
    """ALU-pipe instructions that Q x S pairs need at the least: every column
    of every pair, over the words the subject length needs."""
    return (alu_per_word_column(scoring) * words(subject_len) * query_len * queries
            * subjects)


def launch_bytes(launches, query_len: int, subject_len: int) -> int:
    """Bytes a kernel launch must move at the least, summed over ``launches``
    of (queries, subjects): its Eq words and query codes read once, its
    int32 scores written once."""
    w = words(subject_len)
    return sum(roofline_counts.EQ_PLANES * w * 4 * s + q * query_len + 4 * q * s
               for q, s in launches)


def floor_s(scoring, queries, query_len, subjects, subject_len, launches, sms,
            clock_mhz) -> float:
    """The least seconds the card could take: the larger of the ALU floor at
    the peak and the bytes at the memory rate."""
    ops_s = (alu_ops(scoring, queries, query_len, subjects, subject_len)
             / roofline_counts.alu_peak(sms, clock_mhz))
    bytes_s = launch_bytes(launches, query_len, subject_len) / roofline_counts.MEMORY_BYTES_PER_S
    return max(ops_s, bytes_s)
