"""The plain reference: unit-cost edit distance by the textbook dynamic
program, in plain torch, for pairs of equal-length code rows. It imports
nothing of the program under test.

D[i][j] is the edit distance of query[:i] and subject[:j] (insertion,
deletion and substitution each cost 1): D[0][j] = j, D[i][0] = i,
D[i][j] = min(D[i-1][j-1] + (q[i-1] != s[j-1]), D[i-1][j] + 1, D[i][j-1] + 1).
One query row at a time, for a block of pairs at once: the first two terms
are elementwise, and the third, a chain along the row, is a running
minimum, D[i][j] = j + min over l <= j of (C[l] - l).

* Global scoring (0, -1, -1), the Myers configuration: the score is
  -D[m][n].
* The banded filter at threshold k, on a read and a candidate of equal
  length (the band's slack h = k + n - m is then k): the errors of the best
  alignment of the whole read to the candidate with up to k of the
  candidate's first bases and up to k of its last bases left out for free,
  the read-mapper's window slack. That is D with D[0][j] = max(j - k, 0),
  least over j from m - k to n of D[m][j]. A count of at most k is exact;
  a pair over k is reported as some value over k (127 where the filter's
  early exit stops it), so ``judge`` holds such a pair only to being over
  k.

The controls of ``check.py`` put ``hamming`` and ``int_narrow`` here too:
what a cheaper or narrower answer would give in the program's place.
"""

from __future__ import annotations

import torch

MAX_ERROR = 127  # the banded filter's over-budget count


def last_row(queries: torch.Tensor, subjects: torch.Tensor, free_start: int = 0) -> torch.Tensor:
    """(P, m) and (P, n) integer codes of P pairs, on one device -> (P, n + 1)
    int32: D[m][j] for j = 0..n, with D[0][j] = max(j - free_start, 0)."""
    P, m = queries.shape
    n = subjects.shape[1]
    dev = subjects.device
    j = torch.arange(n + 1, dtype=torch.int32, device=dev)
    row = (j - free_start).clamp(min=0).expand(P, n + 1).clone()
    subjects = subjects.to(torch.int32)
    queries = queries.to(torch.int32)
    first = torch.empty((P, 1), dtype=torch.int32, device=dev)
    for i in range(1, m + 1):
        cost = (subjects != queries[:, i - 1:i]).to(torch.int32)
        cand = torch.minimum(row[:, :-1] + cost, row[:, 1:] + 1)
        first.fill_(i)
        full = torch.cat([first, cand], dim=1)
        row = torch.cummin(full - j, dim=1).values + j
    return row


def global_scores(queries: torch.Tensor, subjects: torch.Tensor) -> torch.Tensor:
    """(P,) int32 unit-cost global scores, -D[m][n]."""
    return -last_row(queries, subjects)[:, -1]


def banded_errors(queries: torch.Tensor, subjects: torch.Tensor, k: int) -> torch.Tensor:
    """(P,) int32: min over j in [m - k, n] of D[m][j], the first k subject
    bases free; reads and candidates of equal length."""
    m, n = queries.shape[1], subjects.shape[1]
    if m != n:
        raise ValueError(f"the banded reference takes equal lengths, not {m} and {n}")
    return last_row(queries, subjects, k)[:, max(m - k, 0):].min(dim=1).values


def expected(kind: str, queries: torch.Tensor, subjects: torch.Tensor, k: int | None):
    """The reference's answer for each pair: the score ("myers") or the
    error count ("banded")."""
    if kind == "myers":
        return global_scores(queries, subjects)
    return banded_errors(queries, subjects, k)


def judge(kind: str, want: torch.Tensor, got: torch.Tensor, k: int | None) -> torch.Tensor:
    """(P,) bool: the program's answer ``got`` is wrong. Myers: any answer
    but the score. Banded: a count of at most k must be exact; over k, any
    answer from k + 1 to 127 stands."""
    got = got.to(torch.int32)
    if kind == "myers":
        return got != want
    within = want <= k
    return torch.where(within, got != want, (got <= k) | (got > MAX_ERROR))


def answer(kind: str, want: torch.Tensor, k: int | None) -> torch.Tensor:
    """The answer a correct program gives where the reference's is ``want``:
    the score, or the count with MAX_ERROR for every pair over k."""
    if kind == "myers":
        return want
    return torch.where(want <= k, want, torch.full_like(want, MAX_ERROR))


def hamming(queries: torch.Tensor, subjects: torch.Tensor) -> torch.Tensor:
    """(P,) int32 substitutions only: the mismatched positions of two
    equal-length rows."""
    return (queries.to(torch.int32) != subjects.to(torch.int32)).sum(dim=1, dtype=torch.int32)


def int_narrow(values: torch.Tensor, bits: int) -> torch.Tensor:
    """``values`` saturated to a signed ``bits``-bit field."""
    top = (1 << (bits - 1)) - 1
    return values.clamp(-top - 1, top)
