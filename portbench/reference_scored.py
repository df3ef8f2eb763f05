"""The plain reference for general integer scoring: the optimal global
alignment score under match M, mismatch I and a linear gap G, by the
textbook dynamic program, in plain torch int32 on the CPU or a CUDA device.
It imports nothing of the program under test.

H[i][j] is the best score of query[:i] against subject[:j]: H[i][0] = G*i,
H[0][j] = G*j, H[i][j] = max(H[i-1][j-1] + (M if q[i-1] == s[j-1] else I),
H[i-1][j] + G, H[i][j-1] + G), and the score is H[m][n]. One query row at a
time, for a block of pairs at once: the first two terms are elementwise, and
the third, a chain along the row, is a running maximum,
H[i][j] = G*j + max over l <= j of (C[l] - G*l), where C is the row of the
first two terms (C[0] = G*i): the max-plus twin of ``reference.last_row``.

``ungapped`` is the configuration's control: the sum over the positions of
M where the bases are equal and I where they differ, the answer of a kernel
that ignores insertions and deletions.
"""

from __future__ import annotations

import torch


def substitution(queries: torch.Tensor, subjects: torch.Tensor, match: int,
                 mismatch: int) -> torch.Tensor:
    """(P, 1) or (P, n) query codes against (P, n) subject codes -> (P, n)
    int32: M where the codes are equal, I where they differ."""
    return (subjects == queries).to(torch.int32) * (match - mismatch) + mismatch


def last_row(queries: torch.Tensor, subjects: torch.Tensor, match: int, mismatch: int,
             gap: int) -> torch.Tensor:
    """(P, m) and (P, n) integer codes of P pairs, on one device -> (P, n + 1)
    int32: H[m][j] for j = 0..n."""
    P, m = queries.shape
    n = subjects.shape[1]
    dev = subjects.device
    gj = gap * torch.arange(n + 1, dtype=torch.int32, device=dev)
    row = gj.expand(P, n + 1).clone()
    queries = queries.to(torch.int32)
    subjects = subjects.to(torch.int32)
    first = torch.empty((P, 1), dtype=torch.int32, device=dev)
    for i in range(1, m + 1):
        sub = substitution(queries[:, i - 1:i], subjects, match, mismatch)
        cand = torch.maximum(row[:, :-1] + sub, row[:, 1:] + gap)
        first.fill_(gap * i)
        full = torch.cat([first, cand], dim=1)
        row = torch.cummax(full - gj, dim=1).values + gj
    return row


def global_scores(queries: torch.Tensor, subjects: torch.Tensor, match: int, mismatch: int,
                  gap: int) -> torch.Tensor:
    """(P,) int32 optimal global scores, H[m][n]."""
    return last_row(queries, subjects, match, mismatch, gap)[:, -1]


def ungapped(queries: torch.Tensor, subjects: torch.Tensor, match: int,
             mismatch: int) -> torch.Tensor:
    """(P,) int32: substitutions only, on two equal-length rows."""
    if queries.shape != subjects.shape:
        raise ValueError(f"ungapped takes equal lengths, not {tuple(queries.shape)} and "
                         f"{tuple(subjects.shape)}")
    return substitution(queries, subjects, match, mismatch).sum(dim=1, dtype=torch.int32)
