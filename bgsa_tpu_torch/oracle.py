"""NumPy O(m*n) alignment-score oracles used by the test suite.

The reference ships no correctness tests at all (see SURVEY.md §4); these
oracles are the golden model our bit-parallel kernels are checked against.
They implement the same DP the reference kernels compute implicitly:

* rows = subject positions, columns = query positions (the bitvectors in
  ``/root/reference/original/BGSA_CPU/align_core.c:19-148`` span the subject),
* global mode scores cell ``(n, m)``; semi-global mode leaves the top row free
  (subject may start anywhere in the query) and takes the best last-row cell,
  matching the generator's semi-global formulation
  (``generator/.../MyersGenerator.java:56-223``).

Vectorized across a batch of subjects; the inner column dependency (linear gap
chain) is solved with a prefix-max, so the sweep is O(m) NumPy ops.

The port's own copy of ``bgsa_tpu.oracle``, same behaviour.
"""

from __future__ import annotations

import numpy as np

from .schemes import Mode, Scoring


def align_scores(
    query: np.ndarray,
    subjects: np.ndarray,
    scoring: Scoring = Scoring(),
    mode: Mode = Mode.GLOBAL,
) -> np.ndarray:
    """Alignment scores of one query against a batch of subjects.

    Args:
      query: int array of shape (m,), symbol codes.
      subjects: int array of shape (B, n), symbol codes.
      scoring: match/mismatch/gap weights (linear gap).
      mode: GLOBAL or SEMI_GLOBAL.

    Returns:
      int64 array of shape (B,) of DP scores (max formulation).
    """
    query = np.asarray(query)
    subjects = np.atleast_2d(np.asarray(subjects))
    m = query.shape[0]
    bsz, n = subjects.shape
    M, I, G = scoring.match, scoring.mismatch, scoring.gap

    gaps = np.arange(n + 1, dtype=np.int64) * G
    col = np.broadcast_to(gaps, (bsz, n + 1)).copy()  # column j = 0
    if mode is Mode.SEMI_GLOBAL:
        best_last = col[:, n].copy()

    for j in range(1, m + 1):
        qc = query[j - 1]
        sub_score = np.where(subjects == qc, M, I).astype(np.int64)
        diag = col[:, :-1] + sub_score
        up = col[:, 1:] + G
        cand = np.maximum(diag, up)
        new0 = np.int64(0) if mode is Mode.SEMI_GLOBAL else np.int64(j) * G
        full = np.concatenate([np.full((bsz, 1), new0, dtype=np.int64), cand], axis=1)
        # Resolve within-column gap chain: new[i] = max_{k<=i} full[k] + (i-k)*G.
        t = full - gaps
        col = np.maximum.accumulate(t, axis=1) + gaps
        if mode is Mode.SEMI_GLOBAL:
            best_last = np.maximum(best_last, col[:, n])

    if mode is Mode.SEMI_GLOBAL:
        return best_last
    return col[:, n]


def edit_distances(query: np.ndarray, subjects: np.ndarray, mode: Mode = Mode.GLOBAL) -> np.ndarray:
    """Unit-cost Levenshtein distances (the quantity Myers kernels compute)."""
    return -align_scores(query, subjects, Scoring(0, -1, -1), mode)


def align_scores_query_in_subject(
    query: np.ndarray, subjects: np.ndarray, scoring: Scoring = Scoring()
) -> np.ndarray:
    """BitPAl's semi-global semantics: full query, subject ends free.

    The reference's two families disagree on what "semi-global" frees: Myers
    semi-global leaves the *query* ends free (subject-in-query,
    MyersGenerator.java:56-223), BitPAl semi-global initializes the first
    column to zero and maxes down the final column (query-in-subject,
    BitPAlGenerator genUnpackedScore). DP: S[i][0] = 0, S[0][j] = j*G,
    result = max_i S[i][m].
    """
    query = np.asarray(query)
    subjects = np.atleast_2d(np.asarray(subjects))
    m = query.shape[0]
    bsz, n = subjects.shape
    M, I, G = scoring.match, scoring.mismatch, scoring.gap
    gaps = np.arange(n + 1, dtype=np.int64) * G
    col = np.zeros((bsz, n + 1), dtype=np.int64)
    for j in range(1, m + 1):
        qc = query[j - 1]
        sub_score = np.where(subjects == qc, M, I).astype(np.int64)
        diag = col[:, :-1] + sub_score
        up = col[:, 1:] + G
        cand = np.maximum(diag, up)
        full = np.concatenate(
            [np.full((bsz, 1), np.int64(j) * G, dtype=np.int64), cand], axis=1
        )
        t = full - gaps
        col = np.maximum.accumulate(t, axis=1) + gaps
    return col.max(axis=1)
