"""The benchmark's inputs, drawn from ``--seed``: one general generator that
every workload file parameterises.

A workload's queries are uniform random bases. Its subjects come in
``pool`` batches; in each, ``near_frac`` of the rows copy one query (row i
copies query i mod Q) with ``near_edits`` = [lo, hi] substitutions at
distinct random positions (a substitution may draw the base already there),
and the rest are uniform random; the rows are then shuffled. That is the
read-filter mix of ``bgsa_tpu_torch.benchutil.filter_mix_dataset``, drawn
with whole-array numpy calls instead of a loop over candidates. The codes
are 0..3 for A, C, G, T.

``write_lines`` is ``scripts/make_testdata.py``'s writer, taking the codes
drawn here instead of drawing them itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


@dataclasses.dataclass
class Inputs:
    queries: np.ndarray  # (Q, m) uint8 codes
    pool: list  # subject batches, each (S, n) uint8 codes


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one stream of a seed (0: the inputs; others: the
    check's samples), for any whole number given as ``--seed``."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def substitute(rows: np.ndarray, edits, rng) -> None:
    """In place: each row gets between ``edits[0]`` and ``edits[1]``
    substitutions at distinct positions, each a uniform random base."""
    lo, hi = edits
    n_rows, length = rows.shape
    if hi <= 0 or n_rows == 0:
        return
    counts = rng.integers(lo, hi + 1, size=n_rows)
    pos = rng.integers(0, length, size=(n_rows, hi))
    while True:  # redraw the rows whose positions repeat
        srt = np.sort(pos, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup.any():
            break
        pos[dup] = rng.integers(0, length, size=(int(dup.sum()), hi))
    bases = rng.integers(0, 4, size=(n_rows, hi), dtype=np.uint8)
    use = np.arange(hi) < counts[:, None]
    r = np.broadcast_to(np.arange(n_rows)[:, None], pos.shape)
    rows[r[use], pos[use]] = bases[use]


def draw(workload: dict, seed: int) -> Inputs:
    """The inputs of ``workload`` (its ``queries``, ``query_len``,
    ``subjects``, ``subject_len``, ``near_frac``, ``near_edits`` and
    ``pool``) for ``seed``: the same seed gives the same arrays."""
    rng = rng_for(seed)
    Q, m = workload["queries"], workload["query_len"]
    S, n = workload["subjects"], workload["subject_len"]
    queries = rng.integers(0, 4, size=(Q, m), dtype=np.uint8)
    n_near = int(S * workload.get("near_frac", 0.0))
    if n_near and m != n:
        raise ValueError("near candidates copy a query: query_len must equal subject_len")
    pool = []
    for _ in range(workload.get("pool", 1)):
        subjects = rng.integers(0, 4, size=(S, n), dtype=np.uint8)
        if n_near:
            subjects[:n_near] = queries[np.arange(n_near) % Q]
            substitute(subjects[:n_near], workload.get("near_edits", [0, 0]), rng)
            subjects = subjects[rng.permutation(S)]
        pool.append(subjects)
    return Inputs(queries, pool)


def write_lines(path: str, codes: np.ndarray, chunk: int = 1_000_000) -> None:
    """One line of bases per row of ``codes``, as the aligner's readers take
    them (fixed length, LF endings)."""
    count, length = codes.shape
    with open(path, "wb") as f:
        for start in range(0, count, chunk):
            part = codes[start:start + chunk]
            buf = np.empty((len(part), length + 1), np.uint8)
            buf[:, :length] = BASES[part]
            buf[:, length] = ord("\n")
            f.write(buf.tobytes())
