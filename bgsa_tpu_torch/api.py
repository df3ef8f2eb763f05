"""In-memory API on a torch device: align sequences without temporary files.

Counterpart of ``bgsa_tpu.api.align`` for unit-cost scoring::

    import bgsa_tpu_torch
    bgsa_tpu_torch.align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"])
    # -> array([ 0, -1, -2, -3], dtype=int16)

The kernel takes any subject count, so subjects are not padded to a lane
multiple.
"""

from __future__ import annotations

import numpy as np

from bgsa_tpu.api import encode_sequences
from bgsa_tpu.schemes import Mode, Scoring, normalize

from .pipeline import Engine, PipelineConfig


def align(
    queries,
    subjects,
    *,
    scoring: Scoring = Scoring(0, -1, -1),
    mode: Mode = Mode.GLOBAL,
    k: int | None = None,
    config: PipelineConfig | None = None,
    device="cuda",
) -> np.ndarray:
    """Score queries against subjects in memory on ``device`` ("cuda" or "cpu").

    Args and result as ``bgsa_tpu.align``: (Q, S) int16 scores, or (S,) when
    ``queries`` is a single string. Unit-cost scoring (0, c, c) only; ``k``
    (banded filter) and general scoring raise NotImplementedError.
    """
    if k is not None:
        raise NotImplementedError("the banded filter (k=) is not ported yet (ROADMAP queue 1 #6)")
    single = isinstance(queries, (str, bytes)) or (
        isinstance(queries, np.ndarray)
        and queries.ndim == 1
        and queries.dtype.kind in "iu"  # a 1-D array of strings is multi-query
    )
    qcodes = encode_sequences(queries, name="queries")
    scodes = encode_sequences(subjects, name="subjects")
    engine = Engine(normalize(scoring, mode), config or PipelineConfig(), device)
    out = np.asarray(engine.scores(qcodes, scodes))
    return out[0] if single else out
