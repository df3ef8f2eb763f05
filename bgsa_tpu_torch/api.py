"""In-memory API on a torch device: align sequences without temporary files.

Counterpart of ``bgsa_tpu.api.align``: unit-cost scoring (Myers), general
integer scoring (BitPAl) and the banded filter::

    import bgsa_tpu_torch
    from bgsa_tpu.schemes import Scoring
    bgsa_tpu_torch.align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"])
    # -> array([ 0, -1, -2, -3], dtype=int16)
    bgsa_tpu_torch.align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"], scoring=Scoring(2, -3, -5))
    # -> array([ 8,  3, -2, -7], dtype=int16)
    bgsa_tpu_torch.align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"], k=1)
    # -> array([0, 1, 2, 3], dtype=int8)

The kernel takes any subject count, so subjects are not padded to a lane
multiple.
"""

from __future__ import annotations

import numpy as np

from bgsa_tpu.api import encode_sequences
from bgsa_tpu.schemes import Mode, Scoring, normalize

from .banded_pipeline import BandedEngine
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
    ``queries`` is a single string. Unit-cost ``scoring`` (0, c, c) runs the
    Myers kernel, any other the BitPAl kernels (``config.bitpal_packed`` and
    ``config.bitpal_carry`` as in ``bgsa_tpu``). With ``k`` (banded filter;
    scoring and mode are ignored) the scores are int8 error counts, 127 =
    over budget.
    """
    single = isinstance(queries, (str, bytes)) or (
        isinstance(queries, np.ndarray)
        and queries.ndim == 1
        and queries.dtype.kind in "iu"  # a 1-D array of strings is multi-query
    )
    qcodes = encode_sequences(queries, name="queries")
    scodes = encode_sequences(subjects, name="subjects")
    config = config or PipelineConfig()
    if k is not None:
        engine = BandedEngine(k, config, device)
    else:
        engine = Engine(normalize(scoring, mode), config, device)
    out = np.asarray(engine.scores(qcodes, scodes))
    return out[0] if single else out
