"""In-memory API on torch devices: align sequences without temporary files.

Counterpart of ``bgsa_tpu.api.align``: unit-cost scoring (Myers), general
integer scoring (BitPAl) and the banded filter::

    import bgsa_tpu_torch
    from bgsa_tpu_torch import Scoring
    bgsa_tpu_torch.align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"])
    # -> array([ 0, -1, -2, -3], dtype=int16)
    bgsa_tpu_torch.align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"], scoring=Scoring(2, -3, -5))
    # -> array([ 8,  3, -2, -7], dtype=int16)
    bgsa_tpu_torch.align("AAAA", ["AAAA", "AACA", "CAAC", "AGGG"], k=1)
    # -> array([0, 1, 2, 3], dtype=int8)

The kernels take any subject count, so subjects are padded only to a
multiple of the shard count (code 0 rows, sliced off the result).
"""

from __future__ import annotations

import numpy as np

from . import pack
from .banded_pipeline import BandedEngine
from .pipeline import Engine, PipelineConfig
from .schemes import Mode, Scoring, normalize


def encode_sequences(seqs, *, name: str = "sequences") -> np.ndarray:
    """Strings / bytes / code arrays -> (count, len) int32 symbol codes (the
    port's own copy of ``bgsa_tpu.api.encode_sequences``).

    Accepts a single string, an iterable of equal-length strings/bytes, or an
    integer array already holding codes 0..4 (A,C,G,T,N — pack.MAPPING).
    """
    if isinstance(seqs, (str, bytes)):
        seqs = [seqs]
    if isinstance(seqs, np.ndarray) and seqs.dtype.kind in "iu":
        arr = np.atleast_2d(seqs).astype(np.int32)
        if arr.min() < 0 or arr.max() > 4:
            raise ValueError(f"{name}: integer codes must be in 0..4")
        return arr
    rows = [s.encode() if isinstance(s, str) else bytes(s) for s in seqs]
    if not rows:
        raise ValueError(f"{name}: empty")
    length = len(rows[0])
    if any(len(r) != length for r in rows):
        raise ValueError(f"{name}: all sequences must have the same length")
    buf = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(len(rows), length)
    return pack.encode_ascii(buf).astype(np.int32)


def align(
    queries,
    subjects,
    *,
    scoring: Scoring = Scoring(0, -1, -1),
    mode: Mode = Mode.GLOBAL,
    k: int | None = None,
    config: PipelineConfig | None = None,
    device="cuda",
    devices=None,
) -> np.ndarray:
    """Score queries against subjects in memory on ``device`` ("cuda" or
    "cpu"), or split over ``config.local_shards`` devices or the
    ``devices`` given.

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
        engine = BandedEngine(k, config, device, devices=devices)
    else:
        engine = Engine(normalize(scoring, mode), config, device, devices=devices)
    real = scodes.shape[0]
    pad = -real % engine.n_shards
    if pad:  # code 0, not 'N': keeps N-free batches on the 2-bit transport
        scodes = np.concatenate([scodes, np.zeros((pad, scodes.shape[1]), np.int32)])
    out = np.asarray(engine.scores(qcodes, scodes))[:, :real]
    return out[0] if single else out
