"""What decides ``correct``: the program's answers against the plain
reference (``reference.py``), and the controls that must fail the same
comparison.

* ``read_result``: the benchmark's own reader of the reference's result
  format (``cal_cpu.c``'s writer): ``<result>.info`` is int32 block_num,
  int32 device_num, int64 ref_count, then per database block device_num
  int64 subject counts and an int32 count of 'N' pad subjects at its end;
  the result file holds, per block, per tile of 100 queries, a (queries,
  subjects) matrix of scores, query-major. Every way the pair disagrees
  with the inputs is a layout error.
* ``mismatches``: the reference's answers for the pairs asked, worked out
  on ``device`` in blocks, judged against the program's.
* Controls (``control_answers``): the reference in the program's place,
  breaking one guarantee the configuration states. "hamming": the Myers
  score with insertions and deletions ignored (substitutions only, the
  popcount a cheaper kernel would take). "int4": the banded counts in a
  signed 4-bit field (127, over budget, saturates to 7, a count within
  k = 8).
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from . import reference

REF_TILE = 100  # queries a tile of the result file (the reference's REF_BUCKET_COUNT)
PAIR_CELLS = 1 << 26  # reference DP cells a block: 256 MB of int32 a row tensor


def kind_of(config: dict) -> str:
    """"banded" or "myers": the reference's two kinds of answer. It covers
    unit-cost global scoring only."""
    if config["algorithm"] == "banded":
        return "banded"
    if config["algorithm"] == "myers" and config["mode"] == "global" and \
            config["scoring"] == {"match": 0, "mismatch": -1, "gap": -1}:
        return "myers"
    raise ValueError(f"the reference has no answers for configuration {config['name']!r}")


class ResultFile:
    """A result file whose layout agrees with the inputs."""

    def __init__(self, path: str, dtype, queries: int, counts: np.ndarray):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.queries, self.counts = queries, counts
        self.starts = np.concatenate([[0], np.cumsum(counts)])
        # (queries, subjects) of each kernel launch: a tile of a block
        self.launches = [(min(REF_TILE, queries - t), int(c)) for c in counts
                         for t in range(0, queries, REF_TILE)]

    def scores(self, q, s) -> np.ndarray:
        """The answers of pairs (q, s), index arrays in input order."""
        b = np.searchsorted(self.starts, s, side="right") - 1
        start = self.starts[b]
        return np.asarray(self.data[start * self.queries + q * self.counts[b] + (s - start)])


def read_result(path: str, queries: int, subjects: int, dtype):
    """(layout errors, ResultFile or None where the layout is broken) of a
    result file and its .info."""
    info = path + ".info"
    if not (os.path.exists(path) and os.path.exists(info)):
        return 1, None
    with open(info, "rb") as f:
        raw = f.read()
    if len(raw) < 16:
        return 1, None
    blocks, devices, ref_count = struct.unpack_from("<iiq", raw)
    errors = int(devices != 1) + int(ref_count != queries)
    record = 8 * max(devices, 1) + 4
    if blocks < 1 or len(raw) != 16 + blocks * record:
        return errors + 1, None
    counts, extras = [], []
    for b in range(blocks):
        rec = raw[16 + b * record:16 + (b + 1) * record]
        counts.append(sum(struct.unpack_from(f"<{max(devices, 1)}q", rec)))
        extras.append(struct.unpack_from("<i", rec, record - 4)[0])
    counts, extras = np.array(counts, np.int64), np.array(extras, np.int64)
    errors += int(counts.sum() - extras.sum() != subjects)
    errors += int((extras[:-1] != 0).any() or extras[-1] < 0 or extras[-1] >= counts[-1])
    itemsize = np.dtype(dtype).itemsize
    errors += int(os.path.getsize(path) != itemsize * queries * int(counts.sum()))
    if errors:
        return errors, None
    return 0, ResultFile(path, dtype, queries, counts)


def sample_pairs(queries: int, subjects: int, n_subjects: int, rng):
    """Every query against ``n_subjects`` subjects drawn without replacement
    (all of them where n_subjects is 0): (q, s) index arrays."""
    picked = np.arange(subjects) if not n_subjects else np.sort(
        rng.choice(subjects, size=min(n_subjects, subjects), replace=False))
    q, s = np.meshgrid(np.arange(queries), picked, indexing="ij")
    return q.ravel(), s.ravel()


def want(kind: str, k, queries: np.ndarray, subjects: np.ndarray, q, s, device) -> torch.Tensor:
    """The reference's answers for the pairs (queries[q], subjects[s]), on
    the CPU: worked out on ``device`` a block of pairs at a time."""
    n = subjects.shape[1]
    block = max(1, PAIR_CELLS // (n + 1))
    out = []
    for lo in range(0, len(q), block):
        qs = torch.from_numpy(queries[q[lo:lo + block]]).to(device)
        ss = torch.from_numpy(subjects[s[lo:lo + block]]).to(device)
        out.append(reference.expected(kind, qs, ss, k).cpu())
    return torch.cat(out) if out else torch.empty(0, dtype=torch.int32)


def mismatches(kind: str, k, wanted: torch.Tensor, got) -> int:
    """How many of the answers ``got`` the reference judges wrong."""
    got = torch.as_tensor(np.asarray(got)).reshape(-1)
    if got.numel() != wanted.numel():
        return wanted.numel()
    return int(reference.judge(kind, wanted, got, k).sum())


def control_answers(control: str, kind: str, k, queries, subjects, q, s, wanted) -> torch.Tensor:
    """The control's answers for the pairs: the reference in the program's
    place with one stated guarantee broken."""
    if control == "hamming":
        return -reference.hamming(torch.from_numpy(queries[q]), torch.from_numpy(subjects[s]))
    if control == "int4":
        return reference.int_narrow(reference.answer(kind, wanted, k), 4)
    raise ValueError(f"no control {control!r}")
