"""The plain reference against a brute-force dynamic program, and the
banded judge against the program's own bit-level model on the cells'
geometry (150 bp, k = 8, substitutions)."""

import numpy as np
import pytest
import torch

from portbench import reference


def brute(q, s, free_start=0):
    """D[m][j] for j = 0..n by the cell-by-cell recurrence, the first
    ``free_start`` subject bases free."""
    m, n = len(q), len(s)
    prev = [max(j - free_start, 0) for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j - 1] + (q[i - 1] != s[j - 1]), prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return prev


def pairs(seed, count, m, n):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (count, m), dtype=np.uint8)
    s = rng.integers(0, 4, (count, n), dtype=np.uint8)
    s[: count // 2, : min(m, n)] = q[: count // 2, : min(m, n)]  # near pairs
    for i in range(count // 2):
        pos = rng.integers(0, n, size=int(rng.integers(0, 6)))
        s[i, pos] = rng.integers(0, 4, size=len(pos))
    return q, s


@pytest.mark.parametrize("m,n", [(1, 1), (7, 7), (20, 33), (33, 20), (40, 40)])
def test_last_row_equals_brute_force(m, n):
    q, s = pairs(m * 100 + n, 24, m, n)
    got = reference.last_row(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    want = np.array([brute(list(a), list(b)) for a, b in zip(q, s)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [0, 3, 8])
def test_banded_errors_equal_brute_force(k):
    q, s = pairs(k, 32, 40, 40)
    got = reference.banded_errors(torch.from_numpy(q), torch.from_numpy(s), k).numpy()
    want = [min(brute(list(a), list(b), k)[40 - k:]) for a, b in zip(q, s)]
    assert list(got) == want


def test_banded_errors_leave_the_window_slack_free():
    """A read that starts one base into the candidate, and ends one base
    short of it, costs no errors for the slack; global edit distance
    counts both."""
    q = torch.tensor([[1, 2, 3, 0, 1, 2]], dtype=torch.uint8)
    s = torch.tensor([[3, 1, 2, 3, 0, 1]], dtype=torch.uint8)
    assert reference.banded_errors(q, s, 1).tolist() == [1]
    assert reference.banded_errors(q, s, 2).tolist() == [1]
    assert reference.global_scores(q, s).tolist() == [-2]
    with pytest.raises(ValueError):
        reference.banded_errors(q, s[:, :5], 2)


def test_global_scores_negate_the_distance():
    q = torch.tensor([[0, 0, 0, 0]] * 4, dtype=torch.uint8)
    s = torch.tensor([[0, 0, 0, 0], [0, 0, 1, 0], [1, 0, 0, 1], [0, 2, 2, 2]], dtype=torch.uint8)
    assert reference.global_scores(q, s).tolist() == [0, -1, -2, -3]


def test_judge_banded():
    want = torch.tensor([0, 5, 8, 9, 60, 60, 60])
    got = torch.tensor([0, 5, 8, 10, 127, 8, -128], dtype=torch.int8)
    assert reference.judge("banded", want, got, 8).tolist() == [
        False, False, False, False, False, True, True]


def test_banded_judge_agrees_with_the_bit_level_model():
    """At the cells' geometry (150 bp, k = 8, equal lengths, 0-5 and more
    substitutions, and random pairs) the program's own model of the
    reference kernel (``bgsa_tpu_torch.banded_ref``, read here only) gives
    what the judge accepts."""
    from bgsa_tpu_torch.banded_ref import banded_score

    rng = np.random.default_rng(21)
    q = rng.integers(0, 4, (120, 150), dtype=np.uint8)
    s = rng.integers(0, 4, (120, 150), dtype=np.uint8)
    for i in range(80):
        s[i] = q[i]
        zone = (3, 12, 150)[i % 3]  # substitutions crowded at the start, where the slack is
        pos = rng.choice(zone, size=min(zone, int(rng.integers(0, 6 if i < 60 else 14))),
                         replace=False)
        s[i, pos] = rng.integers(0, 4, size=len(pos))
    s[:3, 0], s[:3, 1] = (q[:3, 0] + 1) % 4, q[:3, 0]  # the read starts a base in
    model = torch.tensor([banded_score(list(a), list(b), 8) for a, b in zip(q, s)])
    want = reference.banded_errors(torch.from_numpy(q), torch.from_numpy(s), 8)
    assert not reference.judge("banded", want, model, 8).any()
    assert (model == 127).sum() >= 40 and (want <= 8).sum() >= 60


def test_controls():
    q = torch.tensor([[0, 1, 2, 3]], dtype=torch.uint8)
    s = torch.tensor([[1, 2, 3, 0]], dtype=torch.uint8)
    assert reference.hamming(q, s).tolist() == [4]
    assert reference.global_scores(q, s).tolist() == [-2]
    assert reference.int_narrow(torch.tensor([127, 7, -9]), 4).tolist() == [7, 7, -8]
