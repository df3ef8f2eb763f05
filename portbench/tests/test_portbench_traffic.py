"""The inputs: the same seed draws the same arrays, another seed others,
and the near candidates are what the workload asks for."""

import os

import numpy as np
import pytest

from portbench import traffic

WORKLOAD = {"queries": 5, "query_len": 150, "subjects": 1000, "subject_len": 150,
            "near_frac": 0.3, "near_edits": [0, 5], "pool": 2}


def test_same_seed_same_inputs():
    a, b = traffic.draw(WORKLOAD, 2**31 + 11), traffic.draw(WORKLOAD, 2**31 + 11)
    assert np.array_equal(a.queries, b.queries)
    assert all(np.array_equal(x, y) for x, y in zip(a.pool, b.pool))


@pytest.mark.parametrize("other", [2**31 + 12, 12, -(2**31 + 11)])
def test_other_seed_other_inputs(other):
    a, b = traffic.draw(WORKLOAD, 2**31 + 11), traffic.draw(WORKLOAD, other)
    assert not np.array_equal(a.queries, b.queries)
    assert not np.array_equal(a.pool[0], b.pool[0])


def test_pool_batches_differ():
    inputs = traffic.draw(WORKLOAD, 5)
    assert len(inputs.pool) == 2 and not np.array_equal(inputs.pool[0], inputs.pool[1])


def test_near_candidates():
    inputs = traffic.draw(WORKLOAD, 7)
    q, s = inputs.queries, inputs.pool[0]
    assert q.dtype == s.dtype == np.uint8 and q.max() <= 3 and s.max() <= 3
    # each subject's fewest differing positions against any query
    diff = (s[:, None, :] != q[None, :, :]).sum(axis=2).min(axis=1)
    near = diff <= 5
    assert near.sum() == 300  # random 150 bp rows differ in ~112 positions
    assert (diff[~near] > 60).all()
    assert set(np.unique(diff[near])) <= set(range(6)) and (diff[near] == 5).any()


def test_substitute_counts():
    rng = np.random.default_rng(3)
    rows = np.zeros((2000, 150), np.uint8)
    traffic.substitute(rows, [2, 4], rng)
    changed = (rows != 0).sum(axis=1)
    assert changed.max() <= 4  # a substitution may draw the base already there
    assert changed.mean() > 2.0


def test_write_lines(tmp_path):
    codes = np.array([[0, 1, 2, 3], [3, 3, 0, 1]], np.uint8)
    path = os.path.join(tmp_path, "x.txt")
    traffic.write_lines(path, codes, chunk=1)
    assert open(path, "rb").read() == b"ACGT\nTTAC\n"
