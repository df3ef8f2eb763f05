"""bgsa_tpu_torch.ops.myers_semiglobal against bgsa_tpu.ops.myers_semiglobal.

The plain torch version is held against the JAX XLA twin and the Pallas
kernel in interpret mode (as tests/test_semiglobal.py runs it), on the same
numpy-seeded inputs. Integer scores: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu import oracle
from bgsa_tpu import pack as host_pack
from bgsa_tpu.ops import myers_semiglobal as jax_sg
from bgsa_tpu.schemes import Mode
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.ops import myers_semiglobal as sg

S = 128


def inputs(seed, Q, m, n, *, carry_cases=False):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n)).astype(np.int32)
    s[rng.random((S, n)) < 0.03] = 4  # N in subjects
    q[0, 1] = 4  # and in a query
    if carry_cases:
        # all-ones carry chains: a subject equal to the query, one of one base
        s[0] = q[0, :n]
        s[1] = 2
        s[2] = 4
    return q, s


def port(q, s, n, **kw):
    eq = pack.eq_from_numpy(host_pack.pack_eq(s, 32))
    return sg.myers_semiglobal_ref(eq, torch.from_numpy(q), read_len=n, **kw).numpy()


@pytest.mark.parametrize("n", [20, 64, 500])  # W = 1, 2, 16
@pytest.mark.parametrize("is_global", [True, False])
def test_ref_matches_xla(n, is_global):
    q, s = inputs(n, 3, n, n, carry_cases=True)
    eq = host_pack.pack_eq(s, 32)
    want = np.asarray(jax_sg.myers_semiglobal_xla(eq, q, read_len=n, is_global=is_global))
    np.testing.assert_array_equal(port(q, s, n, is_global=is_global), want)


@pytest.mark.parametrize("n", [20, 64, 500])
@pytest.mark.parametrize("is_global", [True, False])
def test_ref_matches_pallas_interpret(n, is_global):
    q, s = inputs(1000 + n, 2, 24, n)
    eq = host_pack.pack_eq(s, 32)
    want = np.asarray(
        jax_sg.myers_semiglobal(eq, q, read_len=n, is_global=is_global, interpret=True)
    )
    np.testing.assert_array_equal(port(q, s, n, is_global=is_global), want)


@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.SEMI_GLOBAL])
def test_carry_cases_match_oracle(mode):
    q, s = inputs(5, 2, 33, 33, carry_cases=True)
    got = port(q, s, 33, factor=1, is_global=mode is Mode.GLOBAL)
    want = np.stack([oracle.edit_distances(qi, s, mode) for qi in q])
    np.testing.assert_array_equal(got, want)
    if mode is Mode.GLOBAL:
        assert got[0, 0] == 0 and got[0, 1] == 33 - int(np.sum(q[0] == 2))


def test_wrapper_dispatches_cpu_to_ref():
    q, s = inputs(9, 2, 30, 40)
    eq = pack.eq_from_numpy(host_pack.pack_eq(s, 32))
    qt = torch.from_numpy(q)
    before = sg.LAUNCHES
    got = sg.myers_semiglobal(eq, qt, read_len=40, factor=1)
    want = sg.myers_semiglobal_ref(eq, qt, read_len=40, factor=1)
    assert torch.equal(got, want) and got.dtype == torch.int32
    assert sg.LAUNCHES == before  # the plain version is no kernel launch


def test_wrapper_rejects_bad_inputs():
    eq = torch.zeros((5, 2, 8), dtype=torch.int32)
    q = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="read_len"):
        sg.myers_semiglobal(eq, q, read_len=70)
    with pytest.raises(ValueError, match="int32"):
        sg.myers_semiglobal(eq.to(torch.int64), q, read_len=40)
    with pytest.raises(ValueError, match="device"):
        sg.myers_semiglobal(eq.to("meta"), q, read_len=40)
