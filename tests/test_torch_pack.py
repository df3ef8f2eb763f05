"""bgsa_tpu_torch.pack against bgsa_tpu.pack (jnp device half, numpy host half).

Integer codes and words: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bgsa_tpu import pack as ref
from bgsa_tpu_torch import pack

LENGTHS = [1, 31, 32, 33, 61]


def codes(seed, S, n, with_n):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=(S, n)).astype(np.uint8)
    if with_n:
        c[rng.random((S, n)) < 0.05] = 4
        c[0, n - 1] = 4
    return c


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("with_n", [False, True])
def test_transport_unpack_matches_jax(n, with_n):
    # S large enough that rare-N batches ride the 2-bit + sidecar transport
    c = codes(n, 2048 if with_n else 64, n, with_n)
    for allow_sidecar in (True, False):
        name, payload = ref.select_transport(c, allow_sidecar=allow_sidecar)
        want = np.asarray(ref.transport_unpack_jax(name)(payload, n))
        tp = tuple(map(torch.from_numpy, payload)) if name == "2bitN" else torch.from_numpy(payload)
        got = pack.transport_unpack(name)(tp, n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), c)


def test_rare_n_rides_the_sidecar_transport():
    c = codes(7, 2048, 61, with_n=True)
    c[c == 4] = 0
    c[::97, 5] = 4
    name, payload = ref.select_transport(c)
    assert name == "2bitN"
    got = pack.two_bit_sidecar_unpack(tuple(map(torch.from_numpy, payload)), 61)
    np.testing.assert_array_equal(got.numpy(), c)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("with_n", [False, True])
def test_pack_eq_matches_jax_and_numpy(n, with_n):
    c = codes(100 + n, 40, n, with_n)
    got = pack.pack_eq(torch.from_numpy(c.astype(np.int32)), 32)
    assert got.dtype == torch.int32 and got.shape == (5, -(-n // 32), 40)
    want_np = ref.pack_eq(c, 32)
    want_jax = np.asarray(ref.pack_eq_jax(jnp.asarray(c), 32))
    np.testing.assert_array_equal(pack.eq_to_numpy(got), want_np)
    np.testing.assert_array_equal(pack.eq_to_numpy(got), want_jax)


def test_pack_eq_bit_31():
    # one subject of 32 'A's sets every bit of its plane-0 word: bit 31 included
    c = np.zeros((2, 32), np.int32)
    c[1] = 3
    got = pack.eq_to_numpy(pack.pack_eq(torch.from_numpy(c), 32))
    assert got[0, 0, 0] == 0xFFFFFFFF and got[3, 0, 1] == 0xFFFFFFFF
    assert got[0, 0, 1] == 0 and got[3, 0, 0] == 0
    np.testing.assert_array_equal(got, ref.pack_eq(c, 32))


def test_eq_numpy_round_trip():
    eq = np.array([[[0, 1, 0x80000000, 0xFFFFFFFF]]] * 5, np.uint32)
    t = pack.eq_from_numpy(eq)
    assert t.dtype == torch.int32 and t[0, 0, 2] == -(2**31) and t[0, 0, 3] == -1
    np.testing.assert_array_equal(pack.eq_to_numpy(t), eq)
