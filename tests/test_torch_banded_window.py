"""The packed banded kernel's window fold and its cost probes, on the CPU.

The kernel (``csrc/banded_packed.cu``) loads the two stream words of every
code and field once per 32-column window w = min(t >> 5, W - 2) and folds
each column from them. ``ops.banded_packed.windowed_columns`` is that
schedule in plain torch (the unscored head, the 32-column latch batches
from min(k, q_len), the tail); it must give every column the register the
per-column fold gives (``packed_window``) bit for bit, also where the
batches do not start on a window and where the window is clamped at the
last word pair. The probes' plain versions (``banded_packed_probe_ref``)
are held to the shipping plain version where no latch intervenes.
"""

import numpy as np
import pytest
import torch

from bgsa_tpu_torch.banded_ref import MAX_ERROR
from bgsa_tpu_torch.ops import banded_packed as bp
from bgsa_tpu_torch.ops import banded_packed_pair as bpp
from bgsa_tpu_torch.ops.banded import MASK32, geometry

# (q_len, s_len, k) of n_sub 2 to 8 and 16, min(k, q_len) never a multiple
# of 32
GEOMETRIES = [(150, 158, 8), (150, 150, 8), (150, 150, 7), (72, 72, 5), (100, 100, 4),
              (40, 44, 4), (3, 5, 4), (100, 100, 3), (7, 7, 1)]


def streams_for(rng, m, n, k, S_sub=9):
    n_sub = bp.packed_subbands(m, n, k)
    codes = torch.from_numpy(rng.integers(0, 5, size=(n_sub * S_sub, n)).astype(np.int32))
    return bp.pack_packed_streams(codes, k, m, n_sub)


def folds(st, m, n, k):
    """{t: the window fold's registers} and the per-column ones."""
    _, band_down, _ = geometry(m, n, k)
    pitch, wmask = band_down + 2, (1 << (band_down + 1)) - 1
    windowed = list(bp.windowed_columns(st, q_len=m, s_len=n, k=k))
    return windowed, [bp.packed_window(st, t, pitch, wmask) for t in range(m)]


@pytest.mark.parametrize("m,n,k", GEOMETRIES)
def test_window_fold_equals_per_column_fold(m, n, k):
    rng = np.random.default_rng(m + n + k)
    streams = streams_for(rng, m, n, k)
    assert streams.shape[0] == bp.packed_subbands(m, n, k)
    windowed, per_column = folds(streams.long() & MASK32, m, n, k)
    assert [t for t, _ in windowed] == list(range(m))  # every column, in order
    for (t, got), want in zip(windowed, per_column):
        assert torch.equal(got, want), t


@pytest.mark.parametrize("W", [3, 4])
@pytest.mark.parametrize("m,n,k", [(150, 150, 8), (100, 100, 4)])
def test_window_fold_clamps_at_the_last_word_pair(m, n, k, W):
    # streams of few words (random words, no packer: the packer leaves room),
    # so columns past 32 (W - 1) share the last pair, shifted further
    rng = np.random.default_rng(W)
    n_sub = bp.packed_subbands(m, n, k)
    st = torch.from_numpy(rng.integers(0, 1 << 32, size=(n_sub, 5, W, 6), dtype=np.int64))
    assert any((t >> 5) > W - 2 for t in range(m))
    windowed, per_column = folds(st, m, n, k)
    for (t, got), want in zip(windowed, per_column):
        assert torch.equal(got, want), t


def test_codes_outside_0_to_4_match_nothing():
    rng = np.random.default_rng(5)
    fields = torch.from_numpy(rng.integers(1, 1 << 40, size=(5, 7), dtype=np.int64))
    got = bp.column_eq(fields, torch.tensor([0, 4, 5, 2, 9]))
    assert torch.equal(got[[0, 1, 3]], fields[[0, 4, 2]])
    assert int(got[[2, 4]].abs().sum()) == 0


@pytest.mark.parametrize("m,n,k", GEOMETRIES)
def test_packed_probes_plain_versions(m, n, k):
    rng = np.random.default_rng(2 * m + k)
    streams = streams_for(rng, m, n, k)
    q = torch.from_numpy(rng.integers(0, 4, size=(3, m)).astype(np.int32))
    kw = dict(q_len=m, s_len=n, k=k)
    shipping = bp.banded_stream_packed_ref(streams, q, **kw)
    probes = {mode: bpp.banded_packed_probe(streams, q, mode=mode, **kw)
              for mode in bpp.PROBE_MODES}
    assert all(out.shape == shipping.shape for out in probes.values())
    # full: the shipping column without the latch (a probe's score is the
    # band's minimum, which random subjects take past MAX_ERROR)
    live = shipping != MAX_ERROR
    assert torch.equal(probes["full"][live], shipping[live])
    # static_c: full on code 0 every column
    zeros = torch.zeros_like(q)
    assert torch.equal(probes["static_c"],
                       bpp.banded_packed_probe_ref(streams, zeros, mode="full", **kw))
    # noload: every query alike (code 0's register at column 0 every column)
    assert torch.equal(probes["noload"], probes["noload"][:1].expand_as(probes["noload"]))


def test_packed_probe_checks_its_mode():
    rng = np.random.default_rng(0)
    streams = streams_for(rng, 40, 44, 4)
    q = torch.zeros((1, 40), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode must be one of"):
        bpp.banded_packed_probe(streams, q, q_len=40, s_len=44, k=4, mode="fast")
    before = dict(bpp.PROBE_LAUNCHES)
    bpp.banded_packed_probe(streams, q, q_len=40, s_len=44, k=4, mode="full")
    assert bpp.PROBE_LAUNCHES == before  # no kernel on a CPU tensor
