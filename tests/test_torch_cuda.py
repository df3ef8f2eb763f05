"""The CUDA kernels on the card. Each test skips where no CUDA device is.

Run on a machine with a GPU: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Integer scores: kernel and plain version must be equal (tolerance 0).
"""

import functools
import statistics

import numpy as np
import pytest
import torch

from bgsa_tpu_torch.benchutil import filter_mix_dataset, graph_times_ms
from bgsa_tpu_torch import debug, pack, roofline
from bgsa_tpu_torch.banded_pipeline import KERNELS, BandedEngine
from bgsa_tpu_torch.ops import banded as bo
from bgsa_tpu_torch.ops import banded_packed as bp
from bgsa_tpu_torch.ops import banded_packed_pair as bpp
from bgsa_tpu_torch.ops import banded_pair as bpr
from bgsa_tpu_torch.ops import bitpal as tb
from bgsa_tpu_torch.ops import bitpal_packed as tbp
from bgsa_tpu_torch.ops import build
from bgsa_tpu_torch.ops import myers_pallas as mp
from bgsa_tpu_torch.ops import myers_semiglobal as sg
from bgsa_tpu_torch.parallel import mesh as mesh_mod
from bgsa_tpu_torch.pipeline import Engine, PipelineConfig
from bgsa_tpu_torch.schemes import Mode, Scoring, normalize

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def codes(rng, shape):
    c = rng.integers(0, 4, size=shape).astype(np.int32)
    c[rng.random(shape) < 0.03] = 4
    return c


def skewed(rng, shape):
    """(S, n) subjects, A but for a share of C, G and T of each subject's own
    (log-uniform from 0.0003 to 0.75), and 3 % N. A uniform query of m << n
    bases is a subsequence of a uniform subject's first strip, so that every
    later strip sees the same carries at every column; against these the
    carries between strips differ from pair to pair and column to column."""
    miss = np.exp(rng.uniform(np.log(3e-4), np.log(0.75), size=(shape[0], 1)))
    c = np.where(rng.random(shape) < miss, rng.integers(1, 4, size=shape), 0).astype(np.int32)
    c[rng.random(shape) < 0.03] = 4
    return c


# past 1,024 bp (32 words) the strip kernel: 1,025 and 1,100 two strips, the
# last of one and three words; 2,048 / 2,049 two full strips / a third of one
# word; 5,000 and 10,000 bp five and ten strips
@pytest.mark.parametrize("n", [1, 32, 33, 150, 1024, 1025, 1100, 2048, 2049, 5000, 10000])
@pytest.mark.parametrize("is_global,factor", [(True, -1), (False, 1)])
def test_kernel_matches_plain(cuda, n, is_global, factor):
    rng = np.random.default_rng(n)
    q = torch.from_numpy(codes(rng, (3, 70))).to(cuda)
    eq = pack.pack_eq(torch.from_numpy(skewed(rng, (300, n))).to(cuda), 32)
    before, strips = sg.LAUNCHES, sg.STRIP_LAUNCHES
    got = sg.myers_semiglobal(eq, q, read_len=n, factor=factor, is_global=is_global)
    torch.cuda.synchronize()
    assert sg.LAUNCHES == before + 1
    # three batches of columns: never the wavefront
    assert sg.STRIP_LAUNCHES == strips + (eq.shape[1] > build.load().reg_words)
    want = sg.myers_semiglobal_ref(eq, q, read_len=n, factor=factor, is_global=is_global)
    assert torch.equal(got, want)


MODES_AND_FACTORS = [(True, -1), (True, 1), (False, -1), (False, 1)]


def plain_on_codes(eq, q, **kw):
    """myers_semiglobal_ref on any query codes: a code outside 0..4 reads an
    Eq plane of zeros (it matches nothing, as in the kernel)."""
    zeros = torch.zeros_like(eq[:1])
    return sg.myers_semiglobal_ref(torch.cat([eq, zeros]), q.long().clamp(max=pack.CHAR_NUM),
                                   **kw)


# (Q, S, m, n, wavefront) past the register bound: the strips of a group of
# 32 subjects on one warp (many pairs, or three batches of columns) and as
# a wavefront over four warps (few pairs: five and ten strips, seven
# batches; two strips, four batches); and queries as long as the subjects
# on both schedules
STRIP_SCHEDULES = [(20, 5000, 40, 1100, False), (3, 300, 70, 2049, False),
                   (3, 300, 200, 5000, True), (2, 77, 200, 10000, True), (3, 100, 128, 1100, True),
                   (34, 1000, 1025, 1025, False), (3, 300, 1025, 1025, True)]


@pytest.mark.parametrize("Q,S,m,n,wave", STRIP_SCHEDULES)
def test_strip_kernels_on_one_warp_and_as_a_wavefront_match_plain(cuda, Q, S, m, n, wave):
    rng = np.random.default_rng(n + m)
    q = torch.from_numpy(codes(rng, (Q, m))).to(cuda)
    subjects = torch.from_numpy(skewed(rng, (S, n))).to(cuda)
    assert sg.strip_wave(Q, S, m, roofline.sm_count(cuda)) is wave
    for module, word_bits in ((sg, 32), (mp, 31)):
        eq = pack.pack_eq(subjects, word_bits)
        before = (module.STRIP_LAUNCHES, module.WAVE_LAUNCHES)
        if module is sg:
            got = sg.myers_semiglobal(eq, q, read_len=n, is_global=False)
            want = sg.myers_semiglobal_ref(eq, q, read_len=n, is_global=False)
        else:
            got = mp.myers_global(eq, q, read_len=n)
            want = mp.myers_global_ref(eq, q, read_len=n)
        assert (module.STRIP_LAUNCHES, module.WAVE_LAUNCHES) == (before[0] + (not wave),
                                                                  before[1] + wave)
        assert torch.equal(got, want)


def strips_launch(eq, q, *, read_len, factor, is_global, wave):
    """The C entry past the register bound on the schedule named: the
    wavefront (``wave``) or one warp a group of 32 subjects."""
    kernels = build.load()
    _, W, S = eq.shape
    Q, m = q.shape
    q = q.to(torch.uint8).contiguous()
    out = torch.empty((Q, S), dtype=torch.int32, device=eq.device)
    carries = torch.empty((2, sg.carry_words(m), Q, S), dtype=torch.int32, device=eq.device)
    rc = kernels.lib.bgsa_myers_semiglobal(
        eq.data_ptr(), q.data_ptr(), out.data_ptr(), carries.data_ptr(), Q, m, W, S, read_len,
        factor, int(is_global), int(wave), torch.cuda.current_stream(eq.device).cuda_stream)
    kernels.check(rc, "myers_semiglobal")
    return out


# (Q, S, m, n) at the edges of the wavefront's tiles: strip counts of 1, 2
# and 3 mod 4 (5, 6 and 7; 2 and 3) and 0 (4), a last strip of 1, 7 and 32
# words, S and m on and off multiples of 32
WAVE_EDGES = [(3, 77, 97, 4097),    # 5 strips, the last of 1 word
              (2, 33, 129, 1241),   # 2 strips, the last of 7
              (3, 100, 128, 2050),  # 3 strips, the last of 1
              (2, 40, 200, 5317),   # 6 strips, the last of 7
              (2, 64, 150, 7168),   # 7 strips, the last of 32
              (1, 31, 300, 4096)]   # 4 strips, all of 32


@pytest.mark.parametrize("Q,S,m,n", WAVE_EDGES)
@pytest.mark.parametrize("is_global,factor", MODES_AND_FACTORS)
def test_wavefront_at_its_tile_edges_matches_the_one_warp_strips(cuda, Q, S, m, n, is_global,
                                                                 factor):
    # query codes 4 and 5..255 (the tile's plane of zeros) among 0..3
    rng = np.random.default_rng(S * m + n)
    q = rng.integers(0, 5, size=(Q, m))
    wide = rng.random(q.shape) < 0.2
    q[wide] = rng.choice([5, 6, 7, 128, 255], size=int(wide.sum()))
    q = torch.from_numpy(q.astype(np.uint8)).to(cuda)
    assert int((q == 4).sum()) > 0 and int(q.max()) >= 5
    eq = pack.pack_eq(torch.from_numpy(skewed(rng, (S, n))).to(cuda), 32)
    kw = dict(read_len=n, factor=factor, is_global=is_global)
    got = strips_launch(eq, q, wave=True, **kw)
    assert int((got - strips_launch(eq, q, wave=False, **kw)).abs().max()) == 0
    if eq.shape[1] * m <= 65 * 130:  # the plain version where it is affordable
        assert int((got - plain_on_codes(eq, q, **kw)).abs().max()) == 0


# (Q, S, m, n) at the edges of the one-warp strips' block: a tile of 32
# subjects whose four warps take the queries of its chunk. Q of 1, 5 and 21
# (warps with no query; at 21 the last chunk holds one); S off a multiple
# of 32 (the last tile of 1 subject at 33 and 4,097); a last strip of 1, 7
# and 32 words; m of 1,025 and 2,049 (a query row staged past kQueryChunk
# codes, the last batch of one column)
STRIP_EDGES = [(1, 33, 97, 1025),    # 2 strips, the last of 1 word
               (5, 77, 129, 1241),   # 2 strips, the last of 7
               (21, 100, 64, 2048),  # 2 strips of 32
               (5, 4097, 40, 1100),  # 2 strips, the last of 3
               (3, 40, 1025, 1025),  # 2 chunks of the query row
               (2, 50, 2049, 1025)]  # 3 chunks


def strip_edge_inputs(Q, S, m, n):
    """Query codes 0..4 with a fifth of them 5..255 (the tile's plane of
    zeros), and the Eq words of skewed subjects, on the CPU."""
    rng = np.random.default_rng(Q * S + m + n)
    q = rng.integers(0, 5, size=(Q, m))
    wide = rng.random(q.shape) < 0.2
    q[wide] = rng.choice([5, 6, 7, 128, 255], size=int(wide.sum()))
    eq = pack.pack_eq(torch.from_numpy(skewed(rng, (S, n))), 32)
    return torch.from_numpy(q.astype(np.uint8)), eq


@functools.lru_cache(maxsize=None)
def strip_edge_plain(Q, S, m, n, is_global):
    """Both plain versions on the CPU at factor 1, once a geometry and mode."""
    q, eq = strip_edge_inputs(Q, S, m, n)
    kw = dict(read_len=n, factor=1, is_global=is_global)
    return plain_on_codes(eq, q, **kw), sg.myers_strip_ref(eq, q, **kw)


@pytest.mark.parametrize("Q,S,m,n", STRIP_EDGES)
@pytest.mark.parametrize("is_global,factor", MODES_AND_FACTORS)
def test_one_warp_strips_at_their_tile_edges_match_plain(cuda, Q, S, m, n, is_global, factor):
    q, eq = strip_edge_inputs(Q, S, m, n)
    assert int((q == 4).sum()) > 0 and int(q.max()) >= 5
    assert eq.shape[1] > build.load().reg_words
    got = strips_launch(eq.to(cuda), q.to(cuda), wave=False, read_len=n, factor=factor,
                        is_global=is_global).cpu()
    for want in strip_edge_plain(Q, S, m, n, is_global):
        assert int((got - factor * want).abs().max()) == 0


def test_wavefront_at_the_genome_cells_words_and_columns(cuda):
    # W = 935 and m = 29,903: 30 strips (the last of 7 words), 935 batches
    n = m = 29903
    rng = np.random.default_rng(n)
    subjects = skewed(rng, (40, n))
    q = codes(rng, (2, m))
    q[0] = subjects[3]
    q[0, rng.random(m) < 0.01] = rng.integers(0, 4)  # a near copy of subject 3
    q = torch.from_numpy(q.astype(np.uint8)).to(cuda)
    eq = pack.pack_eq(torch.from_numpy(subjects).to(cuda), 32)
    for is_global, factor in ((True, -1), (False, 1)):
        kw = dict(read_len=n, factor=factor, is_global=is_global)
        got = strips_launch(eq, q, wave=True, **kw)
        assert int((got - strips_launch(eq, q, wave=False, **kw)).abs().max()) == 0


# (Q, S, m, n) at the edges of the register kernel's design: a block's tile
# of 32 subjects and its four warps, each running its own query of the
# block's chunk. Q not a multiple of four warps, and past one block's chunk
# (at S = 21,632 a block walks 12 of Q = 201 on a 132-SM card, the last
# chunk 9); S at the tile's edges; every word count of an instance (the last
# word short, or full at 960 and 1,024 bp); a query past one staged row of
# 1,024 codes
REGS_EDGES = [(1, 100, 40, 150), (3, 100, 40, 150), (5, 100, 40, 150), (201, 100, 40, 150),
              (201, 21632, 40, 150), (5, 1, 40, 300), (5, 31, 40, 300), (5, 33, 40, 300),
              (5, 4097, 40, 300), (3, 70, 60, 1), (3, 70, 60, 70), (3, 70, 60, 150),
              (3, 70, 60, 257), (3, 70, 60, 513), (3, 70, 60, 960), (3, 70, 60, 1024),
              (6, 40, 1500, 200)]
@pytest.mark.parametrize("Q,S,m,n", REGS_EDGES)
@pytest.mark.parametrize("is_global,factor", MODES_AND_FACTORS)
def test_register_kernel_at_its_tile_and_query_edges_matches_plain(cuda, Q, S, m, n, is_global,
                                                                    factor):
    rng = np.random.default_rng(Q * S + m + n)
    q = torch.from_numpy(codes(rng, (Q, m))).to(cuda)
    eq = pack.pack_eq(torch.from_numpy(skewed(rng, (S, n))).to(cuda), 32)
    assert eq.shape[1] <= build.load().reg_words
    before, strips = sg.LAUNCHES, sg.STRIP_LAUNCHES
    got = sg.myers_semiglobal(eq, q, read_len=n, factor=factor, is_global=is_global)
    torch.cuda.synchronize()
    assert (sg.LAUNCHES, sg.STRIP_LAUNCHES) == (before + 1, strips)
    want = sg.myers_semiglobal_ref(eq, q, read_len=n, factor=factor, is_global=is_global)
    assert int((got - want).abs().max()) == 0


@pytest.mark.parametrize("n", [1, 150, 960])
@pytest.mark.parametrize("is_global,factor", MODES_AND_FACTORS)
def test_register_kernel_query_codes_past_4_match_nothing(cuda, n, is_global, factor):
    # codes 5..255 read the tile's plane of zeros
    rng = np.random.default_rng(n)
    q = rng.integers(0, 5, size=(7, 80))
    wide = rng.random(q.shape) < 0.2
    q[wide] = rng.choice([5, 6, 7, 128, 255], size=int(wide.sum()))
    q = torch.from_numpy(q.astype(np.uint8)).to(cuda)
    assert int(q.max()) >= 5
    eq = pack.pack_eq(torch.from_numpy(skewed(rng, (97, n))).to(cuda), 32)
    got = sg.myers_semiglobal(eq, q, read_len=n, factor=factor, is_global=is_global)
    want = plain_on_codes(eq, q, read_len=n, factor=factor, is_global=is_global)
    assert int((got - want).abs().max()) == 0


@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.SEMI_GLOBAL])
def test_engine_cuda_matches_cpu(cuda, mode):
    rng = np.random.default_rng(3)
    q, s = codes(rng, (4, 90)), codes(rng, (1000, 90))
    scheme = normalize(Scoring(0, -1, -1), mode)
    got = np.asarray(Engine(scheme, PipelineConfig(), cuda).scores(q, s))
    want = np.asarray(Engine(scheme, PipelineConfig(), "cpu").scores(q, s))
    np.testing.assert_array_equal(got, want)


def test_build_failure_raises(cuda, tmp_path):
    src = tmp_path / "broken.cu"
    src.write_text("__global__ void k() { int x = }\n")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        build.compile_library([str(src)], str(tmp_path / "out"))
    assert str(src) in str(err.value) and "error" in str(err.value)


# (q_len, s_len, k) of every banded route and edge
BANDED_PACKED = [(150, 158, 8), (150, 150, 8), (100, 100, 4), (40, 44, 4), (3, 5, 4),
                 (100, 100, 3), (7, 7, 1)]  # n_sub 8 and 16: the generic instance
# the stream kernels' window edges: q_len 32, 64 and 96 (the last window's
# w + 2), band_down 31, 32, 40 and 63 (narrow and wide instances), and the
# dual head (t <= 2k) ending inside a window or on its first column
BANDED_STREAM = [(150, 150, 16), (150, 181, 16), (150, 150, 1), (70, 70, 0), (32, 47, 8),
                 (64, 72, 16), (96, 96, 16)]
BANDED_DUAL = [(100, 95, 20), (150, 148, 8), (41, 30, 20), (100, 99, 31), (32, 28, 20),
               (64, 60, 12), (96, 95, 16)]
# the Peq-carry route's longest query (63 bp) and band_down 40, and the
# bench line's geometry (live injections, past column 64)
BANDED_PEQ = [(50, 20, 40), (55, 20, 40), (63, 31, 32), (40, 10, 35), (150, 150, 8)]
KINDS = ["garbage", "near", "mix"]


def banded_inputs(seed, m, n, k, kind, S=1000, Q=3):
    """(queries, subjects) codes: random subjects (every lane exits),
    queries and subjects near one base sequence (within k/4 substitutions
    each: where s_len <= q_len no pair exits), or the read-filter mix."""
    rng = np.random.default_rng(seed)
    if kind == "mix":
        q, s = filter_mix_dataset(rng, Q, S, max(m, n, 6))
        return q[:, :m], s[:, :n].astype(np.int32)
    if kind == "near":
        base = rng.integers(0, 4, size=max(m, n)).astype(np.int32)
        q, s = np.repeat(base[None, :m], Q, axis=0), np.repeat(base[None, :n], S, axis=0)
        for row in (*q, *s):
            e = rng.integers(0, k // 4 + 1)
            row[rng.integers(0, row.size, size=e)] = rng.integers(0, 4, size=e)
        return q, s
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    return q, rng.integers(0, 4, size=(S, n)).astype(np.int32)


def launches(name):
    return bp.LAUNCHES if name == "banded_stream_packed" else bo.LAUNCHES[name]


def kernel_vs_plain(cuda, name, m, n, k, kind, S):
    """Kernel ``name`` against its plain version on the same CUDA tensors,
    the subjects packed by the engine as its route packs them."""
    fn, ref = KERNELS[name]
    q, s = banded_inputs(m + n + k + len(name), m, n, k, kind, S=S)
    args = BandedEngine(k, PipelineConfig(), cuda).kernel_args(
        name, torch.from_numpy(s).to(cuda), m)
    kw = dict(q_len=m, s_len=n, k=k)
    before = launches(name)
    got = fn(*args, torch.from_numpy(q).to(cuda), **kw)
    torch.cuda.synchronize()
    assert launches(name) == before + 1
    want = ref(*args, torch.from_numpy(q).to(cuda), **kw)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 129, 1000])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", BANDED_PACKED)
def test_banded_packed_kernel_matches_plain(cuda, m, n, k, kind, S):
    kernel_vs_plain(cuda, "banded_stream_packed", m, n, k, kind, S)


@pytest.mark.parametrize("S", [1, 129, 1000])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", BANDED_STREAM + BANDED_PACKED[:2])
def test_banded_stream_kernel_matches_plain(cuda, m, n, k, kind, S):
    kernel_vs_plain(cuda, "banded_stream", m, n, k, kind, S)


@pytest.mark.parametrize("S", [1, 129, 1000])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", BANDED_DUAL)
def test_banded_dual_kernel_matches_plain(cuda, m, n, k, kind, S):
    kernel_vs_plain(cuda, "banded_stream_dual", m, n, k, kind, S)


@pytest.mark.parametrize("name,m,n,k", [("banded_stream", 150, 150, 16),
                                         ("banded_stream", 32, 47, 8),
                                         ("banded_stream_dual", 100, 95, 20),
                                         ("banded_stream_dual", 150, 148, 8),
                                         ("banded", 55, 20, 40), ("banded", 150, 150, 8)])
def test_banded_stream_codes_outside_0_to_4_match_nothing(cuda, name, m, n, k):
    # codes 5 and 9 in the queries score as code 4 against streams (or the
    # Peq-carry kernel's initial window and injection words) whose code-4
    # planes are zero
    fn, ref = KERNELS[name]
    q, s = banded_inputs(m + n, m, n, k, "near", S=300)
    q[:, ::41], q[:, 20::53] = 5, 9
    args = BandedEngine(k, PipelineConfig(), cuda).kernel_args(
        name, torch.from_numpy(s).to(cuda), m)
    zeroed = [x.clone() for x in args]
    for x in zeroed:  # characters on axis ndim - 3, axis 0 of a (5, S) window half
        x.select(max(x.dim() - 3, 0), 4).zero_()
    kw = dict(q_len=m, s_len=n, k=k)
    got = fn(*args, torch.from_numpy(q).to(cuda), **kw)
    want = ref(*zeroed, torch.from_numpy(np.where(q >= 5, 4, q)).to(cuda), **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 129, 1000])
@pytest.mark.parametrize("kind", KINDS + ["words", "short W"])
@pytest.mark.parametrize("m,n,k", BANDED_PEQ)
def test_banded_peq_kernel_matches_plain(cuda, m, n, k, kind, S):
    if kind in KINDS:
        kernel_vs_plain(cuda, "banded", m, n, k, kind, S)
        return
    # random initial windows and injection words (bits above band_down and
    # past q_len - k); "short W": fewer injection words than q_len - k
    # needs, so the word index clamps at W - 1
    rng = np.random.default_rng(m + n + k + len(kind))
    W = 1 if kind == "short W" else max(1, -(-(m - k) // 32)) + 1
    lo, hi, inj = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64)
                                    .astype(np.int32)).to(cuda)
                   for shape in ((5, S), (5, S), (5, W, S)))
    q = torch.from_numpy(codes(rng, (3, m))).to(cuda)
    kw = dict(q_len=m, s_len=n, k=k)
    before = launches("banded")
    got = bo.banded(lo, hi, inj, q, **kw)
    torch.cuda.synchronize()
    assert launches("banded") == before + 1
    assert torch.equal(got, bo.banded_ref(lo, hi, inj, q, **kw))


@pytest.mark.parametrize("m,n,k", [(150, 150, 8), (150, 181, 16), (150, 148, 8), (55, 20, 40)],
                         ids=["packed", "stream", "dual", "peq-carry"])
def test_banded_engine_cuda_matches_cpu(cuda, m, n, k):
    q, s = banded_inputs(5, m, n, k, "mix", S=2000, Q=4)
    got = np.asarray(BandedEngine(k, PipelineConfig(), cuda).scores(q, s.astype(np.uint8)))
    want = np.asarray(BandedEngine(k, PipelineConfig(), "cpu").scores(q, s.astype(np.uint8)))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


# -- BitPAl ------------------------------------------------------------------

# a scheme of each shape: the bench scheme, small and zero-match lattices,
# an unpacked-only scheme and two wide ones (28 and 26 planes unpacked;
# (5,-4,-10)'s carries take two words)
BITPAL_SCHEMES = [(2, -3, -5), (1, -1, -1), (0, -2, -3), (5, -1, -2), (5, -4, -11), (5, -4, -10)]


def bitpal_kernels(M, I, G):
    """(name, wrapper, plain version) of each BitPAl kernel the scheme takes."""
    out = [("bitpal", tb.bitpal, tb.bitpal_ref)]
    if tbp.packed_supported(tb.BitpalParams(M, I, G)):
        out.append(("bitpal_packed", tbp.bitpal_packed, tbp.bitpal_packed_ref))
    return out


@pytest.fixture(scope="module")
def bitpal_cuda():
    """A CUDA device, with every scheme library of these tests built (in parallel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build.load_all([(name, *scheme) for scheme in BITPAL_SCHEMES
                    for name, _, _ in bitpal_kernels(*scheme)])
    return torch.device("cuda")


def bitpal_vs_plain(dev, M, I, G, n, *, Q=3, m=12, S=300, seed=0):
    """Every BitPAl kernel of the scheme against its plain version on the same
    CUDA tensors, in both word layouts and both modes."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(codes(rng, (Q, m))).to(dev)
    subjects = torch.from_numpy(codes(rng, (S, n))).to(dev)
    for word_bits in (31, 32):
        eq = pack.pack_eq(subjects, word_bits)
        for semi, factor in ((False, 1), (True, 2)):
            kw = dict(match=M, mismatch=I, gap=G, read_len=n, factor=factor, semi_global=semi,
                      word_bits=word_bits)
            for name, fn, ref in bitpal_kernels(M, I, G):
                module = tbp if name == "bitpal_packed" else tb
                before = module.LAUNCHES
                got = fn(eq, q, **kw)
                torch.cuda.synchronize()
                assert module.LAUNCHES == before + 1
                want = ref(eq, q, **kw)
                assert got.dtype == torch.int32 and torch.equal(got, want), (name, word_bits, semi)


@pytest.mark.parametrize("n", [1, 33, 150, 500])
@pytest.mark.parametrize("M,I,G", BITPAL_SCHEMES)
def test_bitpal_kernels_match_plain(bitpal_cuda, M, I, G, n):
    bitpal_vs_plain(bitpal_cuda, M, I, G, n, seed=n)


@pytest.mark.parametrize("M,I,G", [(2, -3, -5), (5, -1, -2)])
def test_bitpal_scratch_path_matches_plain(bitpal_cuda, M, I, G):
    # 1100 bp: 36 words, past every scheme's register bound (both kernels)
    kernels = build.load_all([(name, M, I, G) for name, _, _ in bitpal_kernels(M, I, G)])[1]
    assert all(k.reg_words < 36 for k in kernels)
    bitpal_vs_plain(bitpal_cuda, M, I, G, 1100, m=4, S=200)


@pytest.mark.parametrize("n", [500, 1100])
@pytest.mark.parametrize("M,I,G", [(2, -3, -5), (5, -4, -10)])
def test_bitpal_tiled_kernel_across_tiles_matches_plain(bitpal_cuda, M, I, G, n):
    # 40 query columns over the 32-column tile: the planes kept in the
    # scratch between tiles, a last tile of 8 columns
    bitpal_vs_plain(bitpal_cuda, M, I, G, n, m=40, S=200, seed=n)


@pytest.mark.parametrize("S", [1, 129, 1000])
def test_bitpal_ragged_subject_counts(bitpal_cuda, S):
    bitpal_vs_plain(bitpal_cuda, 2, -3, -5, 150, S=S, seed=S)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.SEMI_GLOBAL])
def test_bitpal_engine_cuda_matches_cpu(bitpal_cuda, mode, packed):
    rng = np.random.default_rng(4)
    q, s = codes(rng, (4, 90)), codes(rng, (1000, 90))
    scheme = normalize(Scoring(4, -6, -10), mode)
    config = PipelineConfig(bitpal_packed=packed)
    engine = Engine(scheme, config, bitpal_cuda)
    assert engine.kernel == ("bitpal_packed" if packed else "bitpal")
    got = np.asarray(engine.scores(q, s))
    want = np.asarray(Engine(scheme, config, "cpu").scores(q, s))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_bitpal_scheme_library_is_built_once(bitpal_cuda):
    # a second engine of the same scheme builds nothing; another scheme has
    # its own library
    scheme = normalize(Scoring(2, -3, -5))
    first = Engine(scheme, PipelineConfig(), bitpal_cuda).load_library()
    again = Engine(scheme, PipelineConfig(), bitpal_cuda).load_library()
    assert again is first
    path, log, seconds = build.compile_library(
        [f"{build.CSRC_DIR}/bitpal_packed.cu"], build.BUILD_DIR, stem="bgsa_bitpal_packed",
        tag=build.scheme_tag(2, -3, -5), defines=("BGSA_M=2", "BGSA_I=-3", "BGSA_G=-5"))
    # cached: nothing rebuilt, and the build's ptxas report read back from beside it
    assert (path, seconds) == (first.path, 0.0) and "registers" in log
    other = Engine(normalize(Scoring(1, -1, -1)), PipelineConfig(), bitpal_cuda).load_library()
    assert other.path != first.path and other.path.endswith("-M1_I-1_G-1.so")


# -- the 31-bit Myers kernel, the mesh, the engines on shards, the int32 peak -----


# past 992 bp (32 words of 31 bits) the strip kernel: 993 and 1,500 bp two
# strips; 1,024 / 1,025, 2,048 / 2,049, 5,000 and 10,000 bp as the full-word
# test's (the 31-bit strips end at 992, 1,984, ... bp)
@pytest.mark.parametrize("n", [1, 31, 32, 62, 93, 150, 992, 993, 1024, 1025, 1500, 2048, 2049,
                               5000, 10000])
@pytest.mark.parametrize("factor", [-1, 1])
def test_myers_global_matches_plain_and_full_word(cuda, n, factor):
    rng = np.random.default_rng(n)
    q = torch.from_numpy(codes(rng, (3, 70))).to(cuda)
    subjects = torch.from_numpy(skewed(rng, (300, n))).to(cuda)
    eq = pack.pack_eq(subjects, 31)
    before, strips = mp.LAUNCHES, mp.STRIP_LAUNCHES
    got = mp.myers_global(eq, q, read_len=n, factor=factor)
    torch.cuda.synchronize()
    assert mp.LAUNCHES == before + 1
    reg_words = build.load().lib.bgsa_myers_global_reg_words()
    assert mp.STRIP_LAUNCHES == strips + (eq.shape[1] > reg_words)
    assert torch.equal(got, mp.myers_global_ref(eq, q, read_len=n, factor=factor))
    full = sg.myers_semiglobal(pack.pack_eq(subjects, 32), q, read_len=n, factor=factor,
                               is_global=True)
    assert torch.equal(got, full)


@pytest.mark.parametrize("merge", [False, True])
def test_mesh_on_repeated_card_matches_one_device(cuda, merge):
    rng = np.random.default_rng(8)
    q = torch.from_numpy(codes(rng, (4, 60))).to(cuda)
    eq = pack.pack_eq(torch.from_numpy(codes(rng, (1000, 150))).to(cuda), 31)
    mesh = mesh_mod.make_mesh([cuda] * 4, query_shards=2)
    got = mesh_mod.myers_global_sharded(eq, q, mesh, read_len=150, merge=merge)
    want = mp.myers_global(eq, q, read_len=150).cpu().numpy()
    np.testing.assert_array_equal(np.asarray(got.cpu() if merge else got), want)


@pytest.mark.parametrize("scoring,packed", [
    (Scoring(0, -1, -1), True), (Scoring(2, -3, -5), True), (Scoring(2, -3, -5), False)])
def test_engine_on_two_shards_of_the_card(bitpal_cuda, scoring, packed):
    rng = np.random.default_rng(9)
    q = codes(rng, (3, 90))
    s = codes(rng, (2048, 90)).astype(np.uint8)
    config = PipelineConfig(bitpal_packed=packed)
    one = np.asarray(Engine(normalize(scoring), config, bitpal_cuda).scores(q, s))
    two = Engine(normalize(scoring), config, bitpal_cuda, devices=[bitpal_cuda] * 2)
    np.testing.assert_array_equal(np.asarray(two.scores(q, s)), one)


@pytest.mark.parametrize("m,n,k", [(150, 150, 8), (150, 150, 16), (150, 148, 8), (55, 20, 40)])
def test_banded_engine_on_two_shards_of_the_card(cuda, m, n, k):
    q, s = filter_mix_dataset(np.random.default_rng(k), 3, 1000, max(m, n))
    s = s[:, :n].astype(np.uint8)
    one = np.asarray(BandedEngine(k, PipelineConfig(), cuda).scores(q[:, :m], s))
    two = BandedEngine(k, PipelineConfig(), cuda, devices=[cuda] * 2)
    np.testing.assert_array_equal(np.asarray(two.scores(q[:, :m], s)), one)


@pytest.mark.parametrize("name,shape,library", [
    ("myers_semiglobal", {"W": 16}, None), ("myers_global", {"W": 17}, None),
    ("myers_semiglobal", {"W": 32}, None), ("myers_global", {"W": 32}, None),
    ("myers_semiglobal_strips", {}, None), ("myers_global_strips", {}, None),
    ("myers_semiglobal_wave", {}, None), ("myers_global_wave", {}, None),
    ("banded_stream", {"wide": 0}, None), ("banded_stream", {"wide": 1}, None),
    ("banded_stream_dual", {"wide": 0}, None), ("banded_stream_dual", {"wide": 1}, None),
    ("banded", {"wide": 0}, None), ("banded", {"wide": 1}, None),
    ("banded_stream_packed", {"n_sub": 3}, None), ("int_peak", {"chains": 16}, None),
    ("bitpal_packed", {"bits": 31, "W": 17}, "bitpal_packed"),
    ("bitpal", {"bits": 32, "W": 5}, "bitpal"), ("bitpal_tiled", {"bits": 32}, "bitpal"),
    ("bitpal_packed_tiled", {"bits": 31}, "bitpal_packed"),
    ("banded_stream_pair", {"wide": 0}, None), ("banded_stream_pair", {"wide": 1}, None),
    ("banded_probe_full", {}, None),
    ("banded_probe_static_c", {}, None), ("banded_probe_noload", {}, None),
    ("banded_packed_pair", {"n_sub": 3}, None),
])
def test_sass_column_loop_of_every_kernel(cuda, name, shape, library):
    # the bound's instruction counts come from the built library's SASS
    from bgsa_tpu_torch.ops import build

    lib = build.load() if library is None else build.load_scheme(library, 2, -3, -5)
    text = roofline.sass_text(lib.path)
    if text is None:
        pytest.skip("the CUDA toolkit has no cuobjdump")
    spec = roofline.SASS_SPECS[name]
    ins = roofline.find_function(roofline.sass_functions(text), spec.function.format(**shape))
    per = roofline.column_instructions(ins, spec)
    assert 0 < per["alu"] <= per["issue"] and 0 <= per["fma"] <= per["issue"]


@pytest.mark.parametrize("chains", [1, 8, 16, 32])
def test_int_peak_matches_plain(cuda, chains):
    x = roofline.peak_inputs(chains, 3000, cuda)
    before = roofline.LAUNCHES
    got = roofline.int_peak(x, steps=3, unroll=7)  # 21 iterations: main loop and remainder
    torch.cuda.synchronize()
    assert roofline.LAUNCHES == before + 1
    assert torch.equal(got, roofline.int_peak_ref(x, steps=3, unroll=7))


def test_no_spill_in_the_main_library(cuda):
    # ptxas gives no function a spill and no stack frame, the printing
    # kernel's included (its print is a record in the device log)
    frames = build.ptxas_frames(build.load().log)
    assert any("global31_regsILi17E" in fn for fn in frames)
    assert any("kprint_probe_kernel" in fn for fn in frames)
    bad = {fn: f for fn, f in frames.items() if any(f)}
    assert not bad


# -- the paired-query kernels, the banded probes, the kprint fixture -----------

# the experiments' geometry, band_down 32 and 63, and the window edges of
# tests/test_torch_banded_pair_window.py: q_len 32, 64 and 96, band_down 31,
# 36 and 40; packed: n_sub 2 to 7 and q_len < k
PAIR_STREAM = [(150, 150, 8), (150, 150, 16), (150, 181, 16), (40, 44, 4), (64, 80, 8),
               (32, 47, 8), (32, 36, 16), (64, 72, 16), (96, 100, 16)]
PAIR_PACKED = [(150, 158, 8), (150, 150, 8), (72, 72, 5), (100, 100, 4), (3, 5, 4),
               (150, 151, 3), (32, 32, 4), (64, 66, 5), (96, 96, 8)]


@pytest.mark.parametrize("S", [1, 129, 1000])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", PAIR_STREAM)
def test_stream_pair_and_probes_match_plain(cuda, m, n, k, kind, S):
    q, s = banded_inputs(m + n + k + S, m, n, k, kind, S=S, Q=4)
    stream = pack.pack_banded_stream(torch.from_numpy(s).to(cuda), k, m)
    qt = torch.from_numpy(q).to(cuda)
    kw = dict(q_len=m, s_len=n, k=k)
    before = dict(bpr.LAUNCHES)
    got = bpr.banded_stream_pair(stream, qt, **kw)
    probes = {mode: bpr.banded_probe(stream, qt[:3], mode=mode, **kw) for mode in bpr.PROBE_MODES}
    torch.cuda.synchronize()
    assert all(bpr.LAUNCHES[name] == before[name] + 1 for name in before)
    assert torch.equal(got, bpr.banded_stream_pair_ref(stream, qt, **kw))
    assert torch.equal(got, bo.banded_stream(stream, qt, **kw))
    for mode, out in probes.items():
        assert torch.equal(out, bpr.banded_probe_ref(stream, qt[:3], mode=mode, **kw)), mode


@pytest.mark.parametrize("S", [1, 129, 1000])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", PAIR_PACKED)
def test_packed_pair_matches_plain_and_packed(cuda, m, n, k, kind, S):
    q, s = banded_inputs(m + n + k + S, m, n, k, kind, S=S, Q=4)
    streams = BandedEngine(k, PipelineConfig(), cuda).kernel_args(
        "banded_stream_packed", torch.from_numpy(s).to(cuda), m)[0]
    qt = torch.from_numpy(q).to(cuda)
    kw = dict(q_len=m, s_len=n, k=k)
    before = bpp.LAUNCHES
    got = bpp.banded_packed_pair(streams, qt, **kw)
    torch.cuda.synchronize()
    assert bpp.LAUNCHES == before + 1
    assert torch.equal(got, bpp.banded_packed_pair_ref(streams, qt, **kw))
    assert torch.equal(got, bp.banded_stream_packed(streams, qt, **kw))


@pytest.mark.parametrize("m,n,k,W", [(32, 47, 8, 1), (32, 47, 8, 2), (96, 100, 16, 3),
                                     (96, 100, 16, 4), (150, 150, 8, 3), (100, 100, 4, 4)])
def test_pair_kernels_at_the_window_edges_of_raw_words(cuda, m, n, k, W):
    # random words, no packer (the packer leaves room): a stream window's
    # word past W reads as 0; the packed window clamps at W - 2
    rng = np.random.default_rng(m + W)
    kw = dict(q_len=m, s_len=n, k=k)
    qt = torch.from_numpy(rng.integers(0, 5, size=(4, m)).astype(np.int32)).to(cuda)
    n_sub = bp.packed_subbands(m, n, k)
    if n_sub:
        streams = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(n_sub, 5, W, 300))
                                   .astype(np.int32)).to(cuda)
        got = bpp.banded_packed_pair(streams, qt, **kw)
        assert torch.equal(got, bpp.banded_packed_pair_ref(streams, qt, **kw))
        assert torch.equal(got, bp.banded_stream_packed(streams, qt, **kw))
    else:
        stream = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(5, W, 300))
                                  .astype(np.int32)).to(cuda)
        got = bpr.banded_stream_pair(stream, qt, **kw)
        assert torch.equal(got, bpr.banded_stream_pair_ref(stream, qt, **kw))
        assert torch.equal(got, bo.banded_stream(stream, qt, **kw))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", PAIR_PACKED)
def test_packed_probes_match_plain(cuda, m, n, k, kind):
    q, s = banded_inputs(m + n + k, m, n, k, kind, S=600, Q=3)
    streams = BandedEngine(k, PipelineConfig(), cuda).kernel_args(
        "banded_stream_packed", torch.from_numpy(s).to(cuda), m)[0]
    qt = torch.from_numpy(q).to(cuda)
    kw = dict(q_len=m, s_len=n, k=k)
    for mode in bpp.PROBE_MODES:
        before = bpp.PROBE_LAUNCHES[mode]
        got = bpp.banded_packed_probe(streams, qt, mode=mode, **kw)
        torch.cuda.synchronize()
        assert bpp.PROBE_LAUNCHES[mode] == before + 1
        assert torch.equal(got, bpp.banded_packed_probe_ref(streams, qt, mode=mode, **kw)), mode


def test_kprint_probe_prints_and_copies(cuda, capfd):
    x = torch.arange(8 * 128, dtype=torch.int32, device=cuda).reshape(8, 128)
    debug.drain_kprints(cuda)  # what earlier tests left in the log
    capfd.readouterr()
    before = debug.LAUNCHES
    out = debug.kprint_probe(x)
    assert debug.drain_kprints(cuda) == (["probe 0"], 0)
    assert debug.LAUNCHES == before + 1 and torch.equal(out, x)
    assert capfd.readouterr().out.splitlines() == ["probe 0"]  # printed by the drain
    assert debug.drain_kprints(cuda) == ([], 0)  # the cursor was reset
    debug.kprint_probe(x + 5)
    assert debug.drain_kprints(cuda) == (["probe 5"], 0)


def test_kprint_records_accumulate_across_graph_replays(cuda):
    x = torch.arange(8 * 128, dtype=torch.int32, device=cuda).reshape(8, 128)
    debug.kprint_probe(x)  # loads the library outside the capture
    torch.cuda.synchronize()
    debug.drain_kprints(cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = debug.kprint_probe(x)
    for _ in range(7):
        graph.replay()
    assert debug.drain_kprints(cuda) == (["probe 0"] * 7, 0)
    assert torch.equal(out, x)


def test_kprint_overflow_counts_the_dropped_and_writes_no_further(cuda):
    x = torch.arange(8 * 128, dtype=torch.int32, device=cuda).reshape(8, 128)
    debug.drain_kprints(cuda)
    cap = debug.KPRINT_CAPACITY
    for i in range(cap + 5):
        out = debug.kprint_probe(x + (i % 3))
    # the drain raises where the guard record past the capacity was written
    lines, dropped = debug.drain_kprints(cuda)
    assert lines == [f"probe {i % 3}" for i in range(cap)] and dropped == 5
    assert torch.equal(out, x + (cap + 4) % 3)
    assert debug.drain_kprints(cuda) == ([], 0)
    debug.kprint_probe(x)
    assert debug.drain_kprints(cuda) == (["probe 0"], 0)  # the first slot again


def test_a_failed_kprint_drain_raises(cuda, monkeypatch):
    x = torch.arange(8 * 128, dtype=torch.int32, device=cuda).reshape(8, 128)
    debug.kprint_probe(x)
    monkeypatch.setattr(debug, "KPRINT_CAPACITY", debug.KPRINT_CAPACITY - 1)
    with pytest.raises(RuntimeError, match="CUDA error"):  # not the log's capacity
        debug.drain_kprints(cuda)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="format string"):  # no format at address 0
        debug._format_string(build.load(), 0, torch.cuda.current_stream().cuda_stream,
                             torch.cuda.current_device(), 0)
    assert debug.drain_kprints(cuda) == (["probe 0"], 0)


def test_empty_subjects_return_without_a_launch(cuda):
    # every wrapper's S = 0 early return on the card: a (Q, 0) tensor
    q = torch.zeros((2, 40), dtype=torch.int32, device=cuda)
    none = torch.zeros((0, 40), dtype=torch.int32, device=cuda)
    kw = dict(q_len=40, s_len=40, k=4)
    n_sub = bp.packed_subbands(40, 40, 4)
    calls = {
        "myers_semiglobal": lambda: sg.myers_semiglobal(pack.pack_eq(none, 32), q, read_len=40),
        "myers_global": lambda: mp.myers_global(pack.pack_eq(none, 31), q, read_len=40),
        "bitpal": lambda: tb.bitpal(pack.pack_eq(none, 32), q, match=2, mismatch=-3, gap=-5,
                                    read_len=40, word_bits=32),
        "banded_stream": lambda: bo.banded_stream(pack.pack_banded_stream(none, 4, 40), q, **kw),
        "banded": lambda: bo.banded(*pack.pack_banded(none[:, :10], 35, 40), q, q_len=40,
                                    s_len=10, k=35),
        "banded_stream_packed": lambda: bp.banded_stream_packed(
            bp.pack_packed_streams(none, 4, 40, n_sub), q, **kw),
        "banded_stream_pair": lambda: bpr.banded_stream_pair(
            pack.pack_banded_stream(none, 4, 40), q, **kw),
        "banded_packed_pair": lambda: bpp.banded_packed_pair(
            bp.pack_packed_streams(none, 4, 40, n_sub), q, **kw),
    }
    for name, call in calls.items():
        out = call()
        assert tuple(out.shape) == (2, 0) and out.device.type == "cuda", name


def test_graft_entry_on_the_card(cuda):
    from bgsa_tpu_torch import graft_entry

    fn, args = graft_entry.entry("cuda")
    before = sg.LAUNCHES
    got = fn(*args)
    assert sg.LAUNCHES == before + 1 and got.device.type == "cuda"
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    assert torch.equal(got.cpu(), cpu_fn(*cpu_args))
    one = graft_entry.dryrun_multichip(1)  # the first visible card
    two = graft_entry.dryrun_multichip(2, ["cuda:0"] * 2)
    cpu = graft_entry.dryrun_multichip(2, ["cpu"] * 2)
    for step in graft_entry.STEPS:
        assert np.array_equal(two[step], cpu[step]), step
    assert set(one) == set(graft_entry.STEPS)


def test_a_failed_launch_raises_with_cudas_text(cuda):
    with pytest.raises(RuntimeError, match="probe: kernel launch failed: CUDA error 1"):
        build.load().check(1, "probe")  # cudaErrorInvalidValue
    x = roofline.peak_inputs(3, 1024, "cuda")  # 3 chains: no instance
    with pytest.raises(ValueError, match="takes 1, 2, 4, 8, 16 or 32 chains"):
        roofline.int_peak(x, steps=1, unroll=1)


def test_the_pipeline_on_the_card_writes_the_cpu_bytes(cuda, tmp_path):
    from bgsa_tpu_torch.io import seqfile
    from bgsa_tpu_torch.pipeline import local_devices, run_alignment

    assert local_devices(0, "cuda") == [torch.device("cuda", i)
                                        for i in range(torch.cuda.device_count())]
    rng = np.random.default_rng(12)
    q, d = str(tmp_path / "q.txt"), str(tmp_path / "d.txt")
    seqfile.write_seq_file(q, rng.integers(0, 4, size=(3, 30)))
    seqfile.write_seq_file(d, rng.integers(0, 5, size=(700, 40)))
    out = {}
    for device in ("cpu", "cuda"):
        path = str(tmp_path / f"{device}.bin")
        run_alignment(q, d, path, config=PipelineConfig(bucket_size=41 * 256), device=device)
        with open(path, "rb") as f:
            out[device] = f.read()
    assert out["cpu"] == out["cuda"]


def test_make_mesh_takes_every_card_by_default(cuda):
    mesh = mesh_mod.make_mesh()
    assert mesh.shape == (torch.cuda.device_count(), 1)
    assert mesh.devices[0][0] == torch.device("cuda", 0)


def test_the_reference_probes_copy_and_launch(cuda):
    x = torch.arange(8 * 128, dtype=torch.int32, device=cuda).reshape(8, 128)
    assert torch.equal(debug.copy_probe(x), x)
    big = torch.arange(300 * 1024, dtype=torch.int32, device=cuda).reshape(300, 1024)
    assert torch.equal(debug.copy_probe(big), big)  # past 1,024 blocks: the grid-stride loop
    debug.empty_probe(cuda)
    torch.cuda.synchronize()


def test_the_fixture_and_probes_device_times(cuda):
    from bgsa_tpu_torch.benchutil import GRAPH_LAUNCHES, GRAPH_REPLAYS

    x = torch.arange(8 * 128, dtype=torch.int32, device=cuda).reshape(8, 128)
    debug.drain_kprints(cuda)
    times = {name: statistics.median(graph_times_ms(fn)) for name, fn in {
        "kprint_probe": lambda: debug.kprint_probe(x), "copy_probe": lambda: debug.copy_probe(x),
        "empty_probe": lambda: debug.empty_probe(cuda)}.items()}
    assert all(0 < t < 5 for t in times.values()), times
    # a warm-up launch, then each replay's launches (one warm-up replay)
    launches = 1 + GRAPH_LAUNCHES * (1 + GRAPH_REPLAYS)
    assert debug.drain_kprints(cuda) == (["probe 0"] * launches, 0)


def test_the_experiments_find_their_kernels_in_the_profiler(cuda):
    # each variant's kernel-name pattern matches exactly its own launches
    # (kernel_times raises unless a profiled run sees exactly one)
    from bgsa_tpu_torch.benchutil import kernel_times
    from bgsa_tpu_torch.scripts import exp_banded_packed_pair as packed_exp
    from bgsa_tpu_torch.scripts import exp_banded_pair as pair_exp

    q, s = banded_inputs(1, 150, 150, 8, "mix", S=3 * 200, Q=2)
    qt, codes = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    kw = dict(q_len=150, s_len=150, k=8)
    stream = pack.pack_banded_stream(codes, 8, 150)
    runs = {"single": lambda: bo.banded_stream(stream, qt, **kw),
            "pair": lambda: bpr.banded_stream_pair(stream, qt, **kw)}
    for label, mode in (("p_full", "full"), ("p_statc", "static_c"), ("p_noload", "noload")):
        runs[label] = lambda mode=mode: bpr.banded_probe(stream, qt, mode=mode, **kw)
    for name, run in runs.items():
        assert len(kernel_times({name: run}, pair_exp.KERNELS, cuda, 1)[name]) == 1, name
    streams = bp.pack_packed_streams(codes, 8, 150, 3)
    packed_runs = {"packed": lambda: bp.banded_stream_packed(streams, qt, **kw),
                   "pair": lambda: bpp.banded_packed_pair(streams, qt, **kw)}
    for label, mode in packed_exp.PROBES.items():
        packed_runs[label] = lambda mode=mode: bpp.banded_packed_probe(streams, qt, mode=mode, **kw)
    for name, run in packed_runs.items():
        assert len(kernel_times({name: run}, packed_exp.KERNELS, cuda, 1)[name]) == 1, name
