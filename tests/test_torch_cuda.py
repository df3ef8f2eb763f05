"""The CUDA kernels on the card. Each test skips where no CUDA device is.

Run on a machine with a GPU: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Integer scores: kernel and plain version must be equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

from bgsa_tpu.benchutil import filter_mix_dataset
from bgsa_tpu_torch import pack
from bgsa_tpu_torch.banded_pipeline import KERNELS, BandedEngine
from bgsa_tpu_torch.ops import banded as bo
from bgsa_tpu_torch.ops import banded_packed as bp
from bgsa_tpu_torch.ops import bitpal as tb
from bgsa_tpu_torch.ops import bitpal_packed as tbp
from bgsa_tpu_torch.ops import build
from bgsa_tpu_torch.ops import myers_semiglobal as sg
from bgsa_tpu_torch.pipeline import Engine, PipelineConfig
from bgsa_tpu.schemes import Mode, Scoring, normalize

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


@pytest.mark.parametrize("n", [1, 32, 33, 150, 1025, 1100])  # 1100: scratch-state path
@pytest.mark.parametrize("is_global,factor", [(True, -1), (False, 1)])
def test_kernel_matches_plain(cuda, n, is_global, factor):
    rng = np.random.default_rng(n)
    q = torch.from_numpy(codes(rng, (3, 70))).to(cuda)
    eq = pack.pack_eq(torch.from_numpy(codes(rng, (300, n))).to(cuda), 32)
    before = sg.LAUNCHES
    got = sg.myers_semiglobal(eq, q, read_len=n, factor=factor, is_global=is_global)
    torch.cuda.synchronize()
    assert sg.LAUNCHES == before + 1
    want = sg.myers_semiglobal_ref(eq, q, read_len=n, factor=factor, is_global=is_global)
    assert torch.equal(got, want)


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
BANDED_PACKED = [(150, 158, 8), (150, 150, 8), (100, 100, 4), (40, 44, 4), (3, 5, 4)]
BANDED_STREAM = [(150, 150, 16), (150, 181, 16), (150, 150, 1), (70, 70, 0)]
BANDED_DUAL = [(100, 95, 20), (150, 148, 8), (41, 30, 20), (100, 99, 31)]
BANDED_PEQ = [(50, 20, 40), (55, 20, 40), (150, 150, 8)]
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


@pytest.mark.parametrize("S", [1, 129, 1000])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", BANDED_PEQ)
def test_banded_peq_kernel_matches_plain(cuda, m, n, k, kind, S):
    kernel_vs_plain(cuda, "banded", m, n, k, kind, S)


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
# an unpacked-only scheme and a wide one (28 planes unpacked)
BITPAL_SCHEMES = [(2, -3, -5), (1, -1, -1), (0, -2, -3), (5, -1, -2), (5, -4, -11)]


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
    assert (path, log, seconds) == (first.path, "", 0.0)
    other = Engine(normalize(Scoring(1, -1, -1)), PipelineConfig(), bitpal_cuda).load_library()
    assert other.path != first.path and other.path.endswith("-M1_I-1_G-1.so")
