"""The CUDA kernel on the card. Each test skips where no CUDA device is.

Run on a machine with a GPU: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Integer scores: kernel and plain version must be equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

from bgsa_tpu_torch import pack
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
