"""bgsa_tpu_torch.graft_entry against __graft_entry__.py and bgsa_tpu, on the CPU.

``entry("cpu")``'s step on its example inputs equals the JAX file's
``entry()`` step (its CPU branch: 31-bit words through ``myers_xla``) and
the oracle; ``dryrun_multichip`` passes on ``["cpu"] * n`` (odd n: one
query shard; even n: two), and each of its six steps' scores equals the JAX
package's function on the same inputs, regenerated from
``default_rng(0)`` in the JAX file's order (tolerance 0: integer scores); a
kernel that flips one score makes the step that ran it raise; a CUDA device
where there is none raises.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from bgsa_tpu import oracle as jax_oracle
from bgsa_tpu import pack as jax_pack
from bgsa_tpu.banded_pipeline import BandedEngine as JaxBandedEngine
from bgsa_tpu.ops import bitpal_packed as jax_bitpal_packed
from bgsa_tpu.ops import myers_semiglobal as jax_myers_semiglobal
from bgsa_tpu.ops import myers_xla
from bgsa_tpu.pipeline import Engine as JaxEngine
from bgsa_tpu.pipeline import PipelineConfig as JaxConfig
from bgsa_tpu.schemes import Mode as JaxMode
from bgsa_tpu.schemes import Scoring as JaxScoring
from bgsa_tpu.schemes import normalize as jax_normalize
from bgsa_tpu_torch import banded_pipeline, graft_entry, oracle, pipeline
from bgsa_tpu_torch.parallel import mesh

SIZES = (1, 2, 3, 4, 8)


def test_entry_matches_the_jax_entry_and_the_oracle():
    fn, (qcodes, scodes) = graft_entry.entry("cpu")
    assert qcodes.dtype == scodes.dtype == torch.int32 and qcodes.device.type == "cpu"
    assert tuple(qcodes.shape) == (4, 100) and tuple(scodes.shape) == (1024, 100)
    got = fn(qcodes, scodes)
    assert got.dtype == torch.int16 and tuple(got.shape) == (4, 1024)
    jax_fn, (jq, js) = jax_entry.entry()
    np.testing.assert_array_equal(qcodes.numpy(), jq)
    np.testing.assert_array_equal(scodes.numpy(), js)
    want = np.asarray(jax_fn(jq, js))
    assert want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), -oracle.edit_distances(jq[i], js))
        np.testing.assert_array_equal(got[i].numpy(), -jax_oracle.edit_distances(jq[i], js))


@pytest.fixture(scope="module")
def dryruns():
    return {}


def dryrun(dryruns, n):
    if n not in dryruns:
        dryruns[n] = graft_entry.dryrun_multichip(n, ["cpu"] * n)
    return dryruns[n]


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_passes_on_cpu_devices(dryruns, n):
    out = dryrun(dryruns, n)
    assert tuple(out) == graft_entry.STEPS
    query_shards = 2 if n % 2 == 0 else 1
    shape = (2 * query_shards, 128 * (n // query_shards))
    for step in graft_entry.STEPS[:4]:
        assert out[step].shape == shape, step
    assert out["banded_packed"].shape == (2, 256)
    assert out["sidecar"].shape == (shape[0], 256 * n * max(1, -(-8 // n)))


def dryrun_inputs(n):
    """The JAX file's inputs for n devices, drawn from one default_rng(0) in
    its order: (q, s) of steps 1-4 and 6's queries, (q4, s4), s_n."""
    rng = np.random.default_rng(0)
    query_shards = 2 if n % 2 == 0 else 1
    q = rng.integers(0, 4, size=(2 * query_shards, 32)).astype(np.int32)
    s = rng.integers(0, 4, size=(128 * (n // query_shards), 32))
    q4 = rng.integers(0, 4, size=(2, 150)).astype(np.int32)
    s4 = rng.integers(0, 4, size=(256, 150))
    s4[:32] = q4[0]
    s_n = rng.integers(0, 4, size=(256 * n * max(1, -(-8 // n)), 40))
    s_n[::17, 3] = 4
    return q, s, q4, s4, s_n


def jax_step(step, n):
    """The JAX package's function of one dry-run step on its inputs."""
    q, s, q4, s4, s_n = dryrun_inputs(n)
    xla = JaxConfig(backend="xla")
    if step == "myers_mesh":
        return myers_xla.myers_global(jax_pack.pack_eq(s, 31), q, read_len=32)
    if step == "myers_semiglobal":
        return jax_myers_semiglobal.myers_semiglobal_xla(jax_pack.pack_eq(s, 32), q, read_len=32)
    if step == "bitpal_packed":
        return jax_bitpal_packed.bitpal_packed_xla(jax_pack.pack_eq(s, 31), q, match=2,
                                                   mismatch=-3, gap=-5, read_len=32)
    if step == "banded":
        return JaxBandedEngine(3, xla).scores(q, s)
    if step == "banded_packed":
        return JaxBandedEngine(8, xla).scores(q4, s4)
    return JaxEngine(jax_normalize(JaxScoring(0, -1, -1), JaxMode.GLOBAL), xla).scores(q, s_n)


@pytest.mark.parametrize("step", graft_entry.STEPS)
@pytest.mark.parametrize("n", [2, 3])
def test_each_step_equals_the_jax_package(dryruns, n, step):
    got = dryrun(dryruns, n)[step]
    want = np.asarray(jax_step(step, n))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_the_mesh_step_matches_the_oracle_everywhere(dryruns):
    q, s, *_ = dryrun_inputs(4)
    got = dryrun(dryruns, 4)["myers_mesh"]
    for i in range(len(q)):
        np.testing.assert_array_equal(got[i], -oracle.edit_distances(q[i], s))


def flip_first(fn, when=lambda kw: True):
    """``fn`` whose first call that ``when`` accepts returns one score + 1."""
    calls = []

    def flipped(*args, **kw):
        out = fn(*args, **kw)
        if when(kw) and not calls:
            calls.append(1)
            out = out.clone()
            out[0, 0] += 1
        return out

    return flipped


@pytest.mark.parametrize("step", graft_entry.STEPS)
def test_a_flipped_score_fails_its_step(monkeypatch, step):
    packed = "banded_stream_packed"
    kernel, ref = banded_pipeline.KERNELS[packed]
    if step == "myers_mesh":
        monkeypatch.setattr(mesh, "myers_global", flip_first(mesh.myers_global))
    elif step in ("myers_semiglobal", "bitpal_packed"):
        monkeypatch.setattr(graft_entry, step, flip_first(getattr(graft_entry, step)))
    elif step == "banded":  # k = 3 at 32 bp is the packed route too
        monkeypatch.setitem(banded_pipeline.KERNELS, packed, (flip_first(kernel), ref))
    elif step == "banded_packed":
        monkeypatch.setitem(banded_pipeline.KERNELS, packed,
                            (flip_first(kernel, lambda kw: kw["q_len"] == 150), ref))
    else:
        monkeypatch.setattr(pipeline, "myers_semiglobal", flip_first(pipeline.myers_semiglobal))
    with pytest.raises(graft_entry.DryRunMismatch, match=step) as err:
        graft_entry.dryrun_multichip(2, ["cpu"] * 2)
    assert err.value.step == step


def test_without_a_card_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2, ["cuda:0"] * 2)


def test_too_few_visible_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 devices asked, 1 visible"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("n, devices", [(0, None), (2, ["cpu"]), (1, ["cpu"] * 2)])
def test_a_device_list_that_does_not_fit_raises(n, devices):
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(n, devices)
