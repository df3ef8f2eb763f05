"""The flagship step and the multi-device dry run of the port.

The twin of the repository's ``__graft_entry__.py``, on torch devices:

- ``entry(device)`` returns ``(fn, example_args)``: the engine's main path
  (``pack.pack_eq`` into 32-bit Eq words, then the full-word Myers kernel,
  ``ops.myers_semiglobal``, in global mode) on the JAX file's inputs. The
  tensors' device picks kernel or plain version, as everywhere in the port:
  on a CUDA tensor ``fn`` launches the kernel, on a CPU tensor it runs the
  plain version of the same full-word function (the JAX file's CPU branch,
  31-bit words through ``myers_xla``, scores the same).
- ``dryrun_multichip(n_devices, devices)`` runs one step of every kernel
  family over n devices, in the JAX file's order and on its inputs (one
  ``np.random.default_rng(0)`` drawn in the same order): the 31-bit Myers
  mesh, semi-global Myers and packed BitPAl with the subjects sharded,
  banded through the engine's shards, the packed-field banded kernel on two
  shards, and the ``2bitN`` sidecar transport under sharding. Each sharded
  result is held to the oracle (step 1) or to one device (steps 2-6); a
  mismatch raises ``DryRunMismatch`` naming the step.

There is no CPU fallback: a CUDA device where none is present raises
``RuntimeError``. A caller with one card passes ``["cuda:0"] * n``; the
tests pass ``["cpu"] * n``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pack
from .banded_pipeline import BandedEngine
from .oracle import edit_distances
from .ops.banded_packed import packed_subbands
from .ops.bitpal_packed import bitpal_packed
from .ops.myers_semiglobal import myers_semiglobal
from .parallel import mesh as mesh_mod
from .pipeline import Engine, PipelineConfig
from .schemes import Mode, Scoring, normalize

# the flagship step's shape (``__graft_entry__.py:36``)
Q, M, S, N = 4, 100, 1024, 100
STEPS = ("myers_mesh", "myers_semiglobal", "bitpal_packed", "banded", "banded_packed",
         "sidecar")


class DryRunMismatch(RuntimeError):
    """A sharded step of the dry run disagreed with its reference."""

    def __init__(self, step: str, what: str):
        super().__init__(f"dryrun step {step!r}: {what}")
        self.step = step


def _need_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass a CPU device to run the plain versions")


def flagship(qcodes: torch.Tensor, scodes: torch.Tensor) -> torch.Tensor:
    """(Q, m) query codes x (S, n) subject codes -> (Q, S) int16 global
    unit-cost scores (negated edit distances): Eq packing, then the
    full-word Myers kernel."""
    eq = pack.pack_eq(scodes, 32)
    scores = myers_semiglobal(eq, qcodes, read_len=scodes.shape[1], factor=-1, is_global=True)
    return scores.to(torch.int16)


def entry(device="cuda"):
    """(fn, example_args): the flagship step and the JAX file's inputs, as
    int32 tensors on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        _need_cuda("entry")
    rng = np.random.default_rng(0)
    qcodes = rng.integers(0, 4, size=(Q, M)).astype(np.int32)
    scodes = rng.integers(0, 4, size=(S, N)).astype(np.int32)
    return flagship, (torch.from_numpy(qcodes).to(device), torch.from_numpy(scodes).to(device))


def _devices(n_devices: int, devices) -> list:
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if devices is None:
        _need_cuda("dryrun_multichip")
        visible = torch.cuda.device_count()
        if visible < n_devices:
            raise RuntimeError(f"dryrun_multichip: {n_devices} devices asked, {visible} "
                               "visible; pass devices= (e.g. ['cuda:0'] * n)")
        return [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for n_devices={n_devices}")
    if any(d.type == "cuda" for d in devices):
        _need_cuda("dryrun_multichip")
    return devices


def _equal(step: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise DryRunMismatch(step, f"the sharded scores {got.shape} differ from one "
                                   f"device's {want.shape}")


def _subject_sharded(step: str, fn, eq: torch.Tensor, q: np.ndarray, devices) -> np.ndarray:
    """``fn(eq_slice, queries)`` on each device's slice of eq along S (the
    queries on every device), the slices' scores concatenated, held to one
    call on the first device."""
    parts = [fn(e.to(d), torch.from_numpy(q).to(d)) for e, d in
             zip(eq.chunk(len(devices), dim=2), devices)]
    got = torch.cat([p.cpu() for p in parts], dim=1).numpy()
    _equal(step, got, fn(eq.to(devices[0]), torch.from_numpy(q).to(devices[0])).cpu())
    return got


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One step of every kernel family over ``n_devices`` devices (the
    first ``n_devices`` CUDA devices, or ``devices``, repeats allowed);
    returns {step: scores as numpy} for the six ``STEPS``."""
    devices = _devices(n_devices, devices)
    n = n_devices
    out = {}

    # 1. 31-bit Myers over a (subjects, queries) mesh, merged, one score
    # against the oracle (__graft_entry__.py:61-80)
    query_shards = 2 if n % 2 == 0 else 1
    mesh = mesh_mod.make_mesh(devices, query_shards=query_shards)
    rng = np.random.default_rng(0)
    nq, ns = 2 * query_shards, 128 * (n // query_shards)
    m = length = 32
    q = rng.integers(0, 4, size=(nq, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(ns, length))
    eq31 = pack.eq_from_numpy(pack.pack_eq_host(s, 31))
    got = mesh_mod.myers_global_sharded(eq31, torch.from_numpy(q), mesh, read_len=length,
                                        merge=True).cpu().numpy()
    if got.shape != (nq, ns):
        raise DryRunMismatch(STEPS[0], f"shape {got.shape}, not {(nq, ns)}")
    want = -edit_distances(q[0], s[:1])[0]
    if got[0, 0] != want:
        raise DryRunMismatch(STEPS[0], f"score [0, 0] {got[0, 0]}, the oracle's {want}")
    out[STEPS[0]] = got

    # 2. full-word semi-global Myers, subjects sharded (:103-108)
    eq32 = pack.eq_from_numpy(pack.pack_eq_host(s, 32))
    out[STEPS[1]] = _subject_sharded(
        STEPS[1], lambda e, qq: myers_semiglobal(e, qq, read_len=length), eq32, q, devices)

    # 3. packed BitPAl (2, -3, -5) on 31-bit words, subjects sharded (:110-115)
    out[STEPS[2]] = _subject_sharded(
        STEPS[2], lambda e, qq: bitpal_packed(e, qq, match=2, mismatch=-3, gap=-5,
                                              read_len=length), eq31, q, devices)

    # 4. banded through the engine's own shards (:127-136)
    k = 3
    engine = BandedEngine(k, PipelineConfig(), devices=devices)
    if engine.n_shards != n:
        raise DryRunMismatch(STEPS[3], f"{engine.n_shards} shards, not {n}")
    got = np.asarray(engine.scores(q, s))
    _equal(STEPS[3], got, BandedEngine(k, PipelineConfig(), devices=devices[:1]).scores(q, s))
    out[STEPS[3]] = got

    # 5. the packed-field banded kernel at k = 8, 150 bp, on two shards
    # (:150-158; a live stripe, so both dead and live lanes score)
    k4, m4, n4 = 8, 150, 150
    if packed_subbands(m4, n4, k4) != 3:
        raise DryRunMismatch(STEPS[4], f"n_sub {packed_subbands(m4, n4, k4)}, not 3")
    q4 = rng.integers(0, 4, size=(2, m4)).astype(np.int32)
    s4 = rng.integers(0, 4, size=(256, n4))
    s4[:32] = q4[0]
    two = devices[:2] if n >= 2 else devices[:1] * 2
    got = np.asarray(BandedEngine(k4, PipelineConfig(), devices=two).scores(q4, s4))
    _equal(STEPS[4], got, BandedEngine(k4, PipelineConfig(), devices=two[:1]).scores(q4, s4))
    out[STEPS[4]] = got

    # 6. N-containing subjects on the 2bit + sidecar transport, pre-split per
    # shard (:164-179)
    s2 = 256 * n * max(1, -(-8 // n))
    s_n = rng.integers(0, 4, size=(s2, 40))
    s_n[::17, 3] = 4
    transport = pack.select_transport(s_n, n_shards=n)[0]
    if transport != "2bitN":
        raise DryRunMismatch(STEPS[5], f"transport {transport!r}, not '2bitN'")
    scheme = normalize(Scoring(0, -1, -1), Mode.GLOBAL)
    got = np.asarray(Engine(scheme, PipelineConfig(), devices=devices).scores(q, s_n))
    _equal(STEPS[5], got, Engine(scheme, PipelineConfig(), devices=devices[:1]).scores(q, s_n))
    out[STEPS[5]] = got
    return out
