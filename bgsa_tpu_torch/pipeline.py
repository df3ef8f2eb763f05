"""Bucketed alignment pipeline on a torch device: the port's Engine.

``bgsa_tpu.pipeline.run_bucketed`` is jax-free and takes any engine with
``n_shards``, ``scores``/``scores_packed`` and ``compile_for``, so the
reader thread, uniform-shape padding, lag-1 drain, the reference-identical
result/``.info`` writer and resume are reused as they are. This module
supplies the engine: the host packs each bucket (``bgsa_tpu.pack``), the
payload is uploaded, unpacked and Eq-packed on the device
(``bgsa_tpu_torch.pack``), and the scheme's kernel scores it: the Myers
kernel for unit-cost schemes, a BitPAl kernel (packed or not, built for the
scheme) for general integer scoring.
"""

from __future__ import annotations

import numpy as np
import torch

from bgsa_tpu import pack as host_pack
from bgsa_tpu.pipeline import PipelineConfig, _pack_threads, run_bucketed
from bgsa_tpu.schemes import Algorithm, Mode, NormalizedScheme, Scoring, normalize

from . import pack
from .ops import build
from .ops.bitpal import BitpalParams, bitpal
from .ops.bitpal_packed import bitpal_packed, packed_supported
from .ops.myers_semiglobal import myers_semiglobal


class DeviceScores:
    """(Q, S) scores on the device, in the shape ``run_bucketed`` drains:
    indexing stays on the device, ``np.asarray`` synchronizes and copies to
    the host (``np.asarray`` on a CUDA tensor itself raises)."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor

    def __getitem__(self, index) -> DeviceScores:
        return DeviceScores(self.tensor[index])

    def __array__(self, dtype=None, copy=None):
        host = self.tensor.cpu().numpy()
        return host if dtype is None else host.astype(dtype, copy=False)


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host
    # pinned staging lets the copy queue behind the previous bucket's kernel
    # instead of blocking the host until it finishes
    return host.pin_memory().to(device, non_blocking=True)


def bitpal_packed_route(scheme: NormalizedScheme, bitpal_packed: bool = True) -> bool:
    """Whether a BitPAl run takes the packed kernel: the one predicate behind
    ``Engine.word_bits`` and ``Engine.kernel``, as
    ``bgsa_tpu.pipeline.bitpal_packed_route`` (which imports jax) is behind
    the JAX engine's. False: the non-packed kernel (user opt-out, or a
    scheme the packed decode cannot serve, M > 2I - 2G + 1)."""
    if scheme.algorithm is not Algorithm.BITPAL or not bitpal_packed:
        return False
    return packed_supported(BitpalParams(scheme.match, scheme.mismatch, scheme.gap))


class Engine:
    """Scoring step for one Myers or BitPAl scheme on one torch device.

    Counterpart of ``bgsa_tpu.pipeline.Engine`` on one device
    (``n_shards == 1``): Myers schemes in full 32-bit words in both modes;
    BitPAl schemes on the packed kernel where it applies and
    ``config.bitpal_packed`` allows, else the non-packed one, in the word
    layout ``config.bitpal_carry`` picks. Subclasses score other families by
    overriding ``score_codes`` and ``result_dtype``
    (``banded_pipeline.BandedEngine``).
    """

    n_shards = 1
    result_dtype = torch.int16

    def __init__(self, scheme: NormalizedScheme, config: PipelineConfig = PipelineConfig(),
                 device="cuda"):
        if scheme.algorithm is Algorithm.BITPAL:
            BitpalParams(scheme.match, scheme.mismatch, scheme.gap)  # M > I > 2G
        elif scheme.algorithm is not Algorithm.MYERS:
            raise ValueError(f"{scheme.algorithm.value} schemes run through "
                             "banded_pipeline.BandedEngine, not Engine")
        self.scheme = scheme
        self._set_device(config, device)

    @property
    def kernel(self) -> str:
        """The kernel that scores this engine's scheme: "myers_semiglobal",
        "bitpal_packed" or "bitpal"."""
        if self.scheme.algorithm is Algorithm.MYERS:
            return "myers_semiglobal"
        return "bitpal_packed" if bitpal_packed_route(
            self.scheme, self.config.bitpal_packed) else "bitpal"

    @property
    def word_bits(self) -> int:
        """Eq word layout: 32 for Myers; for BitPAl 32-bit compare-carry or
        31-bit reserved-carry words, as ``bgsa_tpu.pipeline.Engine.word_bits``
        picks them (``bitpal_carry=None``: 31 on the packed route, 32 on the
        non-packed one; True/False force 32/31)."""
        if self.scheme.algorithm is not Algorithm.BITPAL:
            return 32
        carry = self.config.bitpal_carry
        if carry is None:
            carry = self.kernel == "bitpal"
        return 32 if carry else 31

    def _set_device(self, config: PipelineConfig, device) -> None:
        if config.local_shards != 1:
            raise NotImplementedError(
                "local multi-GPU sharding is not ported yet (ROADMAP queue 1 #8)"
            )
        self.config = config
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")

    def compile_for(self, nq: int, q_len: int, rows: int, s_len: int,
                    transport: str, sidecar: int = 0) -> None:
        """Build and load the kernel's library before the first timed bucket,
        so the nvcc build is billed to compile_time, not cal_time. One
        library serves every geometry: the main one for Myers, the scheme's
        own for BitPAl."""
        if self.device.type == "cuda":
            self.load_library()
            torch.empty(0, device=self.device)  # create the CUDA context here too

    def load_library(self) -> build.Kernels:
        """Build (on first use) and load the library of this engine's kernel."""
        if self.kernel == "myers_semiglobal":
            return build.load()
        s = self.scheme
        return build.load_scheme(self.kernel, s.match, s.mismatch, s.gap)

    def score_codes(self, queries: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """(Q, m) query codes x (S, n) subject codes, both on the device ->
        (Q, S) int32 scores."""
        s, word_bits = self.scheme, self.word_bits
        eq = pack.pack_eq(codes, word_bits)
        if s.algorithm is Algorithm.MYERS:
            return myers_semiglobal(
                eq, queries, read_len=codes.shape[1], factor=s.factor,
                is_global=s.mode is Mode.GLOBAL,
            )
        kernel = bitpal_packed if self.kernel == "bitpal_packed" else bitpal
        return kernel(eq, queries, match=s.match, mismatch=s.mismatch, gap=s.gap,
                      read_len=codes.shape[1], factor=s.factor,
                      semi_global=s.mode is Mode.SEMI_GLOBAL, word_bits=word_bits)

    def scores_packed(self, query_codes: np.ndarray, transport: str, payload, s_len: int):
        """Score a transport-packed subject batch (``bgsa_tpu.pack.select_transport``)
        -> DeviceScores of (Q, S) ``result_dtype``."""
        dev = self.device
        if isinstance(payload, tuple):
            payload = tuple(_upload(p, dev) for p in payload)
        else:
            payload = _upload(payload, dev)
        queries = _upload(np.asarray(query_codes, np.uint8), dev)
        codes = pack.transport_unpack(transport)(payload, s_len)
        return DeviceScores(self.score_codes(queries, codes).to(self.result_dtype))

    def scores(self, query_codes: np.ndarray, subject_codes: np.ndarray):
        """(Q, m) x (S, n) codes -> DeviceScores of (Q, S) ``result_dtype``."""
        transport, payload = host_pack.select_transport(
            subject_codes, threads=_pack_threads(self.config)
        )
        return self.scores_packed(query_codes, transport, payload, subject_codes.shape[1])


def run_alignment(
    query_path: str,
    db_path: str,
    result_path: str,
    scoring: Scoring = Scoring(0, -1, -1),
    mode: Mode = Mode.GLOBAL,
    config: PipelineConfig = PipelineConfig(),
    shard: tuple[int, int] | None = None,
    shard_ratios=None,
    resume: bool = False,
    dynamic: bool = False,
    sync_dir: str | None = None,
    *,
    device="cuda",
):
    """Full aligner run with the reference's CLI semantics; returns RunStats.

    ``bgsa_tpu.pipeline.run_alignment`` on a torch device: unit-cost
    schemes on the Myers kernel, general integer scoring on BitPAl
    (``config.bitpal_packed``, ``config.bitpal_carry`` as there).
    ``resume=True`` continues an interrupted run. Multi-host roles
    (``shard``, ``shard_ratios``, ``dynamic``, ``sync_dir``) are not ported
    yet.
    """
    if shard is not None or shard_ratios is not None or dynamic or sync_dir is not None:
        raise NotImplementedError(
            "multi-host roles, -R and -D are not ported yet (ROADMAP queue 1 #8)"
        )
    engine = Engine(normalize(scoring, mode), config, device)
    return run_bucketed(
        engine, query_path, db_path, result_path, config,
        shard=None, shard_ratios=None, resume=resume, write_dtype=np.int16,
    )
