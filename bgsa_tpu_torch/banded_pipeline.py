"""Banded-Myers filter pipeline on a torch device: the port's BandedEngine.

Counterpart of ``bgsa_tpu.banded_pipeline``: the same bucketed driver
(``pipeline.run_bucketed``) with the banded engine and int8 result records
(127 = over budget), so result and ``.info`` files are byte-identical to
``bgsa_tpu``'s. The host packs each bucket for transport, the payload is
uploaded, unpacked and packed into banded bit-streams on the device
(``bgsa_tpu_torch.pack``), and one of the four banded kernels scores it,
routed by geometry as the JAX engine routes. Under local sharding each
shard is packed and scored on its own device (the packed route pads each
shard's subjects to its own multiple of n_sub).
"""

from __future__ import annotations

import numpy as np
import torch

from . import pack
from .ops import banded as banded_ops
from .ops import banded_packed, build
from .pack import PAD_CODE
from .pipeline import Engine, PipelineConfig, run_bucketed
from .stats import Span


# route name -> (kernel wrapper, plain torch version). A wrapper launches
# its CUDA kernel for CUDA tensors and runs the plain version for CPU ones.
KERNELS = {
    "banded_stream_packed": (banded_packed.banded_stream_packed,
                             banded_packed.banded_stream_packed_ref),
    "banded_stream": (banded_ops.banded_stream, banded_ops.banded_stream_ref),
    "banded_stream_dual": (banded_ops.banded_stream_dual, banded_ops.banded_stream_dual_ref),
    "banded": (banded_ops.banded, banded_ops.banded_ref),
}


class BandedEngine(Engine):
    """Banded verification step (threshold k) on one or more torch devices.

    Same surface as ``bgsa_tpu_torch.pipeline.Engine`` (``local_shards`` and
    ``devices`` included). Routes like
    ``bgsa_tpu.banded_pipeline.BandedEngine``'s Pallas path, first match wins:

    1. s_len >= q_len and ``packed_subbands >= 2`` (and
       ``config.banded_packed``): the packed kernel, subjects padded to a
       multiple of n_sub;
    2. s_len >= q_len: the single-stream kernel;
    3. 2k <= 63: the dual-stream kernel;
    4. otherwise the Peq-carry kernel (``geometry`` raises where even the
       preload does not fit the 64-bit register).
    """

    result_dtype = torch.int8

    def __init__(self, threshold: int, config: PipelineConfig = PipelineConfig(),
                 device="cuda", *, devices=None):
        self.k = threshold
        self._set_devices(config, device, devices)

    def load_library(self) -> build.Kernels:
        return build.load()  # the four banded kernels are in the main library

    def route(self, q_len: int, s_len: int) -> str:
        """The kernel that scores this geometry (a key of ``KERNELS``)."""
        k = self.k
        n_sub = banded_packed.packed_subbands(q_len, s_len, k)
        if s_len >= q_len and n_sub >= 2 and self.config.banded_packed:
            return "banded_stream_packed"
        if s_len >= q_len:
            return "banded_stream"
        if 2 * k <= 63:
            return "banded_stream_dual"
        return "banded"

    def kernel_args(self, name: str, codes: torch.Tensor, q_len: int) -> tuple:
        """Kernel ``name``'s subject inputs, packed on the device from (S, n)
        codes. The packed kernel's subjects are padded with PAD_CODE rows to a
        multiple of n_sub; its output has a column for each padded row."""
        k, (S, s_len) = self.k, codes.shape
        if name == "banded_stream_packed":
            n_sub = banded_packed.packed_subbands(q_len, s_len, k)
            if n_sub < 2:
                raise ValueError(f"(q_len={q_len}, s_len={s_len}, k={k}) does not pack")
            if S % n_sub:
                pad = codes.new_full((-S % n_sub, s_len), PAD_CODE)
                codes = torch.cat([codes, pad])
            return (banded_packed.pack_packed_streams(codes, k, q_len, n_sub),)
        if name == "banded_stream":
            return (pack.pack_banded_stream(codes, k, q_len),)
        if name == "banded_stream_dual":
            return (pack.pack_banded_streams(codes, k, q_len),)
        if name == "banded":
            return pack.pack_banded(codes, k, q_len)
        raise ValueError(f"no banded kernel {name!r}")

    def score_codes(self, queries: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """(Q, m) query codes x (S, n) subject codes, both on one device ->
        (Q, S) int32 error counts (127 = over budget)."""
        q_len, (S, s_len) = queries.shape[1], codes.shape
        name = self.route(q_len, s_len)
        kernel = KERNELS[name][0]
        with Span("stream_pack"):
            args = self.kernel_args(name, codes, q_len)
        with Span("kernel"):
            # a view: the engine's narrowing copy (bgsa.narrow) applies it
            return kernel(*args, queries, q_len=q_len, s_len=s_len, k=self.k)[:, :S]


def run_banded(
    query_path: str,
    db_path: str,
    result_path: str,
    threshold: int,
    config: PipelineConfig = PipelineConfig(),
    shard: tuple[int, int] | None = None,
    shard_ratios=None,
    resume: bool = False,
    dynamic: bool = False,
    sync_dir: str | None = None,
    *,
    device="cuda",
    devices=None,
):
    """Banded filter run; the same multi-host, ``-D`` and resume surface as
    ``pipeline.run_alignment``.

    ``bgsa_tpu.banded_pipeline.run_banded`` on torch devices
    (``config.local_shards``, or the ``devices`` given). With
    ``shard=(host_id, n_hosts)`` writes this host's raw shard file and
    returns (stats, ShardMeta) for ``parallel.multihost.merge_shards``.
    """
    with Span("engine"):
        engine = BandedEngine(threshold, config, device, devices=devices)
    return run_bucketed(
        engine, query_path, db_path, result_path, config,
        shard=shard, shard_ratios=shard_ratios, resume=resume,
        write_dtype=np.int8, dynamic=dynamic, sync_dir=sync_dir,
    )
