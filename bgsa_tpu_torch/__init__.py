"""bgsa_tpu_torch — the bgsa_tpu aligner in PyTorch, with CUDA kernels for Hopper.

A port of ``bgsa_tpu`` (JAX + Pallas on a TPU) to PyTorch on an NVIDIA H100.
``bgsa_tpu`` stays the reference: every score here is held bit-for-bit
against it. The port is self-contained: it imports torch, numpy and the
standard library, never jax and nothing of ``bgsa_tpu``, and keeps its own
copies of what it needs (file formats, schemes, host packers, oracle, the
bucketed driver).

Ported so far: unit-cost Myers and general integer scoring (BitPAl,
packed and non-packed, ``-M/-I/-G``, ``align(scoring=...)``), global and
semi-global, and the banded filter (``-k``, ``align(k=...)``), through the
bucketed file pipeline (``bgsa-torch-align``) and ``align()``, on one
device or split over local devices (``--shards``); the 31-bit
reference-layout Myers kernel and its device mesh (``parallel.mesh``); the
repository's tools that run kernels: ``scripts.gpu_parity`` (every kernel
against the oracles), the paired-query banded experiments
(``scripts.exp_banded_pair``, ``scripts.exp_banded_packed_pair``) and the
kernel-print fixture (``debug``).
"""

from .api import align
from .schemes import Mode, Scoring

__all__ = ["Mode", "Scoring", "align"]
