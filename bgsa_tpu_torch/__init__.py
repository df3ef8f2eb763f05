"""bgsa_tpu_torch — the bgsa_tpu aligner in PyTorch, with CUDA kernels for Hopper.

A port of ``bgsa_tpu`` (JAX + Pallas on a TPU) to PyTorch on an NVIDIA H100.
``bgsa_tpu`` stays the reference: every score here is held bit-for-bit
against it. The port imports torch and never jax; it reuses ``bgsa_tpu``'s
jax-free modules (file formats, schemes, host packers, oracle, the bucketed
driver) rather than copying them.

Ported so far: unit-cost Myers and general integer scoring (BitPAl,
packed and non-packed, ``-M/-I/-G``, ``align(scoring=...)``), global and
semi-global, and the banded filter (``-k``, ``align(k=...)``), through the
bucketed file pipeline (``bgsa-torch-align``) and ``align()``.
"""

from bgsa_tpu.schemes import Mode, Scoring

from .api import align

__all__ = ["Mode", "Scoring", "align"]
