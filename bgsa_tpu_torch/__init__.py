"""bgsa_tpu_torch — the bgsa_tpu aligner in PyTorch, with CUDA kernels for Hopper.

A port of ``bgsa_tpu`` (JAX + Pallas on a TPU) to PyTorch on an NVIDIA H100.
``bgsa_tpu`` stays the reference: every score here is held bit-for-bit
against it. The port is self-contained: it imports torch, numpy and the
standard library, never jax and nothing of ``bgsa_tpu``, and keeps its own
copies of what it needs (file formats, schemes, host packers, oracle, the
bucketed driver).

Ported: every entry point and run mode of ``bgsa_tpu``. Unit-cost Myers
and general integer scoring (BitPAl, packed and non-packed, ``-M/-I/-G``,
``align(scoring=...)``), global and semi-global, and the banded filter
(``-k``, ``align(k=...)``), through the bucketed file pipeline
(``bgsa-torch-align``) and ``align()``, on one device or split over local
devices (``--shards``); heterogeneous co-compute over several devices
(``-t``, ``-n``, ``parallel.hetero``); multi-host roles (``--host``,
``-R``, ``-D``, resume) with ``bgsa-torch-merge`` and
``bgsa-torch-convert``; ``--profile``; the 31-bit reference-layout Myers
kernel and its device mesh (``parallel.mesh``); the repository's tools
that run kernels: ``scripts.gpu_parity`` (every kernel against the
oracles), the paired-query banded experiments (``scripts.exp_banded_pair``,
``scripts.exp_banded_packed_pair``), the read-filter example
(``scripts.read_filter``) and the kernel-print fixture (``debug``).

The package exports ``bgsa_tpu``'s names (``__all__``) from its own
modules; ``__version__`` is the version of the distribution that ships
both packages (``pyproject.toml``).
"""

from .api import align, encode_sequences
from .schemes import Algorithm, Mode, NormalizedScheme, Scoring, normalize

__all__ = [
    "Algorithm",
    "Mode",
    "NormalizedScheme",
    "Scoring",
    "align",
    "encode_sequences",
    "normalize",
]

__version__ = "0.4.0"
