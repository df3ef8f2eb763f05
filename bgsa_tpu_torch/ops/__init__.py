"""Kernels of the port, each with its plain torch version beside it.

``myers_semiglobal`` ports ``bgsa_tpu/ops/myers_semiglobal.py`` and
``myers_pallas`` ports ``bgsa_tpu/ops/myers_pallas.py`` (the 31-bit
reference-layout Myers of the device mesh); ``banded`` (stream,
dual-stream and Peq-carry kernels) and ``banded_packed`` port
``bgsa_tpu/ops/banded.py`` and ``bgsa_tpu/ops/banded_packed.py``;
``bitpal`` and ``bitpal_packed`` port the two BitPAl kernels. ``build``
compiles the CUDA sources under ``csrc/``. ``bgsa_tpu/ops/blockutil.py``
(TPU VMEM block sizing, row padding to 128-lane tiles) has no counterpart:
the CUDA kernels mask the ragged subject edge themselves and keep their
state in registers or a scratch buffer the wrapper allocates.
"""
