"""Hand-run tools of the port, the twins of the repository's ``scripts/``:
``exp_banded_pair`` and ``exp_banded_packed_pair`` (the paired-query banded
experiments), ``gpu_parity`` (every kernel family against the oracles),
``multihost_demo`` (N host roles, merged and byte-compared with one host)
and ``coverage_sweep`` (line coverage of the tests over the port); and
``read_filter``, the twin of ``examples/read_filter.py``. Run each as
``python -m bgsa_tpu_torch.scripts.<name>``."""
