"""Hand-run tools of the port, the twins of the repository's ``scripts/``:
``exp_banded_pair`` and ``exp_banded_packed_pair`` (the paired-query banded
experiments) and ``gpu_parity`` (every kernel family against the oracles).
Run each as ``python -m bgsa_tpu_torch.scripts.<name>``."""
