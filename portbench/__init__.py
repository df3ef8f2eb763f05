"""The benchmark of ``bgsa_tpu_torch`` on the card (``python3 -m
portbench.run``; ``BENCHMARK.json`` at the checkout's root names its
cells and metrics). It imports neither JAX nor the JAX package."""
