"""The benchmark of the PyTorch and CUDA port (``cess_tpu_torch``).

``run.py`` runs one cell once; ``BENCHMARK.json`` at the repository's
root names the cells, configurations and metrics; ``harness.py`` finds
each by name. Nothing here imports JAX or the JAX package.
"""
