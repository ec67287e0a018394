"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA H100s.

``run.py`` runs one cell of ``BENCHMARK.json``; ``README.md`` says how to add
a configuration, a traffic mix, a cell or a per-layer metric as files.
Nothing here imports JAX or the JAX package ``repro``; ``reference/``
imports nothing of the port either.
"""
