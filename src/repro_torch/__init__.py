"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package is its twin,
module for module under the same names, and imports nothing of it (nor of
JAX). Ported so far: the chunked, integrity-checked transfer whose fused
verification digests run in hand-written CUDA kernels (``core``,
``kernels``), with the observability it needs (``obs``) and ``convert``
to carry plans and digests across from the reference.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
