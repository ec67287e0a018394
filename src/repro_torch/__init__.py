"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package is its twin,
module for module under the same names, and imports nothing of it (nor of
JAX). Ported so far: the chunked, integrity-checked transfer whose digests
run in hand-written CUDA kernels (``core``, ``kernels``), checkpoints
(``ckpt``), the transfer service and what it drives (``service``, ``cas``,
``resil``, ``tune``, ``faults``, ``fabric``, ``obs``, ``launch.transferd``),
the dense transformer with its optimizer, data pipeline and train and
serve launchers (``models``, ``configs``, ``optim``, ``data``,
``distributed.mesh``, ``launch``), and ``convert`` to carry plans,
digests, state and params across from the reference.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
