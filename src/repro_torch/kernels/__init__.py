"""Hand-written Hopper kernels for the integrity digest, and their API.

  csrc/checksum.cu      — CUDA C++ digest kernels (single stream, k streams,
                          copy-and-digest), plain ``extern "C"`` interface
  csrc/matmul_digest.cu — CUDA C++ fused C = A @ B + digest of A
  _build.py             — builds them with nvcc at first use, binds with ctypes
  checksum.py           — digest tables, wrappers and launch counts
  matmul_digest.py      — matmul weight tables, wrapper and launch count
  ops.py                — public API over torch tensors
  ref.py                — plain PyTorch versions (CPU tests, on-card comparison)
"""
from repro_torch.kernels.ops import (
    digest_of,
    fingerprint_and_copy,
    fingerprint_array,
    matmul_with_digest,
)

__all__ = ["digest_of", "fingerprint_and_copy", "fingerprint_array", "matmul_with_digest"]
