"""Hand-written Hopper kernels for the integrity digest, and their API.

  csrc/checksum.cu — CUDA C++ digest kernels (single stream, k streams,
                     copy-and-digest), plain ``extern "C"`` interface
  _build.py        — builds them with nvcc at first use, binds with ctypes
  checksum.py      — tables, wrappers and launch counts
  ops.py           — public API over torch tensors of any dtype
  ref.py           — plain PyTorch versions (CPU tests, on-card comparison)

``matmul_with_digest`` of the reference is not ported yet.
"""
from repro_torch.kernels.ops import digest_of, fingerprint_and_copy, fingerprint_array

__all__ = ["digest_of", "fingerprint_and_copy", "fingerprint_array"]
