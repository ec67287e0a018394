"""Public digest API over torch tensors.

Entry points (twins of ``repro.kernels.ops``):
  fingerprint_array(x)        -> (NBASES,) int32 residues of x's byte image
  fingerprint_and_copy(x)     -> (residues, copy) — single-pass mover kernel
  digest_of(x)                -> core.integrity.Digest (host convenience)
  matmul_with_digest(a, b)    -> (a @ b, residues of a) — fused consume+verify

Packing: any tensor is flattened to its little-endian byte image, zero-padded
to whole int32 words and then to the kernel tile, and the padding is divided
back out with the modular inverse of r^pad (GF(p) is a field), so the
residues equal the digest of the *true* byte stream — host
``fingerprint_bytes`` agrees bit for bit. Any dtype is accepted, 8-byte ones
included (the reference raises on those; ``fingerprint_bytes`` defines the
answer). A CUDA tensor is digested by the CUDA kernels, a CPU tensor by
their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.integrity import BASES, NBASES, P, Digest
from repro_torch.kernels import checksum as _ck
from repro_torch.kernels import matmul_digest as _mm


def _pow_mod(base: int, exp: int) -> int:
    return pow(int(base), int(exp), P)


def _to_words(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Flatten + reinterpret as int32 words (little-endian), zero-padding to 4B."""
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    if flat.storage_offset() % 4:     # a byte slice off a word boundary
        flat = flat.clone()
    nbytes = int(flat.numel())
    pad = (-nbytes) % 4
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(torch.int32), nbytes


def _pad_to_tile(words: torch.Tensor) -> torch.Tensor:
    padw = (-words.numel()) % _ck.TILE_WORDS
    return torch.cat([words, words.new_zeros(padw)]) if padw else words


def _unpad_residues(res: torch.Tensor, padded_bytes: int, true_bytes: int) -> torch.Tensor:
    """Divide out the trailing zero padding: H_true = H_pad * r^-(pad)."""
    pad = padded_bytes - true_bytes
    if pad == 0:
        return res
    inv = torch.tensor([_pow_mod(_pow_mod(r, pad), P - 2) for r in BASES],
                       dtype=torch.int64, device=res.device)
    return (res.to(torch.int64) * inv % P).to(torch.int32)


def fingerprint_array(x: torch.Tensor) -> torch.Tensor:
    """Digest residues (NBASES,) int32 of a tensor's little-endian byte image."""
    words, nbytes = _to_words(x)
    if words.numel() == 0:
        return torch.zeros(NBASES, dtype=torch.int32, device=x.device)
    words = _pad_to_tile(words)
    res = _ck.checksum_words(words)
    return _unpad_residues(res, words.numel() * 4, nbytes)


def fingerprint_and_copy(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-pass mover: returns (residues, copy-of-x)."""
    words, nbytes = _to_words(x)
    if words.numel() == 0:
        return torch.zeros(NBASES, dtype=torch.int32, device=x.device), x.clone()
    words = _pad_to_tile(words)
    res, copy_words = _ck.checksum_copy_words(words)
    res = _unpad_residues(res, words.numel() * 4, nbytes)
    copy = copy_words.view(torch.uint8)[:nbytes].view(x.dtype).reshape(x.shape)
    return res, copy


def digest_of(x: torch.Tensor) -> Digest:
    """Host-side Digest of a tensor (residues via the digest kernel)."""
    res = fingerprint_array(x).cpu().tolist()
    return Digest(tuple(int(v) for v in res), int(x.numel() * x.element_size()))


def matmul_with_digest(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
                       bk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused C = A @ B and digest of A (blocked order — see ``ref.blocked_view``).

    A is bfloat16. A B of another type than bfloat16 or float32 is cast to
    float32 first, as the reference casts it (``b.astype(f32)``).
    """
    if isinstance(b, torch.Tensor) and b.dtype not in (torch.bfloat16, torch.float32):
        b = b.float()
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        a, b = a.contiguous(), b.contiguous()
    return _mm.matmul_digest(a, b, bm=bm, bn=bn, bk=bk)
