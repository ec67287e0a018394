"""Plain PyTorch versions of the integrity kernels.

Each function computes what a CUDA kernel in ``csrc/`` computes,
with ordinary tensor operations in int64, on whatever device its inputs lie
on. The CPU tests use them, the kernel wrappers use them for CPU tensors
only, and ``chip_smoke.py`` holds each kernel against them on the card.
They repeat the kernels' arithmetic and are no yardstick of speed.

The digest is defined over an array's little-endian byte image, exactly like
the host ``core.integrity.fingerprint_bytes``; zero padding to whole words or
tiles is divided back out with the modular inverse of r^pad. Twin of
``repro.kernels.ref`` (the pure-jnp oracles).
"""
from __future__ import annotations

import torch

from repro_torch.core.integrity import BASES, NBASES, P

_LANE = 128  # bytes folded per group in the byte-stream oracle
SPLIT_TERMS = 3  # bf16 terms of a float32 in split_bf16x3
SPLIT_SLAB = 64  # rows of a slab of one term in split_bf16x3's layout (the kernel's K slab)
_CANONICAL_NAN = 0x7FC00000


def _pow_mod(base: int, exp: int) -> int:
    return pow(int(base), int(exp), P)


def _pow_mod_tensor(base: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """base ** exps mod P elementwise, by square-and-multiply (int64).

    ``base`` broadcasts against ``exps``; both non-negative, base < P.
    """
    base = base.to(torch.int64)
    e = exps.to(torch.int64).clone()
    out = torch.ones(torch.broadcast_shapes(base.shape, e.shape),
                     dtype=torch.int64, device=e.device)
    sq = base.expand_as(out).clone()
    while bool((e > 0).any()):
        odd = (e & 1) == 1
        out = torch.where(odd, out * sq % P, out)
        sq = sq * sq % P
        e >>= 1
    return out


def _fold_positional(h: torch.Tensor, step_pow: torch.Tensor) -> torch.Tensor:
    """Merge law over the second-to-last axis: H = sum_i h_i * s^(m-1-i).

    ``h`` is (..., m, NBASES) residues in order, ``step_pow`` (NBASES,) the
    weight r^len of one part. Returns (..., NBASES).
    """
    m = h.shape[-2]
    exps = torch.arange(m - 1, -1, -1, dtype=torch.int64, device=h.device)
    w = _pow_mod_tensor(step_pow.to(h.device)[None, :], exps[:, None])  # (m, NBASES)
    return (h.to(torch.int64) * w % P).sum(dim=-2) % P


def _tile_hashes(words: torch.Tensor, w0: torch.Tensor, rinv: torch.Tensor) -> torch.Tensor:
    """Per-tile hashes of (..., tiles * ROWS * LANES) int32 words.

    The arithmetic of the TPU kernel's tile body: four byte planes, each
    weighted by W0 = r^(T-1-4m), folded over lanes then rows mod P, and
    shifted by r^-k. Returns (..., tiles, NBASES) int64.
    """
    rows, lanes = int(w0.shape[1]), int(w0.shape[2])
    shape = words.shape[:-1] + (-1, rows, lanes)
    w = words.reshape(shape).to(torch.int64)
    w0 = w0.to(device=words.device, dtype=torch.int64)
    rinv = rinv.to(device=words.device, dtype=torch.int64)
    th = []
    for b in range(NBASES):
        acc = torch.zeros(w.shape[:-2], dtype=torch.int64, device=words.device)
        for k in range(4):
            # int64 of a sign-extended word: mask after the shift
            plane = (w >> (8 * k)) & 255
            s = (plane * w0[b]).sum(dim=-1) % P        # lane fold
            s = s.sum(dim=-1) % P                       # row fold
            acc = (acc + s * rinv[b, k]) % P            # plane shift r^-k
        th.append(acc)
    return torch.stack(th, dim=-1)


def checksum_many_words_ref(words2d: torch.Tensor, w0: torch.Tensor,
                            rinv: torch.Tensor, rpow: torch.Tensor) -> torch.Tensor:
    """Digest residues (k, NBASES) int32 of k equal-length int32 streams.

    ``words2d`` is (k, n) with n a multiple of the tile; the tables are the
    ones ``kernels.checksum.tables`` builds (W0, r^-k, r^T).
    """
    th = _tile_hashes(words2d, w0, rinv)                       # (k, tiles, NB)
    return _fold_positional(th, rpow.reshape(-1)).to(torch.int32)


def checksum_words_ref(words: torch.Tensor, w0: torch.Tensor,
                       rinv: torch.Tensor, rpow: torch.Tensor) -> torch.Tensor:
    """Digest residues (NBASES,) int32 of one tile-aligned int32 stream."""
    return checksum_many_words_ref(words.reshape(1, -1), w0, rinv, rpow)[0]


def checksum_copy_words_ref(words: torch.Tensor, w0: torch.Tensor, rinv: torch.Tensor,
                            rpow: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(residues, copy) of one tile-aligned int32 stream."""
    return checksum_words_ref(words, w0, rinv, rpow), words.clone()


def _lane_weights(device: torch.device) -> torch.Tensor:
    """(NBASES, _LANE) int64: r^(_LANE-1-k) for each base."""
    k = torch.arange(_LANE - 1, -1, -1, dtype=torch.int64, device=device)
    r = torch.tensor(BASES, dtype=torch.int64, device=device)
    return _pow_mod_tensor(r[:, None], k[None, :])


def fingerprint_bytes_ref(b: torch.Tensor) -> torch.Tensor:
    """Digest residues (NBASES,) int32 of a uint8 vector.

    Two-level fold: within 128-byte groups a weighted lane sum, then the
    merge law across groups, then the zero padding divided back out.
    """
    n = int(b.numel())
    if n == 0:
        return torch.zeros(NBASES, dtype=torch.int32, device=b.device)
    pad = (-n) % _LANE
    bp = torch.cat([b.reshape(-1), b.new_zeros(pad)]).to(torch.int64).reshape(-1, _LANE)
    group = (bp[:, None, :] * _lane_weights(b.device)[None]).sum(dim=-1) % P  # (g, NB)
    step = torch.tensor([_pow_mod(r, _LANE) for r in BASES], dtype=torch.int64)
    h = _fold_positional(group, step)
    if pad:
        inv = torch.tensor([_pow_mod(_pow_mod(r, pad), P - 2) for r in BASES],
                           dtype=torch.int64, device=b.device)
        h = h * inv % P
    return h.to(torch.int32)


def to_byte_stream(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Flatten any tensor to its little-endian uint8 byte image (+length)."""
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    return flat, int(flat.numel())


def fingerprint_array_ref(x: torch.Tensor) -> torch.Tensor:
    """Digest residues (NBASES,) int32 of a tensor's byte image."""
    return fingerprint_bytes_ref(to_byte_stream(x)[0])


def blocked_view(a: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """Rearrange (M, K) into tile-major order: (M/bm, K/bk, bm, bk) flattened.

    The fused matmul + digest kernel's digest is defined over this blocked
    byte order (tile (i, k) at index i * K/bk + k), whatever tiles the
    kernel itself uses.
    """
    M, K = a.shape
    if M % bm or K % bk:
        raise ValueError(f"shape {tuple(a.shape)} is not divisible by ({bm}, {bk})")
    return a.reshape(M // bm, bm, K // bk, bk).permute(0, 2, 1, 3).reshape(-1)


def matmul_digest_ref(a: torch.Tensor, b: torch.Tensor, bm: int = 128, bk: int = 128):
    """Plain version of the fused kernel: (a @ b in float32, residues of blocked a)."""
    out = a.float() @ b.float()
    return out, fingerprint_array_ref(blocked_view(a, bm, bk))


def split_rows(K: int) -> int:
    """Rows of ``split_bf16x3`` of a K-row matrix: 3 * K rounded up to SPLIT_SLAB."""
    return SPLIT_TERMS * (-(-K // SPLIT_SLAB) * SPLIT_SLAB)


def _trunc16(x: torch.Tensor) -> torch.Tensor:
    """Each float32 with its low 16 bits cleared (a truncation to bf16)."""
    return (x.view(torch.int32) & -0x10000).view(torch.float32)


def _hi16(x: torch.Tensor) -> torch.Tensor:
    """The top 16 bits of each float32, as bf16 (little-endian: the odd halves)."""
    return x.view(torch.int16).reshape(*x.shape, 2)[..., 1].contiguous().view(torch.bfloat16)


def split_bf16x3(b: torch.Tensor) -> torch.Tensor:
    """Plain version of the split kernel: a float32 (K, N) as three bf16 terms.

    By truncation: b1 = the top 16 bits of b, r1 = b - b1 (exact), b2 = the
    top 16 bits of r1, b3 = the top 16 bits of r1 - b2. For |b| >= 2^-110,
    b1 + b2 + b3 == b exactly; below, only bits under 2^-133 are dropped. An
    inf gives (inf, 0, 0) and a NaN (canonical NaN, 0, 0). Returns
    (``split_rows(K)``, N) bf16 interleaved by slabs of SPLIT_SLAB = 64 rows:
    rows [192 s, 192 s + 64) hold b1's rows [64 s, 64 s + 64), the next 64
    rows b2's, the next 64 b3's; rows past K are zero.
    """
    K, N = b.shape
    b = b.contiguous()
    finite = (b.view(torch.int32) & 0x7F800000) != 0x7F800000
    b1 = _trunc16(b)
    r1 = torch.where(finite, b - b1, torch.zeros_like(b))
    r2 = r1 - _trunc16(r1)
    nan = torch.tensor(_CANONICAL_NAN, dtype=torch.int32).view(torch.float32).to(b.device)
    b1 = torch.where(torch.isnan(b), nan, b1)
    kp = split_rows(K) // SPLIT_TERMS
    out = torch.zeros((SPLIT_TERMS, kp, N), dtype=torch.bfloat16, device=b.device)
    for t, term in enumerate((b1, r1, r2)):
        out[t, :K] = _hi16(term)
    out = out.reshape(SPLIT_TERMS, kp // SPLIT_SLAB, SPLIT_SLAB, N)
    return out.permute(1, 0, 2, 3).reshape(-1, N)
