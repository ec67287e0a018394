"""CUDA kernels for the mergeable integrity digest, and their wrappers.

Twin of ``repro.kernels.checksum`` (three Pallas TPU kernels). The kernels
themselves are hand-written CUDA C++ for Hopper in ``csrc/checksum.cu`` —
see the note at its top for what bounds them on the card and what the
design does about it. This module holds:

  * the tiling constants and the weight tables: ``_tables`` is a copy of the
    reference's (W0 = r^(T-1-4m), r^-k, r^T) and feeds the plain versions;
    ``_kernel_factors`` refactors the same weights for the CUDA tile kernel
    (a per-thread weight G times a per-byte factor F), and ``_tile_powers``
    holds the positional weights r^(T*(tiles-1-i)) of the cross-tile
    combine, cached by tile count. Device copies are built once and kept;
  * the wrappers ``checksum_words``, ``checksum_many_words`` and
    ``checksum_copy_words``. Each checks dtype, shape, contiguity and device,
    allocates its outputs, and launches on the current CUDA stream. A CPU
    tensor goes to the plain version in ``ref.py``; a CUDA tensor goes to the
    kernel, or the wrapper raises — there is no fallback;
  * a launch count per wrapper (``launch_counts``), raised by one exactly
    where the kernel is launched, so a run can show its path went through
    the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from repro_torch.core.integrity import BASES, NBASES, P
from repro_torch.kernels import _build, ref

ROWS = 64           # words per tile row-block: tile = ROWS*128 words = 32 KiB
LANES = 128
TILE_WORDS = ROWS * LANES
TILE_BYTES = 4 * TILE_WORDS
THREADS = 256       # CUDA block of the tile kernel: 16 bytes a thread a step
_ITERS = TILE_WORDS // (4 * THREADS)

_count_lock = threading.Lock()
_LAUNCHES = {"checksum_words": 0, "checksum_many_words": 0, "checksum_copy_words": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    with _count_lock:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def _pow_mod(base: int, exp: int) -> int:
    return pow(int(base), int(exp), P)


@functools.lru_cache(maxsize=None)
def _tables(rows: int = ROWS) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(W0, rinv, rpow): word weights r^(T-1-4m), byte-plane r^-k, tile r^T."""
    tile_words = rows * LANES
    tile_bytes = 4 * tile_words
    w0 = np.empty((NBASES, rows, LANES), np.int32)
    rinv = np.empty((NBASES, 4), np.int32)
    rpow = np.empty((NBASES, 1), np.int32)
    for b, r in enumerate(BASES):
        r4 = _pow_mod(r, 4)
        r4inv = _pow_mod(r4, P - 2)
        acc = _pow_mod(r, tile_bytes - 1)          # weight of word m=0
        flat = np.empty(tile_words, np.int64)
        for m in range(tile_words):
            flat[m] = acc
            acc = (acc * r4inv) % P
        w0[b] = flat.reshape(rows, LANES)
        rinvk = _pow_mod(r, P - 2)
        rinv[b] = [1, rinvk, (rinvk * rinvk) % P, (rinvk * rinvk % P) * rinvk % P]
        rpow[b, 0] = _pow_mod(r, tile_bytes)
    return w0, rinv, rpow


@functools.lru_cache(maxsize=None)
def tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_tables()`` as int32 tensors on ``device`` (built once per device)."""
    return tuple(torch.from_numpy(t).to(device) for t in _tables(ROWS))


@functools.lru_cache(maxsize=None)
def _kernel_factors() -> tuple[np.ndarray, np.ndarray]:
    """The CUDA tile kernel's weights (G, F), both int32.

    Thread t reads 16-byte vectors at tile words 4t + 4*THREADS*i, so its
    byte p of step i sits at tile byte 16t + 16*THREADS*i + p and weighs
    r^(T-1-16t) * r^-(16*THREADS*i + p). G[b, t] = r^(T-1-16t) is W0's entry
    for word 4t; F[b, 16*i + p] = r^-(16*THREADS*i + p).
    """
    w0, _, _ = _tables(ROWS)
    g = np.ascontiguousarray(w0.reshape(NBASES, -1)[:, 0 : 4 * THREADS : 4])
    f = np.empty((NBASES, 16 * _ITERS), np.int32)
    for b, r in enumerate(BASES):
        rinv = _pow_mod(r, P - 2)
        for i in range(_ITERS):
            for p in range(16):
                f[b, 16 * i + p] = _pow_mod(rinv, 16 * THREADS * i + p)
    return g, f


@functools.lru_cache(maxsize=None)
def _kernel_g(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_kernel_factors()[0]).to(device)


@functools.lru_cache(maxsize=64)
def _tile_powers_host(tiles: int) -> np.ndarray:
    """(tiles, NBASES) int32: r^(T*(tiles-1-i)), the weight of tile i."""
    step = [_pow_mod(r, TILE_BYTES) for r in BASES]
    out = np.empty((tiles, NBASES), np.int64)
    acc = [1] * NBASES
    for i in range(tiles - 1, -1, -1):
        out[i] = acc
        acc = [a * s % P for a, s in zip(acc, step)]
    return out.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _tile_powers(tiles: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_tile_powers_host(tiles)).to(device)


def _check(words: torch.Tensor, ndim: int) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(words).__name__}")
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {words.dtype}")
    if words.dim() != ndim:
        raise ValueError(f"words must be {ndim}-D, got shape {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    n = int(words.shape[-1])
    if n == 0 or n % TILE_WORDS or (ndim == 2 and int(words.shape[0]) == 0):
        raise ValueError(
            f"each stream must be a positive multiple of {TILE_WORDS} words, "
            f"got shape {tuple(words.shape)}")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")


_layout_checked = False


def _launch(name: str, words2d: torch.Tensor, copy: torch.Tensor | None) -> torch.Tensor:
    """Run the CUDA tile + combine kernels over (k, n) words; (k, NBASES) out."""
    global _layout_checked
    if words2d.data_ptr() % 16 or (copy is not None and copy.data_ptr() % 16):
        raise ValueError("CUDA digest kernels need 16-byte aligned tensors")
    lib = _build.load()
    if not _layout_checked:
        got = _build.layout(lib)
        want = (TILE_WORDS, THREADS, 16 * _ITERS)
        if got != want:
            raise RuntimeError(f"kernel library layout {got} != wrapper layout {want}")
        _layout_checked = True
    device = words2d.device
    k, n = (int(s) for s in words2d.shape)
    tiles = n // TILE_WORDS
    g = _kernel_g(device)
    factors = _kernel_factors()[1]
    powers = _tile_powers(tiles, device)
    tile_hash = torch.empty((k, tiles, NBASES), dtype=torch.int32, device=device)
    out = torch.empty((k, NBASES), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ck_checksum(
            device.index, words2d.data_ptr(), k, tiles, g.data_ptr(),
            factors.ctypes.data_as(ctypes.c_void_p), powers.data_ptr(),
            tile_hash.data_ptr(), out.data_ptr(),
            None if copy is None else copy.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.ck_error_string(rc).decode()} ({rc})")
    with _count_lock:
        _LAUNCHES[name] += 1
    return out


def checksum_words(words: torch.Tensor) -> torch.Tensor:
    """Digest residues (NBASES,) int32 of a 1-D int32 word stream.

    ``words`` must hold a positive multiple of ``TILE_WORDS`` words (the
    ``ops`` wrappers pad and divide the padding back out).
    """
    _check(words, 1)
    if words.device.type == "cpu":
        return ref.checksum_words_ref(words, *tables(words.device))
    return _launch("checksum_words", words.view(1, -1), None)[0]


def checksum_many_words(words2d: torch.Tensor) -> torch.Tensor:
    """Digests (k, NBASES) int32 of k equal-length int32 streams, one launch.

    ``words2d`` is (k, n) with n a positive multiple of ``TILE_WORDS``: the
    integrity engine's fused drain digests a whole batch of landed chunks
    (and their deferred source fingerprints) this way.
    """
    _check(words2d, 2)
    if words2d.device.type == "cpu":
        return ref.checksum_many_words_ref(words2d, *tables(words2d.device))
    return _launch("checksum_many_words", words2d, None)


def checksum_copy_words(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Copy a 1-D int32 word stream while digesting it, from one load.

    Returns (residues (NBASES,) int32, copy). The paper's "checksum while
    first reading": the chunk lands in its new buffer and its digest comes
    from the same registers, with no second read.
    """
    _check(words, 1)
    if words.device.type == "cpu":
        return ref.checksum_copy_words_ref(words, *tables(words.device))
    copy = torch.empty_like(words)
    res = _launch("checksum_copy_words", words.view(1, -1), copy)[0]
    return res, copy
