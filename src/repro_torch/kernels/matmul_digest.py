"""CUDA kernel for the fused matmul + operand digest, and its wrapper.

Twin of ``repro.kernels.matmul_digest`` (one Pallas TPU kernel). When a
moved tensor is about to be consumed by a matmul, its digest is taken from
the tiles the product already reads, instead of by a second pass over it.
The kernel is hand-written CUDA C++ for Hopper in ``csrc/matmul_digest.cu``;
the note at its top says what bounds it and what the design does about it.
This module holds:

  * the digest's weight tables. The reference weighs each (bm, bk) tile of
    A with ``_tables16`` and carries the running digest from grid step to
    grid step. Here the weight of a byte splits into a row factor and a
    column factor (``_digest_factors``), so the card needs no ordered
    combine and its tiles need not be (bm, bk); the kernel reads the
    column factors packed lo | hi << 16 (``_packed_col_w``);
  * the wrapper ``matmul_digest``, which checks dtype, shape, contiguity,
    device and alignment, allocates C, the residues and, for a float32 B,
    its exact split into three bf16 terms (``ref.split_rows`` rows), and
    launches on the current CUDA stream: for a float32 B the split kernel,
    then the tensor-core kernel over the three terms. A CPU tensor goes to
    the plain version in ``ref.py``; a CUDA tensor goes to the kernels, or
    the wrapper raises;
  * ``split_bf16x3``, the split alone (``ref.split_bf16x3`` on the CPU), so
    it can be held bit for bit against its plain version;
  * a launch count (``launch_counts``), raised by one where ``matmul_digest``
    launches its kernels and nowhere else.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from repro_torch.core.integrity import BASES, NBASES, P
from repro_torch.kernels import _build, ref

# the tensor-core kernel (wgmma, persistent grid)
BLOCK_M = 128       # rows of a C tile
BLOCK_N = 256       # columns of a C tile
SLAB_K = 64         # K slab: one 128-byte swizzled row of A
THREADS = 384       # producer warpgroup (TMA + digest warps) + 2 consumer warpgroups
STAGES = 4          # TMA ring depth
GROUP_M = 16        # row blocks in a group of the tile order
DIGEST_THREADS = 96  # warps 1-3 of the producer warpgroup
TERMS = ref.SPLIT_TERMS  # bf16 terms of a float32 B, by slab of ref.SPLIT_SLAB = SLAB_K rows
LAYOUT = (BLOCK_M, BLOCK_N, SLAB_K, THREADS, STAGES, GROUP_M, TERMS)

_count_lock = threading.Lock()
_LAUNCHES = {"matmul_digest": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    with _count_lock:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def _pow_vec(base: int, exps: np.ndarray) -> np.ndarray:
    """base ** exps mod P elementwise (int64), by square-and-multiply."""
    e = exps.astype(np.int64)
    out = np.ones_like(e)
    sq = np.int64(base % P)
    while e.any():
        out = np.where(e & 1, out * sq % P, out)
        sq = sq * sq % P
        e = e >> 1
    return out


@functools.lru_cache(maxsize=16)
def _digest_factors(M: int, K: int, bm: int, bk: int) -> tuple[np.ndarray, np.ndarray]:
    """(row factors (NBASES, M), column factors (K, 2*NBASES)), both int32.

    The lo byte of element (row, col) sits at byte 2*e of A's blocked stream,
    e = t*bm*bk + (row % bm)*bk + col % bk with t = (row//bm)*nk + col//bk,
    so it weighs r^(2MK - 1 - 2e). That exponent is a row part minus a
    column part:  (T*tiles - 1 - T*nk*(row//bm) - 2*bk*(row % bm))
    - (T*(col//bk) + 2*(col % bk)), T = 2*bm*bk. The hi byte weighs one
    r^-1 less. Exponents are taken mod P-1 (r^(P-1) = 1).
    """
    nk = K // bk
    T = 2 * bm * bk
    tiles = (M // bm) * nk
    rows = np.arange(M, dtype=np.int64)
    cols = np.arange(K, dtype=np.int64)
    e_row = (T * tiles - 1 - T * nk * (rows // bm) - 2 * bk * (rows % bm)) % (P - 1)
    e_col = (-(T * (cols // bk)) - 2 * (cols % bk)) % (P - 1)
    row_w = np.empty((NBASES, M), np.int64)
    col_w = np.empty((K, 2 * NBASES), np.int64)
    for b, r in enumerate(BASES):
        row_w[b] = _pow_vec(r, e_row)
        col_w[:, b] = _pow_vec(r, e_col)
        col_w[:, NBASES + b] = col_w[:, b] * pow(r, P - 2, P) % P
    return row_w.astype(np.int32), col_w.astype(np.int32)


def _packed_col_w(col_w: np.ndarray) -> np.ndarray:
    """(K, NBASES) int32: per column and base, lo weight | hi weight << 16
    (each < P < 2^16), the bf16 kernel's column factors for dp2a."""
    w = col_w.astype(np.uint32)
    return (w[:, :NBASES] | w[:, NBASES:] << 16).view(np.int32)


@functools.lru_cache(maxsize=16)
def _factors_on(M: int, K: int, bm: int, bk: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row factors and packed column factors on ``device``."""
    row_w, col_w = _digest_factors(M, K, bm, bk)
    return tuple(torch.from_numpy(t).to(device) for t in (row_w, _packed_col_w(col_w)))


def wgmma_grid(M: int, N: int, sms: int) -> int:
    """Blocks of the persistent grid: min(tiles, SMs) (``wgmma_grid`` in
    ``csrc/matmul_digest.cu``), one digest partial each."""
    return min(-(-M // BLOCK_M) * -(-N // BLOCK_N), sms)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int) -> None:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"a must be bfloat16 (the transfer dtype), got {a.dtype}")
    if b.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"b must be bfloat16 or float32, got {b.dtype} "
                        "(kernels.matmul_with_digest casts other types to float32)")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be 2-D, got {tuple(a.shape)} and {tuple(b.shape)}")
    for name, v in (("bm", bm), ("bn", bn), ("bk", bk)):
        if not isinstance(v, int) or v <= 0:
            raise ValueError(f"{name} must be a positive int, got {v!r}")
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2 or M == 0 or K == 0 or N == 0:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by {tuple(b.shape)}")
    if M % bm or K % bk or N % bn:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} must be divisible "
                         f"by (bm, bk, bn) = ({bm}, {bk}, {bn})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a and b must lie on one CPU or CUDA device, got {a.device}, {b.device}")


_layout_checked = False


def _library():
    """The built kernel library, its tiling checked against ``LAYOUT`` once."""
    global _layout_checked
    lib = _build.load()
    if not _layout_checked:
        got = _build.mm_layout(lib)
        if got != LAYOUT:
            raise RuntimeError(f"kernel library layout {got} != wrapper layout {LAYOUT}")
        _layout_checked = True
    return lib


def _check_card_shape(K: int, N: int, *tensors: torch.Tensor) -> None:
    if K % 8 or N % 8:
        raise ValueError(f"the CUDA kernel needs K % 8 == 0 and N % 8 == 0 (rows of whole "
                         f"16-byte vectors), got K={K}, N={N}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel needs 16-byte aligned tensors")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ck_error_string(rc).decode()} ({rc})")


def _launch(a: torch.Tensor, b: torch.Tensor, bm: int, bk: int) -> tuple[torch.Tensor, torch.Tensor]:
    (M, K), N = a.shape, int(b.shape[1])
    _check_card_shape(K, N, a, b)
    lib = _library()
    device = a.device
    row_w, col_w16 = _factors_on(M, K, bm, bk, device)
    b_f32 = b.dtype == torch.float32
    sms = sm_count(device)
    # an f32 B's three bf16 terms, written by the split kernel, read by the product
    b3 = (torch.empty((ref.split_rows(K), N), dtype=torch.bfloat16, device=device)
          if b_f32 else None)
    c = torch.empty((M, N), dtype=torch.float32, device=device)
    partial = torch.empty((wgmma_grid(M, N, sms), NBASES), dtype=torch.int32, device=device)
    out = torch.empty(NBASES, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mm_digest(device.index, a.data_ptr(), b.data_ptr(), int(b_f32),
                           None if b3 is None else b3.data_ptr(), c.data_ptr(), M, N, K,
                           row_w.data_ptr(), col_w16.data_ptr(), partial.data_ptr(),
                           out.data_ptr(), sms, stream)
    _raise_on(lib, rc, "matmul_digest kernel")
    with _count_lock:
        _LAUNCHES["matmul_digest"] += 1
    return c, out


def split_bf16x3(b: torch.Tensor) -> torch.Tensor:
    """The exact split of a float32 B (K, N) into three bf16 terms,
    (``ref.split_rows(K)``, N) bf16 interleaved by slab (``ref.split_bf16x3``
    says how). ``matmul_digest`` runs the same kernel on a float32 B; this
    call alone exists to hold it against its plain version and to time it,
    and counts no launch. A CPU tensor goes to the plain version."""
    if not isinstance(b, torch.Tensor) or b.dtype != torch.float32 or b.dim() != 2:
        raise TypeError("b must be a 2-D float32 torch.Tensor")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    if b.device.type == "cpu":
        return ref.split_bf16x3(b)
    K, N = b.shape
    _check_card_shape(K, N, b)
    lib = _library()
    b3 = torch.empty((ref.split_rows(K), N), dtype=torch.bfloat16, device=b.device)
    with torch.cuda.device(b.device):
        rc = lib.mm_split(b.device.index, b.data_ptr(), b3.data_ptr(), K, N, sm_count(b.device),
                          torch.cuda.current_stream(b.device).cuda_stream)
    _raise_on(lib, rc, "split_bf16x3 kernel")
    return b3


def matmul_digest(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
                  bk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """C = A @ B (f32 accumulate) plus digest residues of A's blocked bytes.

    A is (M, K) bfloat16 and B (K, N) bfloat16 or float32, with M % bm,
    K % bk and N % bn all 0. Returns (C float32 (M, N), residues (NBASES,)
    int32). (bm, bk) define the digest's blocked byte order
    (``ref.blocked_view``); bn is checked as the reference checks it. On the
    card K and N must also be multiples of 8, and a float32 B goes through
    the tensor cores as its three bf16 terms (``split_bf16x3``): exact for
    every |b| >= 2^-110, below that only bits under 2^-133 are dropped.
    """
    _check(a, b, bm, bn, bk)
    if a.device.type == "cpu":
        return ref.matmul_digest_ref(a, b, bm, bk)
    return _launch(a, b, bm, bk)
