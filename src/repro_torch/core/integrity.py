"""Mergeable integrity fingerprints — the exact host oracle of the port.

This module is the port's own copy of ``repro.core.integrity``; the two must
agree bit for bit (the tests hold them to it), because digests and journals
cross between the packages.

The paper (§3.2) overlaps per-chunk MD5 checksums with data movement. MD5 is a
strictly sequential 64-byte block chain: the worst possible fit for wide
vector units. What the Globus protocol actually *needs* from the
checksum is

  (1) corruption detection for random bit/byte flips, and
  (2) per-chunk digests that *merge* into a whole-file verdict
      (the ERET/ESTO partial-transfer checksums of §3.2).

We therefore use a degree-weighted polynomial fingerprint over the prime field
GF(p), p = 46337 (the largest prime with (p-1)^2 < 2^31, so every product of
two residues fits in signed int32 — native 32-bit lane arithmetic). Four independent
evaluation points r_1..r_4 give a 4x~15.5 = 62-bit digest, stronger than the
32-bit checksum value Globus transmits (paper §3.2).

Definition, over the byte stream b_0..b_{n-1} (each byte is one coefficient):

    H_r(b) = sum_k b_k * r^(n-1-k)  mod p          (degree-descending)

which satisfies the *merge law* used throughout this framework:

    H_r(A || B) = H_r(A) * r^len(B) + H_r(B)   (mod p)

so chunk digests computed independently — in any order, by any mover — combine
associatively into the stream digest. Out-of-order completion (movers finish
chunks at different times; paper §3.1) is supported by `combine_at_offset`,
because chunk C at byte offset o of an n-byte file contributes exactly
H_r(C) * r^(n - o - len(C)) to the file digest, a commutative sum.

Detection strength: two distinct equal-length streams collide at evaluation
point r iff r is a root of their (degree < n) difference polynomial; for the
four fixed points the miss probability for a random corruption is ~(1/p)^4
~= 2.2e-19 per point-set, far below the one-error-per-1.26 TB corruption rate
observed in the Globus logs (paper §2.3). Unequal lengths never collide: the
digest carries the exact byte length.

Three implementations, one algebra:
  * this module      — exact host/numpy version over raw bytes (checkpoint path)
  * kernels/ref.py   — plain PyTorch versions over int32-packed words
  * kernels/checksum — hand-written CUDA kernels for Hopper (csrc/checksum.cu),
                       held against ref.py on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Iterable, Sequence

import numpy as np

P = 46337                        # largest prime with (p-1)^2 < 2^31
BASES = (10007, 20011, 31337, 40009)   # four fixed evaluation points
NBASES = len(BASES)
_BLOCK = 1 << 16                 # host-side processing block (bytes)

# Bigint-pow accounting: `Digest.merge`/`shifted`/`combine_at_offsets` run
# O(chunks x hops) in fabric relays and service digest chains, and every one
# of them needs r^len for the four bases. The LRU below makes repeated
# same-length merges hit a table instead of calling CPython's bigint pow();
# the counter exists so benchmarks/overlap.py can *gate* that (pow calls per
# merge chain must stay >= 5x below the uncached 4-per-merge cost).
_POW_STATS = {"bigint_pow_calls": 0}


@functools.lru_cache(maxsize=1 << 16)
def _pow_mod_cached(base: int, exp: int, mod: int) -> int:
    _POW_STATS["bigint_pow_calls"] += 1
    return pow(base, exp, mod)


def _pow_mod(base: int, exp: int, mod: int = P) -> int:
    return _pow_mod_cached(int(base), int(exp), mod)


@functools.lru_cache(maxsize=1 << 14)
def _shift_vector(exp: int) -> tuple[int, ...]:
    """(r^exp mod P for r in BASES) — the per-merge weight vector, cached so
    a chain of equal-length merges costs four pow() calls total, not 4/merge."""
    return tuple(_pow_mod_cached(r, int(exp), P) for r in BASES)


def pow_call_count() -> int:
    """Cumulative bigint pow() invocations (cache misses) this process."""
    return _POW_STATS["bigint_pow_calls"]


def clear_pow_caches() -> None:
    """Drop the pow/shift LRUs (microbenchmarks measure from a cold start)."""
    _pow_mod_cached.cache_clear()
    _shift_vector.cache_clear()


@dataclasses.dataclass(frozen=True)
class Digest:
    """A mergeable fingerprint: four GF(p) residues plus the exact byte length."""

    h: tuple[int, int, int, int]
    length: int

    def __post_init__(self):
        if len(self.h) != NBASES:
            raise ValueError(f"digest must carry {NBASES} residues, got {len(self.h)}")
        if any(not (0 <= v < P) for v in self.h):
            raise ValueError(f"residues out of field range: {self.h}")
        if self.length < 0:
            raise ValueError("negative length")

    # -- algebra ------------------------------------------------------------
    def merge(self, right: "Digest") -> "Digest":
        """Digest of the concatenation self || right."""
        sv = _shift_vector(right.length)
        h = tuple(
            (hl * s + hr) % P for hl, hr, s in zip(self.h, right.h, sv)
        )
        return Digest(h, self.length + right.length)

    def shifted(self, tail_bytes: int) -> tuple[int, ...]:
        """Contribution of this chunk when `tail_bytes` bytes follow it."""
        sv = _shift_vector(tail_bytes)
        return tuple((hv * s) % P for hv, s in zip(self.h, sv))

    def to_bytes(self) -> bytes:
        out = bytearray()
        for v in self.h:
            out += int(v).to_bytes(4, "little")
        out += int(self.length).to_bytes(8, "little")
        return bytes(out)

    @staticmethod
    def from_bytes(raw: bytes) -> "Digest":
        if len(raw) != 4 * NBASES + 8:
            raise ValueError(f"bad digest encoding length {len(raw)}")
        h = tuple(int.from_bytes(raw[4 * i : 4 * i + 4], "little") for i in range(NBASES))
        length = int.from_bytes(raw[4 * NBASES :], "little")
        return Digest(h, length)

    def hexdigest(self) -> str:
        return self.to_bytes().hex()


EMPTY_DIGEST = Digest((0, 0, 0, 0), 0)


def fingerprint_bytes(
    data: bytes | bytearray | memoryview | np.ndarray,
    *,
    state: "Digest | None" = None,
) -> Digest:
    """Exact digest of a raw byte stream (vectorized numpy host path).

    This is the checkpoint-path implementation: it must digest arbitrary-length
    byte strings at (multi-)100 MB/s so that per-chunk checksumming can overlap
    chunk I/O (paper Fig. 4) without itself becoming the bottleneck.

    ``state`` is a running digest of everything streamed so far: passing it
    returns ``state || data`` by the merge law, which is the single-pass data
    plane's primitive — the source fingerprint accumulates granule-by-granule
    *while* the chunk streams into the destination, instead of in a second
    full pass over the chunk (``core.dataplane.stream_chunk``).
    """
    if state is not None:
        return state.merge(fingerprint_bytes(data))
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    if buf.dtype != np.uint8:
        buf = buf.view(np.uint8)
    buf = buf.reshape(-1)
    n = buf.size
    h = np.zeros(NBASES, dtype=np.int64)
    if n == 0:
        return EMPTY_DIGEST
    # Weight tables as float64: every product (<= 255 * 46336) and every
    # 64 KiB block sum (<= 7.7e11) is exactly representable in f64 (< 2^53),
    # so we get BLAS-speed GEMMs with exact integer results.
    weights = _host_weight_table_f64(_BLOCK)                 # (NBASES, _BLOCK)
    full, rem = divmod(n, _BLOCK)
    SUPER = 128  # blocks per GEMM: 8 MiB of input per call
    # per-thread reusable conversion buffer: a fresh np.empty here would cost
    # a 64 MB mmap + page-fault storm PER CALL, halving the digest rate in
    # the small-chunk regime the data plane streams through
    conv = _conv_buffer(min(SUPER, full) or 1)
    for s in range(0, full, SUPER):
        e = min(s + SUPER, full)
        m = e - s
        x = conv[:m]
        np.copyto(x, buf[s * _BLOCK : e * _BLOCK].reshape(m, _BLOCK))
        blks = (x @ weights.T).astype(np.int64) % P  # (m, NBASES)
        # fold the m block digests in ONE reduction instead of a python
        # recurrence: H = sum_j blks[j] * r^(B*(m-1-j)), terms < P^2 * m
        # stay exact in int64 for m <= 128
        h_super = (blks * _block_fold_powers(m)).sum(axis=0) % P
        h = (h * np.asarray(_shift_vector(m * _BLOCK), dtype=np.int64)
             + h_super) % P
    if rem:
        tail = buf[full * _BLOCK :].astype(np.float64)
        # weights[:, B-rem:] = [r^(rem-1) ... r^0] — descending weights for `rem` coeffs.
        blk = (weights[:, _BLOCK - rem :] @ tail).astype(np.int64) % P
        h = (h * np.asarray(_shift_vector(rem), dtype=np.int64) + blk) % P
    return Digest(tuple(int(v) for v in h), n)


@functools.lru_cache(maxsize=256)
def _block_fold_powers(m: int) -> np.ndarray:
    """(m, NBASES) table: [r^(_BLOCK*(m-1-j))]_j — the block-fold weights."""
    out = np.empty((m, NBASES), dtype=np.int64)
    for j in range(m):
        out[j] = _shift_vector((m - 1 - j) * _BLOCK)
    return out


_WEIGHT_CACHE: dict[int, np.ndarray] = {}
_WEIGHT_CACHE_F64: dict[int, np.ndarray] = {}
_TLS = threading.local()


def _conv_buffer(blocks: int) -> np.ndarray:
    """Thread-local (blocks, _BLOCK) float64 conversion scratch, grown on
    demand and reused across calls (page faults paid once per thread)."""
    buf = getattr(_TLS, "conv", None)
    if buf is None or buf.shape[0] < blocks:
        buf = np.empty((blocks, _BLOCK), dtype=np.float64)
        _TLS.conv = buf
    return buf


def _host_weight_table_f64(block: int) -> np.ndarray:
    """float64 view of the weight table, cached (the GEMM operand)."""
    tbl = _WEIGHT_CACHE_F64.get(block)
    if tbl is None:
        tbl = _host_weight_table(block).astype(np.float64)
        _WEIGHT_CACHE_F64[block] = tbl
    return tbl


def _host_weight_table(block: int) -> np.ndarray:
    """weights[b, k] = BASES[b] ^ (block-1-k) mod P, shape (NBASES, block)."""
    tbl = _WEIGHT_CACHE.get(block)
    if tbl is None:
        tbl = np.empty((NBASES, block), dtype=np.int64)
        for b, r in enumerate(BASES):
            w = np.empty(block, dtype=np.int64)
            acc = 1
            for k in range(block - 1, -1, -1):
                w[k] = acc
                acc = (acc * r) % P
            tbl[b] = w
        _WEIGHT_CACHE[block] = tbl
    return tbl


class RunningFingerprint:
    """Incremental fingerprint accumulator (the merge law as a stream API).

    ``update()`` folds the next granule into the running digest while the
    granule is still cache-hot from the copy that produced it — this is how
    the zero-copy data plane computes the source digest during streaming
    instead of in a separate full pass. Merge cost is four table lookups per
    granule (the ``_shift_vector`` LRU), so granule size can be small.
    """

    __slots__ = ("_digest",)

    def __init__(self, start: Digest = EMPTY_DIGEST):
        self._digest = start

    def update(self, data: bytes | bytearray | memoryview | np.ndarray) -> None:
        self._digest = self._digest.merge(fingerprint_bytes(data))

    @property
    def length(self) -> int:
        return self._digest.length

    def digest(self) -> Digest:
        return self._digest


# rows per conversion slab: the f64 slab (rows x 512 KiB) must stay
# cache-resident — at 128 rows the 64 MiB working set spills to DRAM and the
# "fused" path measures slower than per-chunk; 16 rows (8 MiB) is the sweet
# spot measured across the 64 KiB..1 MiB granule range
_ROW_SLAB = 16


def _wT_f64() -> np.ndarray:
    """Contiguous (_BLOCK, NBASES) GEMM operand — ``weights.T`` as a view is
    non-contiguous, and BLAS re-copies the 2 MiB table on EVERY call; cached
    contiguous it is read once per slab and stays in LLC across the batch."""
    tbl = _WEIGHT_CACHE_F64.get(-_BLOCK)
    if tbl is None:
        tbl = np.ascontiguousarray(_host_weight_table_f64(_BLOCK).T)
        _WEIGHT_CACHE_F64[-_BLOCK] = tbl
    return tbl


@functools.lru_cache(maxsize=64)
def _tail_weight_f64(rem: int) -> np.ndarray:
    """Contiguous (rem, NBASES) tail-weight operand for partial blocks."""
    return np.ascontiguousarray(_host_weight_table_f64(_BLOCK)[:, _BLOCK - rem :].T)


def fingerprint_rows(rows: Sequence[np.ndarray]) -> list[Digest]:
    """Digests of k equal-length uint8 rows — one fused GEMM per block column.

    This is the batched-dispatch primitive under ``fingerprint_many`` and the
    ``IntegrityEngine`` fused drain. The old implementation stacked the rows
    into one matrix and ran a full-width ``astype(np.float64)``: two fresh
    multi-MB allocations per call, which page-fault so hard the "fused" path
    measured *slower* than per-chunk calls. Here every 64 KiB block column is
    converted row-by-row straight into the same thread-local float64 scratch
    ``fingerprint_bytes`` reuses, so the only large memory traffic is the one
    unavoidable uint8→f64 spread, and the GEMM amortizes across all k rows.

    Rows may be arbitrary 1-D uint8 views (rows of a staging buffer, pooled
    granules) — no copy-stacking. Raises ``ValueError`` naming the offending
    row on ragged input; callers that may be ragged use ``fingerprint_many``.
    """
    k = len(rows)
    if k == 0:
        return []
    n = int(rows[0].size)
    for j, r in enumerate(rows):
        if int(r.size) != n:
            raise ValueError(
                f"fingerprint_rows requires equal lengths: row {j} has "
                f"{int(r.size)} bytes, row 0 has {n}"
            )
    if n == 0:
        return [EMPTY_DIGEST] * k
    wT = _wT_f64()                                           # (_BLOCK, NBASES)
    full, rem = divmod(n, _BLOCK)
    h = np.zeros((k, NBASES), dtype=np.int64)
    r_blk = np.asarray(_shift_vector(_BLOCK), dtype=np.int64)
    for s0 in range(0, k, _ROW_SLAB):
        s1 = min(s0 + _ROW_SLAB, k)
        m = s1 - s0
        conv = _conv_buffer(m)
        for s in range(full):
            lo = s * _BLOCK
            x = conv[:m]
            for j in range(m):
                np.copyto(x[j], rows[s0 + j][lo : lo + _BLOCK])
            blks = (x @ wT).astype(np.int64) % P             # (m, NBASES)
            h[s0:s1] = (h[s0:s1] * r_blk[None, :] + blks) % P
        if rem:
            lo = full * _BLOCK
            if full == 0:
                # sub-block rows: pack contiguously into the flat scratch —
                # conv[:m, :rem] has strided rows, which forces BLAS to
                # re-copy the whole operand on every GEMM call
                x = conv.reshape(-1)[: m * rem].reshape(m, rem)
            else:
                x = conv[:m, :rem]
            for j in range(m):
                np.copyto(x[j], rows[s0 + j][lo:])
            r_tail = np.asarray(_shift_vector(rem), dtype=np.int64)
            blk = (x @ _tail_weight_f64(rem)).astype(np.int64) % P
            h[s0:s1] = (h[s0:s1] * r_tail[None, :] + blk) % P
    return [Digest(tuple(int(v) for v in h[i]), n) for i in range(k)]


def fingerprint_many(
    chunks: Sequence[bytes | bytearray | memoryview | np.ndarray],
    *,
    expect_equal: bool = False,
) -> list[Digest]:
    """Digests of many chunks in one numpy dispatch per equal-length group.

    ``fingerprint_bytes`` pays fixed numpy dispatch + conversion overhead per
    call, which dominates in the small-chunk regime (fabric relay granules,
    engine drain batches, re-planned tails at the tuner's floor). Lengths are
    validated up front: equal-length groups of two or more go through the
    fused ``fingerprint_rows`` GEMM stack, while ragged leftovers fall back
    to per-item ``fingerprint_bytes`` — so mixed-length input degrades
    gracefully instead of raising deep inside the GEMM stacking. Equal
    results to the per-chunk path, bit for bit.

    ``expect_equal=True`` makes ragged input an error, reported in the
    ``describe_mismatch`` style (which items, which lengths) — for callers
    like the relay's read-back comparison where a length spread is itself
    the fault being detected (a short read-back), not a batching choice.
    """
    bufs: list[np.ndarray] = []
    for data in chunks:
        b = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
        if b.dtype != np.uint8:
            b = b.view(np.uint8)
        bufs.append(b.reshape(-1))
    groups: dict[int, list[int]] = {}
    for i, b in enumerate(bufs):
        groups.setdefault(int(b.size), []).append(i)
    if expect_equal and len(groups) > 1:
        sizes = sorted(groups)
        raise ValueError(
            "length mismatch across batch: "
            + ", ".join(f"items {groups[n]} have {n} bytes" for n in sizes)
            + " — short read/over read upstream of the digest"
        )
    out: list[Digest | None] = [None] * len(bufs)
    for n, idxs in groups.items():
        if n == 0:
            for i in idxs:
                out[i] = EMPTY_DIGEST
        elif len(idxs) == 1:
            # singleton group: the fused path has nothing to amortize over
            out[idxs[0]] = fingerprint_bytes(bufs[idxs[0]])
        else:
            digs = fingerprint_rows([bufs[i] for i in idxs])
            for row, i in enumerate(idxs):
                out[i] = digs[row]
    return out                                            # type: ignore[return-value]


def fingerprint_ndarray(arr: np.ndarray) -> Digest:
    """Digest of an ndarray's in-memory byte image (C-order)."""
    return fingerprint_bytes(np.ascontiguousarray(arr).view(np.uint8))


def merge_all(digests: Iterable[Digest]) -> Digest:
    """Fold an in-order sequence of chunk digests into the stream digest."""
    out = EMPTY_DIGEST
    for d in digests:
        out = out.merge(d)
    return out


def combine_at_offsets(
    parts: Sequence[tuple[int, Digest]], total_length: int
) -> Digest:
    """Commutative combination of (byte_offset, digest) chunk parts.

    Chunks may be supplied in ANY order (movers complete out of order,
    paper §3.1); offsets must tile [0, total_length) exactly.
    """
    cover = sorted((off, d.length) for off, d in parts)
    pos = 0
    for off, ln in cover:
        if off != pos:
            raise ValueError(f"chunk coverage gap/overlap at byte {pos} (next chunk at {off})")
        pos += ln
    if pos != total_length:
        raise ValueError(f"chunks cover {pos} bytes, expected {total_length}")
    acc = [0] * NBASES
    for off, d in parts:
        tail = total_length - off - d.length
        contrib = d.shifted(tail)
        for b in range(NBASES):
            acc[b] = (acc[b] + contrib[b]) % P
    return Digest(tuple(acc), total_length)


def verify(expected: Digest, actual: Digest) -> bool:
    return expected.h == actual.h and expected.length == actual.length


def describe_mismatch(expected: Digest, actual: Digest) -> str:
    """Human-readable diagnosis of a failed ``verify`` (for fault reports).

    Distinguishes a length mismatch (short/over read — an I/O fault) from a
    residue mismatch (content corruption) and names the evaluation points
    that disagree: a single disagreeing base on equal lengths is the
    signature of in-flight bit corruption rather than a framing error.
    """
    if expected.length != actual.length:
        return f"length mismatch ({expected.length} vs {actual.length} bytes)"
    bad = [i for i in range(NBASES) if expected.h[i] != actual.h[i]]
    if not bad:
        return "digests match"
    return (
        f"content corruption: {len(bad)}/{NBASES} residues disagree "
        f"(bases {tuple(BASES[i] for i in bad)})"
    )
