"""Zero-copy pipelined data plane — buffers, streaming, and the integrity engine.

The paper's central overlap claim (§3.2, Fig. 4) is that per-chunk integrity
checking must run *concurrently* with data movement, not serialized behind
it. This module is the host-side machinery that makes that true:

  * **BufferPool / ChunkBuffer** — reusable chunk-sized buffers handed out as
    exact-length ``memoryview`` handles, so source read, fingerprint, and
    destination write all touch ONE allocation with zero intermediate
    ``bytes()`` copies. Buffers cycle back to the pool the moment the write
    lands; verification reads back into a *different* pooled buffer, so a
    chunk never pins two buffers at once.
  * **read_into / read_back_into** — zero-copy endpoint adapters: they use an
    endpoint's native ``read_into``/``read_back_into`` (``os.preadv`` on
    files, slice assignment on memory) when present and fall back to the
    classic ``read()``/``read_back()`` + copy otherwise, so chaos wrappers
    and third-party endpoints keep working unchanged.
  * **stream_chunk** — the single-pass move: the chunk streams source->dest
    in ``granule``-byte sub-reads and the source fingerprint accumulates via
    the merge law *while each granule is cache-hot*, eliminating the separate
    full digest pass the serial engine pays.
  * **IntegrityEngine** — the decoupled checksum worker pool. Movers enqueue
    a ``VerifyJob`` (coordinates + expected digest) the moment a chunk's
    write lands and immediately pull the next chunk; integrity workers drain
    the digest queue concurrently — read-back, fingerprint, verdict — and
    fire the caller's callbacks. The custody rule lives in the callbacks: a
    chunk's journal record commits only in ``on_verified``, so a crash with
    verification lagging N chunks behind movement re-moves exactly those N
    unverified chunks and nothing else.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.integrity import (
    Digest,
    RunningFingerprint,
    fingerprint_bytes,
    fingerprint_many,
    verify,
)
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import NULL as _NULL_TRACER

MiB = 1024 * 1024
DEFAULT_STREAM_GRANULE = 1 * MiB


# ---------------------------------------------------------------------------
# buffer pool
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PoolStats:
    """Reuse accounting (surfaced by benchmarks/overlap.py)."""

    acquires: int = 0
    reuses: int = 0            # served from the free list (no allocation)
    allocations: int = 0       # fresh pooled buffers created
    oversize: int = 0          # requests larger than the pool's buffer size


class ChunkBuffer:
    """One pooled buffer lease: an exact-length writable ``memoryview``.

    ``view`` is the only handle movers/verifiers should touch; ``release()``
    returns the backing buffer to the pool (idempotent — double release is a
    no-op, and the view must not be used afterwards).
    """

    __slots__ = ("view", "_pool", "_raw")

    def __init__(self, pool: "BufferPool | None", raw: bytearray, length: int):
        self._pool = pool
        self._raw = raw
        self.view = memoryview(raw)[:length]

    def release(self) -> None:
        raw, self._raw = self._raw, None
        if raw is None:
            return
        self.view.release()
        self.view = None  # type: ignore[assignment]
        if self._pool is not None:
            self._pool._put_back(raw)

    def __enter__(self) -> "ChunkBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class BufferPool:
    """Thread-safe pool of ``buffer_bytes``-sized reusable buffers.

    ``capacity`` bounds how many idle buffers are retained; extra releases
    drop their buffer (GC'd) so a transient burst cannot pin memory forever.
    Requests larger than ``buffer_bytes`` (re-planned jumbo tails) get an
    exact-size one-shot allocation that is never pooled.
    """

    def __init__(self, buffer_bytes: int, *, capacity: int = 8):
        if buffer_bytes < 1:
            raise ValueError("buffer_bytes must be >= 1")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.buffer_bytes = int(buffer_bytes)
        self.capacity = int(capacity)
        self._free: list[bytearray] = []
        self._lock = threading.Lock()
        self.stats = PoolStats()

    def acquire(self, length: int) -> ChunkBuffer:
        if length < 0:
            # a negative length would silently lease a truncated python-slice
            # view — surface the caller bug instead of corrupting a landing
            raise ValueError(f"acquire length must be >= 0, got {length}")
        if length > self.buffer_bytes:
            with self._lock:
                self.stats.acquires += 1
                self.stats.oversize += 1
            return ChunkBuffer(None, bytearray(length), length)
        with self._lock:
            self.stats.acquires += 1
            if self._free:
                self.stats.reuses += 1
                raw = self._free.pop()
            else:
                self.stats.allocations += 1
                raw = bytearray(self.buffer_bytes)
        return ChunkBuffer(self, raw, length)

    def _put_back(self, raw: bytearray) -> None:
        with self._lock:
            if len(self._free) < self.capacity:
                self._free.append(raw)


# ---------------------------------------------------------------------------
# zero-copy endpoint adapters
# ---------------------------------------------------------------------------
def read_into(source: Any, offset: int, view: memoryview) -> None:
    """Read ``len(view)`` bytes at ``offset`` from ``source`` into ``view``.

    Zero-copy when the source implements ``read_into``; otherwise falls back
    to ``read()`` + one copy (chaos wrappers, legacy endpoints). Short reads
    raise ``IOError`` either way, matching the engine's retry taxonomy.
    """
    n = len(view)
    fn = getattr(source, "read_into", None)
    if fn is not None:
        got = fn(offset, view)
        if got != n:
            raise IOError(f"short read at {offset}: {got}/{n}")
        return
    data = source.read(offset, n)
    if len(data) != n:
        raise IOError(f"short read at {offset}: {len(data)}/{n}")
    view[:] = data


def read_back_into(dest: Any, offset: int, view: memoryview) -> None:
    """Verification read: like ``read_into`` but against a destination."""
    n = len(view)
    fn = getattr(dest, "read_back_into", None)
    if fn is not None:
        got = fn(offset, view)
        if got != n:
            raise IOError(f"short read-back at {offset}: {got}/{n}")
        return
    data = dest.read_back(offset, n)
    if len(data) != n:
        raise IOError(f"short read-back at {offset}: {len(data)}/{n}")
    view[:] = data


def read_into_vec(source: Any, offset: int, views: list[memoryview]) -> None:
    """Vectored read: fill consecutive ``views`` starting at ``offset``.

    One ``os.preadv``-style syscall when the source implements ``readv_into``
    (file endpoints), else a per-view ``read_into`` loop — the same graceful
    degradation as the scalar adapters, so chaos wrappers and third-party
    endpoints keep working unchanged.
    """
    fn = getattr(source, "readv_into", None)
    if fn is not None:
        total = sum(len(v) for v in views)
        got = fn(offset, views)
        if got != total:
            raise IOError(f"short vectored read at {offset}: {got}/{total}")
        return
    pos = offset
    for v in views:
        read_into(source, pos, v)
        pos += len(v)


def write_vec(dest: Any, offset: int, views: list[memoryview]) -> None:
    """Vectored write: land consecutive ``views`` starting at ``offset`` via
    one ``os.pwritev``-style syscall when the destination implements
    ``writev``, else a per-view ``write`` loop."""
    fn = getattr(dest, "writev", None)
    if fn is not None:
        total = sum(len(v) for v in views)
        got = fn(offset, views)
        if got != total:
            raise IOError(f"short vectored write at {offset}: {got}/{total}")
        return
    pos = offset
    for v in views:
        dest.write(pos, v)
        pos += len(v)


def fingerprint_view(mv: memoryview, granule: int = DEFAULT_STREAM_GRANULE) -> Digest:
    """Digest a buffer in cache-sized granule steps (merge law).

    One monolithic ``fingerprint_bytes`` over a large chunk streams its
    float64 conversion scratch through memory; granule-sized batches keep
    the working set cache-resident and run measurably faster. This is the
    read-back path's mirror of ``stream_chunk``'s granule digesting.
    """
    n = len(mv)
    if n <= granule:
        return fingerprint_bytes(mv)
    rf = RunningFingerprint()
    for pos in range(0, n, granule):
        rf.update(mv[pos : pos + granule])
    return rf.digest()


def read_back_fingerprint(
    dest: Any,
    offset: int,
    length: int,
    *,
    pool: "BufferPool | None" = None,
    granule: int = DEFAULT_STREAM_GRANULE,
    device: "torch.device | None" = None,
) -> Digest:
    """Fingerprint the landed bytes, cheapest path first: in place via the
    destination's zero-copy ``read_back_view`` when it has one, else into a
    pooled buffer, else through the classic ``read_back()`` bytes. Shared by
    the integrity engine and the single-pass inline verifier. With a
    ``device`` the digest runs there (``digest_view_device``), else on the
    host."""
    if device is None:
        def digest(mv):
            return fingerprint_view(mv, granule)
    else:
        def digest(mv):
            return digest_view_device(mv, device)
    viewfn = getattr(dest, "read_back_view", None)
    if viewfn is not None:
        mv = viewfn(offset, length)
        try:
            return digest(mv)
        finally:
            if isinstance(mv, memoryview):
                mv.release()
    if pool is not None:
        with pool.acquire(length) as buf:
            read_back_into(dest, offset, buf.view)
            return digest(buf.view)
    back = dest.read_back(offset, length)
    return digest(memoryview(back))


def stream_chunk(
    source: Any,
    dest: Any,
    offset: int,
    length: int,
    *,
    pool: BufferPool,
    granule: int = DEFAULT_STREAM_GRANULE,
    digest: bool = True,
    iov_batch: int = 1,
    device: "torch.device | None" = None,
) -> tuple[Digest | None, float]:
    """Single-pass chunk move: stream source->dest in granules, fingerprinting
    each granule while it is cache-hot from the read that produced it.

    Returns ``(source_digest, cksum_seconds)`` where ``cksum_seconds`` is the
    time spent inside fingerprint math only — the copy itself is mover time.
    The destination sees the same disjoint-offset writes a whole-chunk move
    would produce (granule writes are idempotent re-writes on retry).

    ``digest=False`` skips the fingerprint and returns ``(None, 0.0)`` when
    the source supports stable zero-copy views — the pipelined engine's
    checksum workers re-derive the source digest from the SAME view off the
    mover path (the paper's "source fingerprinting runs concurrently with
    subsequent chunk moves"). Sources without views always digest here: the
    streamed bytes are not reachable afterwards.

    ``iov_batch > 1`` batches that many consecutive granules into ONE vectored
    read and ONE vectored write (``os.preadv``/``os.pwritev`` on file
    endpoints): the syscall count per chunk drops by the batch factor while
    the per-granule cache-hot fingerprinting is unchanged — the stripe movers'
    default, since striping multiplies the number of in-flight sub-ranges.

    With a ``device`` the digest is taken there, of the same bytes: each
    granule is copied, as it streams, into a pinned host staging tensor the
    length of the chunk, and ONE ``checksum_words`` launch (``digest_of``)
    digests it at the chunk's end. ``cksum_seconds`` then counts the staging
    copies and the device digest.
    """
    granule = max(1, int(granule))
    iov_batch = max(1, int(iov_batch))
    ck_s = 0.0
    pos = offset
    end = offset + length
    viewfn = getattr(source, "read_view", None)
    # sources without views always digest: the streamed bytes are not
    # reachable afterwards
    digest = digest or viewfn is None
    if device is None:
        rf = RunningFingerprint()
    elif digest:
        stage = torch.empty(length, dtype=torch.uint8,
                            pin_memory=device.type == "cuda")
        staged = stage.numpy()

    def take(at: int, v) -> None:
        nonlocal ck_s
        t0 = time.perf_counter()
        if device is None:
            rf.update(v)
        else:
            staged[at - offset : at - offset + len(v)] = np.frombuffer(
                v, dtype=np.uint8)
        ck_s += time.perf_counter() - t0

    def result() -> tuple[Digest | None, float]:
        nonlocal ck_s
        if not digest:
            return None, ck_s
        if device is None:
            return rf.digest(), ck_s
        t0 = time.perf_counter()
        d = _digest_staged(stage, device)
        ck_s += time.perf_counter() - t0
        return d, ck_s

    if viewfn is not None:
        # fully zero-copy: digest and write straight out of the source image
        while pos < end:
            n = min(granule * iov_batch, end - pos)
            mv = viewfn(pos, n)
            if len(mv) != n:
                raise IOError(f"short read at {pos}: {len(mv)}/{n}")
            if digest:
                for g in range(0, n, granule):
                    take(pos + g, mv[g : g + granule])
            if iov_batch > 1:
                write_vec(dest, pos, [mv[g : g + granule]
                                      for g in range(0, n, granule)])
            else:
                dest.write(pos, mv)
            pos += n
        return result()
    span = min(granule * iov_batch, length) if length else 0
    buf = pool.acquire(span)
    try:
        while pos < end:
            n = min(span, end - pos)
            views = [buf.view[g : min(g + granule, n)]
                     for g in range(0, n, granule)]
            if len(views) == 1:
                read_into(source, pos, views[0])
            else:
                read_into_vec(source, pos, views)
            at = pos
            for v in views:
                take(at, v)
                at += len(v)
            if len(views) == 1:
                dest.write(pos, views[0])
            else:
                write_vec(dest, pos, views)
            pos += n
    finally:
        buf.release()
    return result()


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device a digest runs on. A CUDA device without a card raises:
    the port never turns a request for the card into a quiet CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is available "
                "(pass device='cpu' to run the plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported digest device {device!r}")
    return dev


def digest_view_device(mv, device: torch.device) -> Digest:
    """Digest of one host byte view, taken on ``device`` by
    ``kernels.ops.digest_of`` over a uint8 tensor — the ``checksum_words``
    kernel, with any length padded to a tile and the padding divided back
    out. The bytes stage through pinned host memory (torch's caching host
    allocator) and copy to the card without blocking; ``digest_of`` waits
    for the residues. On ``device="cpu"`` the kernel's plain version runs.
    The per-job twin of ``_digest_rows_device``."""
    host = np.frombuffer(mv, dtype=np.uint8)
    stage = torch.empty(host.size, dtype=torch.uint8,
                        pin_memory=device.type == "cuda")
    np.copyto(stage.numpy(), host)
    return _digest_staged(stage, device)


def _digest_staged(stage: torch.Tensor, device: torch.device) -> Digest:
    """Digest of a host uint8 tensor (pinned for a CUDA ``device``), copied
    to ``device`` without blocking and digested there by ``digest_of``."""
    from repro_torch.kernels import digest_of

    return digest_of(stage.to(device, non_blocking=True))


def fingerprint_on_device(data, device: torch.device):
    """Digest of a host byte view — or the digests of a list of equal-length
    views — taken on ``device``: the card's twin of ``fingerprint_bytes`` /
    ``fingerprint_many`` for the service's movers, dedup probes, index and
    scrubber, and the relay's hops.

    A length that is a positive multiple of the checksum tile
    (``kernels.checksum.TILE_BYTES``, 32 KiB) is stacked into one pinned
    host buffer, copied to ``device`` and digested by ONE
    ``checksum_many_words`` launch; any other length goes view by view
    through ``digest_view_device`` (``checksum_words``, the padding divided
    back out). There is no host path for any length: on ``device="cpu"``
    the kernels' plain versions run, and a failing launch raises to the
    caller."""
    from repro_torch.kernels import checksum as _ck

    if not isinstance(data, (list, tuple)):
        return fingerprint_on_device([data], device)[0]
    views = [np.frombuffer(v, dtype=np.uint8) for v in data]
    if not views:
        return []
    n = int(views[0].size)
    if any(int(v.size) != n for v in views):
        raise ValueError(
            f"fingerprint_on_device needs equal lengths, got "
            f"{sorted({int(v.size) for v in views})}")
    if n == 0 or n % _ck.TILE_BYTES:
        return [digest_view_device(v, device) for v in views]
    stage = torch.empty((len(views), n), dtype=torch.uint8,
                        pin_memory=device.type == "cuda")
    host = stage.numpy()
    for j, v in enumerate(views):
        np.copyto(host[j], v)
    mat = stage.to(device, non_blocking=True).view(torch.int32)
    res = _ck.checksum_many_words(mat).cpu().tolist()
    return [Digest(tuple(int(x) for x in r), n) for r in res]


def _digest_rows_device(rows: list["np.ndarray"],
                        device: torch.device) -> list[Digest]:
    """Batched digests with the card in the loop (twin of the reference's
    ``_digest_rows_pallas``): each equal-length group goes through
    ``fingerprint_on_device`` — ONE ``checksum_many_words`` launch when its
    length tiles the checksum kernel, ``checksum_words`` row by row
    otherwise. No row is digested on the host. On ``device="cpu"`` the
    wrappers run the kernels' plain versions. Returns the digests in row
    order."""
    out: list[Digest | None] = [None] * len(rows)
    groups: dict[int, list[int]] = {}
    for i, r in enumerate(rows):
        groups.setdefault(int(r.size), []).append(i)
    for idxs in groups.values():
        digs = fingerprint_on_device([rows[i] for i in idxs], device)
        for i, d in zip(idxs, digs):
            out[i] = d
    return out                                        # type: ignore[return-value]


# ---------------------------------------------------------------------------
# the decoupled integrity engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class VerifyJob:
    """One deferred verification, enqueued by a mover.

    ``key`` is the caller's chunk identity (opaque to the engine), ``dest``
    the endpoint to read back from, ``expected`` the source digest taken
    during streaming. ``expected=None`` defers the SOURCE fingerprint too:
    the worker re-derives it from ``source``'s stable zero-copy view before
    verifying — movers on view-capable sources are pure wire. ``payload``
    rides along to the callbacks (the engine's callers stash their
    outcome/telemetry object there).
    """

    key: Any
    offset: int
    length: int
    expected: Digest | None
    dest: Any
    enqueued_s: float
    payload: Any = None
    source: Any = None           # required when expected is None


@dataclasses.dataclass
class IntegrityStats:
    verified: int = 0
    corrupt: int = 0
    errors: int = 0
    lag_seconds: float = 0.0     # sum of (verdict time - enqueue time)
    max_lag_s: float = 0.0
    cksum_seconds: float = 0.0   # read-back + fingerprint work time
    fused_batches: int = 0       # drain rounds digested as one fused dispatch
    fused_jobs: int = 0          # jobs that rode a fused dispatch
    device_rows: int = 0         # fused rows digested by the device kernel
    host_rows: int = 0           # fused rows digested on the host (host backend)
    per_job: int = 0             # jobs verified one by one on the host
    device_jobs: int = 0         # jobs verified one by one on the device


class IntegrityEngine:
    """Checksum worker pool consuming a digest queue off the mover path.

    Workers read the landed bytes back (into pooled buffers), fingerprint
    them, and fire exactly one of the caller's callbacks per job — all from
    worker threads, so callbacks must do their own locking:

      * ``on_verified(job, lag_s, ck_s)``   — digests match; this is where
        the caller journals the chunk (the custody rule);
      * ``on_corrupt(job, actual, lag_s)``  — digest mismatch; the caller
        quarantines and re-queues the chunk within its re-fetch budget;
      * ``on_error(job, exc)``              — the read-back itself failed.

    ``drain()`` blocks until every submitted job has a verdict; ``close()``
    stops the workers (``abandon=True`` skips the join — crash simulation).

    **Fused drain** (``fuse=True``, the default): instead of one read-back +
    one host digest call per job, a worker opportunistically collects up to
    ``batch`` queued jobs, reads all of them back, and digests every row —
    landed bytes plus any deferred source fingerprints — in ONE
    ``fingerprint_many`` dispatch (equal-length granules stack into a single
    GEMM; ragged lengths fall back per-item inside). Jobs larger than
    ``fuse_max_bytes`` keep the per-chunk granule-streaming path, which is
    already bandwidth-bound at that size. ``backend="device"`` (the default)
    digests every row on ``device`` instead: tile-aligned equal-length groups
    through the batched ``kernels.checksum.checksum_many_words`` kernel (one
    launch per group), any other length row by row through
    ``checksum_words`` — no row goes to the host.
    ``device="cuda"`` is the card and raises where there is none;
    ``device="cpu"`` runs the kernel's plain version. ``backend="host"``
    keeps every digest on the numpy path.

    A batch of one job and every job over ``fuse_max_bytes`` verify per job:
    with ``backend="device"`` on ``device`` through ``checksum_words``
    (``digest_view_device``, counted in ``stats.device_jobs``), with
    ``backend="host"`` on the host as in the reference (``stats.per_job``).
    A failing kernel routes its job — or poisons its whole fused batch —
    into ``on_error``: never a quiet host retry.
    """

    _SENTINEL = None

    def __init__(
        self,
        *,
        workers: int = 2,
        pool: BufferPool | None = None,
        on_verified: Callable[[VerifyJob, float, float], None],
        on_corrupt: Callable[[VerifyJob, Digest, float], None],
        on_error: Callable[[VerifyJob, BaseException], None] | None = None,
        tracer=None,                 # obs.Tracer: verify wait/work spans
        task: str = "",              # owning task id for spans + metrics
        fuse: bool = True,
        batch: int = 32,
        fuse_max_bytes: int = 8 * MiB,
        backend: str = "device",
        device: "str | torch.device" = "cuda",
    ):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if backend not in ("host", "device"):
            raise ValueError(f"unknown integrity backend {backend!r}")
        self._device = resolve_device(device) if backend == "device" else None
        self._pool = pool
        self._fuse = bool(fuse)
        self._batch = int(batch)
        self._fuse_max = int(fuse_max_bytes)
        self._backend = backend
        self._on_verified = on_verified
        self._on_corrupt = on_corrupt
        self._on_error = on_error
        self._tracer = tracer if tracer is not None else _NULL_TRACER
        self._task = task
        # verification lag is the pipelined data plane's health signal: a
        # growing distribution means the checksum pool is falling behind
        # movement (the flip side of the overlap win)
        self._lag_hist = _metrics.REGISTRY.histogram(
            "verify_lag_seconds", "move-landed -> verified delay",
            ("task",), scale=1e-5)
        self._verdicts = _metrics.REGISTRY.counter(
            "verify_verdicts_total", "deferred verification verdicts",
            ("task", "verdict"))
        self._q: "queue.Queue[VerifyJob | None]" = queue.Queue()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0
        self._closed = False
        self.stats = IntegrityStats()
        self._threads = [
            threading.Thread(target=self._worker, args=(i,),
                             name=f"integrity-{i}", daemon=True)
            for i in range(workers)
        ]
        for th in self._threads:
            th.start()

    # ------------------------------------------------------------------
    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    def submit(self, job: VerifyJob) -> bool:
        """Enqueue a job; returns False if the engine is already closed.

        A False return happens only in shutdown/kill races (a mover landing
        its last write while the owner tears the engine down); the chunk
        simply stays unverified and unjournaled — exactly what a crash at
        that instant would leave behind.
        """
        with self._lock:
            if self._closed:
                return False
            self._pending += 1
            # the enqueue must happen under the same lock as the _closed
            # check: otherwise a submit that passed the check can land its
            # job BEHIND close()'s sentinels — the job never gets a verdict,
            # _pending never decrements, and drain() hangs forever
            self._q.put(job)
        return True

    def drain(self, timeout: float | None = None) -> bool:
        """Wait until every submitted job has a verdict. Returns False on
        timeout (pending jobs remain)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._pending > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining if remaining is not None else 0.5)
        return True

    def close(self, *, abandon: bool = False) -> None:
        """Stop the workers. Queued jobs still get verdicts before the stop
        lands (the sentinel sits behind them) unless ``abandon`` — the crash
        path — which leaves the daemon workers to die with the process."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # sentinels go in under the lock too, so every job admitted by
            # submit() is provably ahead of them in the queue
            for _ in self._threads:
                self._q.put(self._SENTINEL)
        if not abandon:
            for th in self._threads:
                th.join()

    # ------------------------------------------------------------------
    def _worker(self, wid: int) -> None:
        while True:
            job = self._q.get()
            if job is self._SENTINEL:
                return
            batch = [job]
            if self._fuse and self._batch > 1:
                # opportunistic batch collection: take whatever is already
                # queued (up to the cap) without blocking — an idle queue
                # degrades to the per-job path, a deep one fuses
                while len(batch) < self._batch:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is self._SENTINEL:
                        # resurface it: jobs can never be queued behind a
                        # sentinel (submit+close share the lock), so the
                        # tail is all sentinels and re-putting is safe
                        self._q.put(nxt)
                        break
                    batch.append(nxt)
            if len(batch) == 1 or not self._fusable(batch):
                for j in batch:
                    try:
                        self._verify_one(j, wid)
                    finally:
                        with self._idle:
                            self._pending -= 1
                            self._idle.notify_all()
            else:
                self._verify_batch(batch, wid)

    def _fusable(self, batch: list[VerifyJob]) -> bool:
        """A batch fuses when at least two jobs sit in the granule regime the
        GEMM stack amortizes; oversize jobs are better off streaming."""
        return sum(1 for j in batch if j.length <= self._fuse_max) >= 2

    def _verify_batch(self, jobs: list[VerifyJob], wid: int) -> None:
        """Fused verification: gather every row, digest in one dispatch, then
        fire per-job verdicts. Per-job pending decrement happens only after
        that job's callback — drain()'s return stays authoritative."""
        t0 = time.perf_counter()
        small = [j for j in jobs if j.length <= self._fuse_max]
        big = [j for j in jobs if j.length > self._fuse_max]
        entries: list[dict] = []
        for job in small:
            ent: dict = {"job": job, "holders": [], "buf": None, "error": None,
                         "back": None, "src": None,
                         "back_dig": None, "src_dig": None}
            try:
                if job.expected is None:
                    mv = job.source.read_view(job.offset, job.length)
                    ent["holders"].append(mv)
                    ent["src"] = np.frombuffer(mv, dtype=np.uint8)
                viewfn = getattr(job.dest, "read_back_view", None)
                if viewfn is not None:
                    mv = viewfn(job.offset, job.length)
                    if len(mv) != job.length:
                        raise IOError(
                            f"short read-back at {job.offset}: {len(mv)}/{job.length}")
                    ent["holders"].append(mv)
                    ent["back"] = np.frombuffer(mv, dtype=np.uint8)
                elif self._pool is not None:
                    buf = self._pool.acquire(job.length)
                    ent["buf"] = buf
                    read_back_into(job.dest, job.offset, buf.view)
                    ent["back"] = np.frombuffer(buf.view, dtype=np.uint8)
                else:
                    data = job.dest.read_back(job.offset, job.length)
                    if len(data) != job.length:
                        raise IOError(
                            f"short read-back at {job.offset}: {len(data)}/{job.length}")
                    ent["back"] = np.frombuffer(data, dtype=np.uint8)
            except BaseException as e:  # noqa: BLE001 — routed per job
                ent["error"] = e
            entries.append(ent)
        # ONE fused digest dispatch over every gathered row (landed bytes and
        # deferred source fingerprints alike); fingerprint_many groups equal
        # lengths into single GEMM stacks and handles the ragged leftovers
        rows: list[np.ndarray] = []
        slots: list[tuple[dict, str]] = []
        for ent in entries:
            if ent["error"] is None:
                rows.append(ent["back"])
                slots.append((ent, "back_dig"))
                if ent["src"] is not None:
                    rows.append(ent["src"])
                    slots.append((ent, "src_dig"))
        if rows:
            try:
                digs = self._digest_rows(rows)
                for (ent, field), d in zip(slots, digs):
                    ent[field] = d
            except BaseException as e:  # noqa: BLE001 — poison the whole batch
                for ent in entries:
                    if ent["error"] is None:
                        ent["error"] = e
        del rows, slots
        t_dig = time.perf_counter()
        with self._lock:
            self.stats.fused_batches += 1
            self.stats.fused_jobs += len(small)
        # per-job verdicts: sequential sub-windows of the batch interval keep
        # the verifier lane's span timeline non-overlapping for obs.attr
        n = len(entries)
        width = (t_dig - t0) / max(1, n)
        for i, ent in enumerate(entries):
            job = ent["job"]
            try:
                self._finish_fused(ent, wid, t0 + i * width, t0 + (i + 1) * width)
            finally:
                ent["back"] = ent["src"] = None
                for h in ent["holders"]:
                    if isinstance(h, memoryview):
                        h.release()
                if ent["buf"] is not None:
                    ent["buf"].release()
                with self._idle:
                    self._pending -= 1
                    self._idle.notify_all()
        for job in big:
            try:
                self._verify_one(job, wid)
            finally:
                with self._idle:
                    self._pending -= 1
                    self._idle.notify_all()

    def _finish_fused(self, ent: dict, wid: int, t0: float, t1: float) -> None:
        job: VerifyJob = ent["job"]
        self._tracer.add(
            "verify_wait", "cksum_wait", job.enqueued_s, t0,
            task=self._task, lane=f"verifier{wid}", offset=job.offset)
        if ent["error"] is not None:
            with self._lock:
                self.stats.errors += 1
            if self._on_error is not None:
                self._on_error(job, ent["error"])
            return
        expected = job.expected if job.expected is not None else ent["src_dig"]
        job.expected = expected
        actual = ent["back_dig"]
        lag = t1 - job.enqueued_s
        ck = t1 - t0
        ok = verify(expected, actual)
        self._tracer.add(
            "verify", "cksum", t0, t1, task=self._task,
            lane=f"verifier{wid}", offset=job.offset, ok=ok, fused=True)
        self._lag_hist.observe(lag, task=self._task)
        self._verdicts.inc(1, task=self._task,
                           verdict="ok" if ok else "corrupt")
        with self._lock:
            self.stats.cksum_seconds += ck
            self.stats.lag_seconds += lag
            self.stats.max_lag_s = max(self.stats.max_lag_s, lag)
            if ok:
                self.stats.verified += 1
            else:
                self.stats.corrupt += 1
        try:
            if ok:
                self._on_verified(job, lag, ck)
            else:
                self._on_corrupt(job, actual, lag)
        except BaseException as e:  # noqa: BLE001 — a callback bug must not
            with self._lock:        # silently kill a verifier thread
                self.stats.errors += 1
            if self._on_error is not None:
                self._on_error(job, e)

    def _digest_rows(self, rows: list[np.ndarray]) -> list[Digest]:
        on_device = self._backend == "device"
        digs = (_digest_rows_device(rows, self._device) if on_device
                else fingerprint_many(rows))
        with self._lock:
            if on_device:
                self.stats.device_rows += len(rows)
            else:
                self.stats.host_rows += len(rows)
        return digs

    def _verify_one(self, job: VerifyJob, wid: int = 0) -> None:
        t0 = time.perf_counter()
        # queue-wait is a first-class span: when this interval is non-trivial
        # the verify pool is saturated and the transfer is checksum-BOUND —
        # exactly the condition obs.attr charges segments to "cksum"
        self._tracer.add(
            "verify_wait", "cksum_wait", job.enqueued_s, t0,
            task=self._task, lane=f"verifier{wid}", offset=job.offset)
        dev = self._device           # None: the host backend
        try:
            if job.expected is None:
                # deferred source fingerprint: derive it off the mover path
                # from the source's stable view (same bytes the mover wrote)
                src_mv = job.source.read_view(job.offset, job.length)
                try:
                    job.expected = (fingerprint_view(src_mv) if dev is None
                                    else digest_view_device(src_mv, dev))
                finally:
                    if isinstance(src_mv, memoryview):
                        src_mv.release()
            # true zero-copy verify where the dest allows it: fingerprint
            # the landed bytes in place (in-memory dests expose their image
            # as a view; concurrent movers only touch disjoint offsets)
            actual = read_back_fingerprint(
                job.dest, job.offset, job.length, pool=self._pool, device=dev)
        except BaseException as e:  # noqa: BLE001 — routed to the caller
            with self._lock:
                self.stats.errors += 1
            if self._on_error is not None:
                self._on_error(job, e)
            return
        now = time.perf_counter()
        lag = now - job.enqueued_s
        ck = now - t0
        ok = verify(job.expected, actual)
        self._tracer.add(
            "verify", "cksum", t0, now, task=self._task,
            lane=f"verifier{wid}", offset=job.offset, ok=ok)
        self._lag_hist.observe(lag, task=self._task)
        self._verdicts.inc(1, task=self._task,
                           verdict="ok" if ok else "corrupt")
        with self._lock:
            if dev is None:
                self.stats.per_job += 1
            else:
                self.stats.device_jobs += 1
            self.stats.cksum_seconds += ck
            self.stats.lag_seconds += lag
            self.stats.max_lag_s = max(self.stats.max_lag_s, lag)
            if ok:
                self.stats.verified += 1
            else:
                self.stats.corrupt += 1
        try:
            if ok:
                self._on_verified(job, lag, ck)
            else:
                self._on_corrupt(job, actual, lag)
        except BaseException as e:  # noqa: BLE001 — a callback bug must not
            with self._lock:        # silently kill a verifier thread
                self.stats.errors += 1
            if self._on_error is not None:
                self._on_error(job, e)
