"""Chunked transfer engine — the host-side data movers.

This is the paper-faithful implementation of §3.1/§3.2 on a host: N worker
threads (the "data mover pairs") pull chunks from a shared queue (natural
work-stealing => straggler mitigation), move disjoint byte ranges from a
source to a destination, compute per-chunk fingerprints pipelined with the
movement, verify end-to-end integrity chunk-by-chunk, journal completions for
partial restart, retry failed chunks (chunk-granular fault recovery rather
than whole-transfer restart), and optionally speculate on stragglers.

The data plane has three modes (see ``PIPELINE_MODES`` below and
``core.dataplane``): the classic serial path, a zero-copy single-pass
streaming path, and a fully pipelined path where a decoupled integrity
engine verifies chunks concurrently with subsequent moves — the journal
record commits only after the deferred verification lands.

This is the port's copy of ``repro.core.transfer``. It differs in one
place: ``ChunkedTransfer(device=...)`` hands ``device`` to the integrity
engine it builds, so a pipelined transfer's fused verification digests run
in the CUDA kernels (``device="cuda"``, the default) or in their plain
versions (``device="cpu"``). The reference wires no backend there.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Protocol

import numpy as np

from repro_torch.core.chunker import (
    Chunk,
    ChunkPlan,
    merge_regions,
    partition_regions,
    plan_stripes,
    subtract_regions,
)
from repro_torch.core.dataplane import (
    DEFAULT_STREAM_GRANULE,
    BufferPool,
    IntegrityEngine,
    VerifyJob,
    read_back_fingerprint,
    resolve_device,
    stream_chunk,
)
from repro_torch.core.integrity import (
    Digest,
    combine_at_offsets,
    describe_mismatch,
    fingerprint_bytes,
    merge_all,
    verify,
)
from repro_torch.core.backoff import Backoff
from repro_torch.core.journal import ChunkJournal, JournalRecord
from repro_torch.obs import metrics as obsmetrics
from repro_torch.obs.trace import NULL as NULL_TRACER

# data-plane pipeline modes (ChunkedTransfer(pipeline=...)):
#   serial      — read -> digest -> write -> read-back -> digest -> verify,
#                 all on the mover (the original engine, now zero-copy);
#   single_pass — the source digest accumulates WHILE the chunk streams into
#                 the destination (one data pass saved); verify still inline;
#   pipelined   — single-pass streaming + verification deferred to the
#                 integrity engine's checksum workers, off the mover path.
#                 Custody rule: the journal record commits only after the
#                 deferred verification lands.
PIPELINE_MODES = ("serial", "single_pass", "pipelined")

# Work-item index band for intra-chunk stripes. Stripe work items carry
# indices from this base so they can never collide with plan chunk ids,
# re-planned tail ids (which grow upward from plan.n_chunks), or the
# service's tuned band (1 << 40) — and so restart logic can recognize a
# journal record as stripe custody by its index alone.
STRIPE_INDEX_BASE = 1 << 50


# ---------------------------------------------------------------------------
# Source / destination abstractions
# ---------------------------------------------------------------------------
class ByteSource(Protocol):
    nbytes: int
    def read(self, offset: int, length: int) -> bytes: ...
    # optional zero-copy variant (``core.dataplane.read_into`` adapts):
    #   def read_into(self, offset: int, view: memoryview) -> int: ...


class ByteDest(Protocol):
    def write(self, offset: int, data: bytes) -> None: ...
    def read_back(self, offset: int, length: int) -> bytes: ...
    # optional zero-copy variant (``core.dataplane.read_back_into`` adapts):
    #   def read_back_into(self, offset: int, view: memoryview) -> int: ...


_HAS_PREAD = hasattr(os, "pread") and hasattr(os, "pwrite")


class BufferSource:
    """Zero-copy view over an in-memory byte image (e.g. a host array)."""

    def __init__(self, data: bytes | bytearray | memoryview | np.ndarray):
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).view(np.uint8).reshape(-1).data
        self._mv = memoryview(data)
        self.nbytes = self._mv.nbytes

    def read(self, offset: int, length: int) -> bytes:
        return bytes(self._mv[offset : offset + length])

    def read_into(self, offset: int, view: memoryview) -> int:
        n = min(len(view), self.nbytes - offset)
        view[:n] = self._mv[offset : offset + n]
        return n

    def read_view(self, offset: int, length: int) -> memoryview:
        """Zero-copy window over the source image: streaming movers digest
        and write straight from it — no staging buffer, no copy at all."""
        return self._mv[offset : offset + length]


class _FallbackHandles:
    """Per-thread seekable handles for the off-POSIX path.

    Each mover thread gets its OWN handle (two movers sharing one seekable
    handle can interleave seek+read/seek+write and corrupt landings), and
    every handle ever vended is tracked under a lock so ``close()`` can
    actually close them — the per-thread handles used to leak, one fd per
    mover thread per endpoint, for the lifetime of the process.
    """

    def __init__(self, opener: Callable[[], object]):
        self._opener = opener
        self._local = threading.local()
        self._lock = threading.Lock()
        self._all: list = []

    def get(self):
        fh = getattr(self._local, "fh", None)
        if fh is None or fh.closed:
            fh = self._opener()
            self._local.fh = fh
            with self._lock:
                self._all.append(fh)
        return fh

    def close_all(self) -> None:
        with self._lock:
            handles, self._all = self._all, []
        for fh in handles:
            try:
                fh.close()
            except Exception:  # noqa: BLE001 — already-closed / teardown
                pass


class FileSource:
    """Positional-read file source: one shared fd, ``os.pread`` per read, so
    concurrent movers on the same file never serialize on a seek+read handle
    (non-POSIX platforms fall back to per-thread handles)."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self.nbytes = os.path.getsize(self.path)
        self._fd: int | None = None
        if _HAS_PREAD:
            self._fd = os.open(self.path, os.O_RDONLY)
        self._fallback = _FallbackHandles(lambda: open(self.path, "rb"))

    def _fh(self):
        return self._fallback.get()

    def read(self, offset: int, length: int) -> bytes:
        if self._fd is not None:
            return os.pread(self._fd, length, offset)
        fh = self._fh()
        fh.seek(offset)
        return fh.read(length)

    def read_into(self, offset: int, view: memoryview) -> int:
        if self._fd is not None:
            return os.preadv(self._fd, [view], offset)
        fh = self._fh()
        fh.seek(offset)
        return fh.readinto(view)

    def readv_into(self, offset: int, views: list) -> int:
        """Vectored read: one ``os.preadv`` fills every view (the stripe
        movers' iovec batch); the off-POSIX fallback loops on the thread's
        own handle, so concurrency safety matches the scalar path."""
        if self._fd is not None:
            return os.preadv(self._fd, views, offset)
        fh = self._fh()
        fh.seek(offset)
        got = 0
        for v in views:
            n = fh.readinto(v)
            got += n
            if n < len(v):
                break
        return got

    def close(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)
        self._fallback.close_all()

    def __del__(self):  # raw fds are not GC-closed like file objects
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class FileDest:
    """Preallocated file destination; positional ``os.pwrite``/``os.pread``
    on one shared fd allow concurrent writes + verification reads of disjoint
    ranges with no per-op locking or seeking (the ESTO analogue)."""

    def __init__(self, path: str | os.PathLike, total_bytes: int):
        self.path = str(path)
        self.total_bytes = total_bytes
        # Preallocate only when absent/mis-sized: a partially-written file from
        # a crashed save must keep its journaled chunks (partial restart).
        if not os.path.exists(self.path) or os.path.getsize(self.path) != total_bytes:
            with open(self.path, "wb") as fh:
                if total_bytes:
                    fh.truncate(total_bytes)
        self._fd: int | None = None
        if _HAS_PREAD:
            self._fd = os.open(self.path, os.O_RDWR)
        self._fallback = _FallbackHandles(lambda: open(self.path, "r+b"))

    def _fh(self):
        return self._fallback.get()

    def write(self, offset: int, data: bytes) -> None:
        if self._fd is not None:
            os.pwrite(self._fd, data, offset)
            return
        fh = self._fh()
        fh.seek(offset)
        fh.write(data)
        fh.flush()

    def writev(self, offset: int, views: list) -> int:
        """Vectored write: one ``os.pwritev`` lands every view (the stripe
        movers' iovec batch); the off-POSIX fallback loops on the thread's
        own handle."""
        if self._fd is not None and hasattr(os, "pwritev"):
            return os.pwritev(self._fd, views, offset)
        if self._fd is not None:
            got = 0
            for v in views:
                got += os.pwrite(self._fd, v, offset + got)
            return got
        fh = self._fh()
        fh.seek(offset)
        got = 0
        for v in views:
            got += fh.write(v)
        fh.flush()
        return got

    def read_back(self, offset: int, length: int) -> bytes:
        if self._fd is not None:
            return os.pread(self._fd, length, offset)
        fh = self._fh()
        fh.seek(offset)
        return fh.read(length)

    def read_back_into(self, offset: int, view: memoryview) -> int:
        if self._fd is not None:
            return os.preadv(self._fd, [view], offset)
        fh = self._fh()
        fh.seek(offset)
        return fh.readinto(view)

    def close(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)
        self._fallback.close_all()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class BufferDest:
    def __init__(self, total_bytes: int):
        self.buf = bytearray(total_bytes)

    def write(self, offset: int, data: bytes) -> None:
        self.buf[offset : offset + len(data)] = data

    def read_back(self, offset: int, length: int) -> bytes:
        return bytes(self.buf[offset : offset + length])

    def read_back_into(self, offset: int, view: memoryview) -> int:
        n = min(len(view), len(self.buf) - offset)
        view[:n] = memoryview(self.buf)[offset : offset + n]
        return n

    def read_back_view(self, offset: int, length: int) -> memoryview:
        """Zero-copy window over the landed bytes (deferred verification
        fingerprints the destination image in place)."""
        return memoryview(self.buf)[offset : offset + length]


# ---------------------------------------------------------------------------
# Fault taxonomy — the failure classes the recovery logic distinguishes
# ---------------------------------------------------------------------------
class IntegrityError(RuntimeError):
    """Per-chunk digest mismatch that survived the re-fetch budget."""


class MoverCrash(RuntimeError):
    """A data mover died mid-chunk. The worker thread that raises (or
    observes) this is gone; the chunk it held is re-queued for surviving
    movers — a dead mover costs one chunk re-move, never the transfer."""


class EndpointOutage(IOError):
    """An endpoint is temporarily unavailable (reads/writes raise for a
    window). Retried on a separate, larger budget than generic I/O errors
    with backoff, because outages heal on their own clock, not the chunk's."""


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One corrupt chunk landing, caught by the read-back digest and healed
    by a re-fetch from the source (the paper's §3.2 rationale: a bad chunk
    costs one chunk re-read, not a terabyte-file restart)."""

    chunk_index: int
    offset: int
    length: int
    attempt: int
    expected_hex: str
    actual_hex: str
    detail: str


class _ChunkCorruption(Exception):
    """Internal: read-back digest disagreed with the source digest."""

    def __init__(self, expected: Digest, actual: Digest):
        super().__init__(describe_mismatch(expected, actual))
        self.expected, self.actual = expected, actual


# ---------------------------------------------------------------------------
# Transfer engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ChunkOutcome:
    chunk: Chunk
    digest: Digest
    attempts: int
    mover: int
    seconds: float                 # total time on the chunk, retries included
    attempt_seconds: float = 0.0   # fault-excluded MOVER work time (tuner signal)
    cksum_seconds: float = 0.0     # checksum work on the mover path (source
    #                                fingerprint; + read-back verify when inline)
    cksum_lag_s: float = 0.0       # pipelined only: move-landed -> verified delay
    refetches: int = 0             # corruption-healing re-reads of this chunk


@dataclasses.dataclass
class _StripeSet:
    """Aggregation state for one striped chunk: per-stripe digests collect
    here and fold into the parent digest when the last stripe verifies."""

    parent: Chunk
    n: int
    digests: dict[int, Digest] = dataclasses.field(default_factory=dict)
    attempts: int = 0
    refetches: int = 0
    seconds: float = 0.0           # summed stripe mover time (work, not wall)
    attempt_seconds: float = 0.0
    cksum_seconds: float = 0.0
    cksum_lag_s: float = 0.0


@dataclasses.dataclass
class TransferReport:
    total_bytes: int
    file_digest: Digest
    outcomes: dict[int, ChunkOutcome]
    seconds: float
    retries: int
    skipped_chunks: int            # restored from journal (partial restart)
    speculated: int
    refetches: int = 0             # corrupt chunks healed by source re-read
    mover_deaths: int = 0          # worker threads lost mid-chunk, survived
    outage_retries: int = 0        # ops rejected by an endpoint outage window
    quarantined: tuple[QuarantineRecord, ...] = ()
    replans: int = 0               # mid-flight tail re-partitions (autotuner)
    chunk_bytes_final: int = 0     # nominal tail chunk size at completion
    pipeline: str = "serial"       # data-plane mode this transfer ran under
    cksum_lag_s: float = 0.0       # pipelined: total verification lag (sum)
    stripes: int = 1               # stripe fan-out at completion (tuner-led)
    striped_chunks: int = 0        # parent chunks that were striped
    stripe_replans: int = 0        # mid-flight stripe-count changes (tuner)
    deduped_chunks: int = 0        # chunks satisfied from the chunk index
    dedup_bytes_saved: int = 0     # wire bytes those chunks would have cost
    dedup_demoted: int = 0         # stale/corrupt index hits demoted to wire

    @property
    def gbps(self) -> float:
        return self.total_bytes * 8 / 1e9 / self.seconds if self.seconds > 0 else 0.0


class ChunkedTransfer:
    """Executes a ChunkPlan with integrity checking and chunk-level recovery."""

    def __init__(
        self,
        source: ByteSource,
        dest: ByteDest,
        plan: ChunkPlan,
        *,
        integrity: bool = True,
        journal: ChunkJournal | None = None,
        max_retries: int = 3,
        max_refetches: int = 3,            # re-reads per chunk on digest mismatch
        outage_retries: int = 64,          # endpoint-outage budget per chunk
        outage_backoff_s: float = 0.002,
        max_mover_deaths: int | None = None,   # None -> 4*movers + 4
        fault_injector: Callable[[Chunk, int], None] | None = None,
        speculative_factor: float = 0.0,   # >0 enables straggler duplication
        tuner=None,                        # ChunkController-like: observe(sample)
        alignment: int = 1,                # re-plan cut-point alignment
        pipeline: str = "serial",          # serial | single_pass | pipelined
        integrity_workers: int = 2,        # checksum worker pool (pipelined)
        stream_granule: int = DEFAULT_STREAM_GRANULE,
        pool: BufferPool | None = None,    # shared buffer pool (else per-run)
        tracer=None,                       # obs.Tracer: chunk-lifecycle spans
        task: str = "",                    # task id on spans/metrics labels
        stripes: int = 1,                  # >1 splits big chunks across movers
        stripe_min_bytes: int = 4 * 1024 * 1024,
        iov_batch: int = 1,                # granules per vectored I/O syscall
        dedup_index=None,                  # cas.ChunkIndex of the dest endpoint
        dedup_target: str = "",            # dest's canonical path in that index
        device="cuda",                     # where pipelined verify digests run
    ):
        if source.nbytes != plan.total_bytes:
            raise ValueError(f"source has {source.nbytes} bytes, plan expects {plan.total_bytes}")
        if tuner is not None and speculative_factor > 0:
            raise ValueError(
                "speculative duplication and mid-flight re-planning are "
                "mutually exclusive: a speculated twin of a re-partitioned "
                "chunk would overlap the fresh tail chunks"
            )
        if pipeline not in PIPELINE_MODES:
            raise ValueError(f"pipeline must be one of {PIPELINE_MODES}, got {pipeline!r}")
        if pipeline == "pipelined" and speculative_factor > 0:
            raise ValueError(
                "speculative duplication forces serial verification: a "
                "speculated twin racing a deferred verify could journal a "
                "chunk the verifier has not vouched for"
            )
        if pipeline == "pipelined" and not integrity:
            pipeline = "single_pass"    # nothing to defer without read-back
        if integrity_workers < 1:
            raise ValueError("integrity_workers must be >= 1")
        if stripes < 1:
            raise ValueError("stripes must be >= 1")
        if stripes > 1 and speculative_factor > 0:
            raise ValueError(
                "speculative duplication and striping are mutually "
                "exclusive: a speculated twin duplicates whole plan chunks, "
                "but striped chunks land as sub-ranges the speculation "
                "watcher does not know about"
            )
        if stripe_min_bytes < 1:
            raise ValueError("stripe_min_bytes must be >= 1")
        self.source, self.dest, self.plan = source, dest, plan
        self.integrity = integrity
        self.pipeline = pipeline
        # the port's one deliberate difference from the reference engine:
        # the integrity engine it builds digests on ``device`` (the card
        # unless the caller asks for "cpu"); checked now, not mid-run
        self.device = resolve_device(device) if pipeline == "pipelined" else device
        self.integrity_workers = integrity_workers
        self.stream_granule = max(1, int(stream_granule))
        self.journal = journal
        self.max_retries = max_retries
        self.max_refetches = max_refetches
        self.outage_retries = outage_retries
        self.outage_backoff_s = outage_backoff_s
        self.max_mover_deaths = max_mover_deaths
        self.fault_injector = fault_injector
        self.speculative_factor = speculative_factor
        self.tuner = tuner
        self.alignment = max(1, alignment)
        # observability: spans are emitted RETROACTIVELY from timestamps the
        # engine takes anyway (tuner telemetry), so the default NullTracer
        # costs one no-op call per phase on the hot path
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.task = task
        self._enq_t: dict[int, float] = {}    # chunk index -> last enqueue time
        self._m_chunks = obsmetrics.REGISTRY.counter(
            "chunks_total", "landed chunks", ("task", "pipeline"))
        self._m_bytes = obsmetrics.REGISTRY.counter(
            "bytes_total", "landed bytes", ("task", "pipeline"))
        self._m_retry = obsmetrics.REGISTRY.counter(
            "chunk_retries_total", "per-class chunk recovery events",
            ("task", "kind"))
        self._m_wire = obsmetrics.REGISTRY.histogram(
            "chunk_wire_seconds", "fault-excluded per-chunk mover time",
            ("task",), scale=1e-4)
        self._m_dedup = obsmetrics.REGISTRY.counter(
            "dedup_chunks_total", "chunks satisfied from the chunk index",
            ("task",))
        self._m_dedup_bytes = obsmetrics.REGISTRY.counter(
            "dedup_bytes_saved_total", "wire bytes saved by dedup hits",
            ("task",))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)   # completion/error/death
        self._outcomes: dict[int, ChunkOutcome] = {}
        self._retries = 0
        self._refetches = 0
        self._outage_retries_seen = 0
        self._mover_deaths = 0
        self._speculated = 0
        self._quarantined: list[QuarantineRecord] = []
        self._errors: list[BaseException] = []
        self._target = 0           # chunks this run() must land
        self._live_workers = 0
        self._death_budget = 0
        # mid-flight re-plan state: the nominal tail size, a fresh-index
        # allocator that can never collide with journaled ids, and counters.
        # The controller is not thread-safe; movers serialize observe +
        # re-plan under a dedicated lock (separate from self._lock, which
        # _replan_queued itself acquires).
        self._tune_lock = threading.Lock()
        self._chunk_bytes_now = plan.chunk_bytes or plan.total_bytes
        self._next_index = plan.n_chunks
        self._replans = 0
        # striping state: stripe work items carry indices from the stripe
        # band; the parent map routes their commits into the _StripeSet that
        # folds per-stripe digests into the parent chunk digest. The index
        # allocator is bumped past any journaled stripe ids at run() so a
        # restarted incarnation can never re-issue a journaled stripe's id.
        self.stripes = int(stripes)
        self.stripe_min_bytes = int(stripe_min_bytes)
        self.iov_batch = max(1, int(iov_batch))
        self._stripe_parent: dict[int, Chunk] = {}
        self._stripe_sets: dict[int, _StripeSet] = {}
        self._next_stripe_index = STRIPE_INDEX_BASE
        self._striped_chunks = 0
        self._stripe_replans = 0
        # content plane: the destination endpoint's chunk index. Probed
        # before movers start (_negotiate_dedup); populated as verified
        # chunks commit so the NEXT transfer can skip them. Deduped chunks
        # never reach _move_chunk, so they feed neither the tuner's
        # congestion signal nor the wire metrics — by construction.
        self.dedup_index = dedup_index
        self.dedup_target = os.path.abspath(str(dedup_target)) if dedup_target else ""
        self._deduped_parts: list[tuple[int, Digest]] = []
        self._dedup_skip: set[int] = set()   # deduped plan-chunk ids
        self._deduped_chunks = 0
        self._dedup_bytes_saved = 0
        self._dedup_demoted = 0
        # zero-copy buffer pool: movers stream through granule-sized views,
        # serial verification and the integrity engine read back into
        # chunk-sized ones. Oversize requests (jumbo re-planned tails) fall
        # through to one-shot allocations inside the pool.
        if pool is None:
            buffer_bytes = max(
                self.stream_granule, min(self._chunk_bytes_now or 1, 64 * 1024 * 1024)
            )
            pool = BufferPool(
                buffer_bytes, capacity=plan.movers + integrity_workers + 2
            )
        self._pool = pool
        # pipelined state: the engine is armed per run(); movers enqueue
        # VerifyJobs, the callbacks below commit custody / quarantine.
        self._engine: IntegrityEngine | None = None
        self._queue: "queue.Queue[Chunk] | None" = None
        self._verify_refetches: dict[int, int] = {}

    @property
    def integrity_stats(self):
        """The integrity engine's counters after a pipelined ``run()`` — fused
        jobs, rows digested by the device kernel and on the host, per-job
        verifies on the device (``device_jobs``) and on the host
        (``per_job``) — or None when no engine ran."""
        return self._engine.stats if self._engine is not None else None

    # -- single chunk (one ERET/ESTO pair) --------------------------------
    def _copy_chunk(self, chunk: Chunk) -> tuple[Digest, float]:
        """One read -> fingerprint -> write pass over the chunk.

        Serial mode is the CLASSIC engine byte path, kept verbatim — whole-
        chunk ``bytes()`` read, full digest pass, write — it is the baseline
        the streaming modes are measured against. Streaming modes fingerprint
        granule-by-granule out of zero-copy views (or pooled buffers) while
        each granule is cache-hot, sharing the single pass with the
        destination write. Returns ``(source_digest, cksum_seconds)``.
        """
        if self.pipeline == "serial":
            data = self.source.read(chunk.offset, chunk.length)
            if len(data) != chunk.length:
                raise IOError(f"short read at {chunk.offset}: {len(data)}/{chunk.length}")
            # Source-side fingerprint while the data is in hand (the
            # paper's "modest cost incurred when first reading the file").
            t_ck = time.perf_counter()
            src_digest = fingerprint_bytes(data)
            cksum_s = time.perf_counter() - t_ck
            self.dest.write(chunk.offset, data)
            return src_digest, cksum_s
        # pipelined movers on view-capable sources are pure wire: the
        # integrity engine re-derives the source digest from the same view
        # off the mover path (tentpole rule: source fingerprinting runs
        # concurrently with subsequent chunk moves)
        defer_src = (
            self.pipeline == "pipelined"
            and self._engine is not None
            and hasattr(self.source, "read_view")
        )
        return stream_chunk(
            self.source, self.dest, chunk.offset, chunk.length,
            pool=self._pool, granule=self.stream_granule,
            digest=not defer_src, iov_batch=self.iov_batch,
        )

    # -- dedup negotiation (content plane) ---------------------------------
    def _negotiate_dedup(self, pending: list[Chunk]) -> list[Chunk]:
        """Probe pending chunks against the destination's chunk index and
        satisfy hits locally; returns the chunks that still need the wire.

        Runs once, before movers start. Each pending chunk's source bytes
        are fingerprinted (the source-side read the engine pays anyway for
        end-to-end integrity) and the digest probed against the index. A
        hit is satisfied WITHOUT a wire move: an alias entry (same target
        path + offset — the bytes are already in place) needs only its
        read-back verification; any other entry's backing bytes are
        re-verified, copied locally into the destination, and verified
        again after landing. Every satisfied chunk commits journal custody
        and folds into the whole-file digest chain exactly like a moved
        chunk, so the 0-escape guarantee is unconditional. A stale entry
        (missing, truncated, or rotted backing) is discarded with a
        quarantine record; if no live entry satisfies the chunk it demotes
        to a normal wire move — correctness never rests on the index.
        """
        index = self.dedup_index
        keep: list[Chunk] = []
        for c in pending:
            t_p = time.perf_counter()
            try:
                data = self.source.read(c.offset, c.length)
            except Exception:     # noqa: BLE001 — probe failure = wire move
                keep.append(c)
                continue
            if len(data) != c.length:
                keep.append(c)
                continue
            want = fingerprint_bytes(data)
            del data
            satisfied = False
            demoted_here = False
            aliased = False
            for e in index.lookup(want.hexdigest(), c.length):
                alias = bool(self.dedup_target) \
                    and os.path.abspath(e.path) == self.dedup_target \
                    and e.offset == c.offset
                backing = index.verify_entry(e)
                if backing is None:
                    # stale: drop the entry, record the event, keep
                    # probing other locations of the same content
                    index.discard(e.digest_hex, e.length, e.path, e.offset)
                    index.note_stale()
                    demoted_here = True
                    with self._lock:
                        self._quarantined.append(QuarantineRecord(
                            c.index, c.offset, c.length, 0,
                            e.digest_hex, "",
                            f"stale index entry {e.path}@{e.offset}: "
                            f"backing bytes failed re-verification",
                        ))
                    continue
                try:
                    if not alias:
                        self.dest.write(c.offset, backing)
                    back = self.dest.read_back(c.offset, c.length)
                except Exception:  # noqa: BLE001 — local copy failed
                    demoted_here = True
                    continue
                if not verify(want, fingerprint_bytes(back)):
                    # the local copy landed corrupt — wire move instead
                    demoted_here = True
                    continue
                satisfied, aliased = True, alias
                break
            now = time.perf_counter()
            if not satisfied:
                if demoted_here:
                    with self._lock:
                        self._dedup_demoted += 1
                    self._m_retry.inc(1, task=self.task, kind="dedup_demote")
                    self.tracer.add("dedup_demote", "dedup", t_p, now,
                                    task=self.task, lane="dedup",
                                    offset=c.offset, index=c.index)
                else:
                    self.tracer.add("dedup_probe", "dedup", t_p, now,
                                    task=self.task, lane="dedup",
                                    offset=c.offset, index=c.index)
                keep.append(c)
                continue
            # custody: the journal record is what makes a deduped chunk
            # indistinguishable from a moved one on restart — kill+restart
            # must never re-move it (same rule as wire custody)
            if self.journal is not None:
                self.journal.append(JournalRecord(
                    c.index, c.offset, c.length, want.hexdigest()))
            if self.dedup_target and not aliased:
                index.put(want.hexdigest(), c.length,
                          self.dedup_target, c.offset)
            self._deduped_parts.append((c.offset, want))
            self._dedup_skip.add(c.index)
            self._deduped_chunks += 1
            self._dedup_bytes_saved += c.length
            self._m_dedup.inc(1, task=self.task)
            self._m_dedup_bytes.inc(c.length, task=self.task)
            self.tracer.add("dedup_hit", "dedup", t_p, now,
                            task=self.task, lane="dedup",
                            offset=c.offset, index=c.index,
                            alias=int(aliased))
        return keep

    # -- intra-chunk striping ----------------------------------------------
    def _expand_work(self, chunks: list[Chunk]) -> list[Chunk]:
        """Split stripe-eligible chunks into stripe work items.

        Caller must hold ``self._lock`` or be single-threaded (run() setup):
        this touches the stripe registries and the stripe index allocator.
        Each stripe becomes an ordinary work item — queued, moved, retried,
        verified, and journaled exactly like a chunk — except its commit is
        routed into the parent's ``_StripeSet`` and the parent only counts
        as landed when every stripe has verified (the journal custody rule).
        """
        if self.stripes <= 1:
            return chunks
        out: list[Chunk] = []
        for c in chunks:
            sp = plan_stripes(c, self.stripes,
                              stripe_min_bytes=self.stripe_min_bytes,
                              alignment=self.alignment)
            if sp.n_stripes <= 1:
                out.append(c)
                continue
            self._striped_chunks += 1
            self._stripe_sets[c.index] = _StripeSet(parent=c, n=sp.n_stripes)
            for s in sp.stripes:
                widx = self._next_stripe_index
                self._next_stripe_index += 1
                item = Chunk(index=widx, offset=s.offset, length=s.length,
                             mover=(c.mover + s.seq) % max(1, self.plan.movers))
                self._stripe_parent[widx] = c
                out.append(item)
        return out

    def _span_extra(self, chunk: Chunk) -> dict:
        """Span kwargs tying a stripe's spans to its parent chunk's chain."""
        p = self._stripe_parent.get(chunk.index)
        return {"parent_offset": p.offset} if p is not None else {}

    def _move_chunk(self, chunk: Chunk, mover: int) -> ChunkOutcome:
        """Move one chunk with per-failure-class recovery budgets.

        * generic I/O error  -> up to ``max_retries`` in-place retries;
        * digest mismatch    -> quarantine + re-fetch from source, up to
          ``max_refetches`` times (chunk-granular corruption healing);
        * endpoint outage    -> wait out the window on its own (larger)
          budget with backoff — outages must not eat the chunk's budget;
        * mover crash        -> NOT retried here: the mover is gone, the
          exception propagates and the worker re-queues the chunk.
        """
        attempts = generic = refetches = outages = 0
        t0 = time.perf_counter()
        signal_s = 0.0    # fault-excluded work time, the autotuner's rate base:
        # generic I/O retries (loss, congestion) COUNT — they are the path
        # slowing down; corruption re-fetches and outage waits do NOT — they
        # are fault recovery and must not masquerade as congestion
        while True:
            attempts += 1
            t_att = time.perf_counter()
            try:
                if self.fault_injector is not None:
                    self.fault_injector(chunk, attempts)
                src_digest, cksum_s = self._copy_chunk(chunk)
                if self.integrity and self.pipeline == "serial":
                    # classic inline verification, kept verbatim
                    t_ck = time.perf_counter()
                    back = self.dest.read_back(chunk.offset, chunk.length)
                    dst_digest = fingerprint_bytes(back)
                    cksum_s += time.perf_counter() - t_ck
                    if not verify(src_digest, dst_digest):
                        raise _ChunkCorruption(src_digest, dst_digest)
                elif self.integrity and self.pipeline == "single_pass":
                    # inline verification through the zero-copy read-back path
                    t_ck = time.perf_counter()
                    dst_digest = read_back_fingerprint(
                        self.dest, chunk.offset, chunk.length,
                        pool=self._pool, granule=self.stream_granule)
                    cksum_s += time.perf_counter() - t_ck
                    if not verify(src_digest, dst_digest):
                        raise _ChunkCorruption(src_digest, dst_digest)
                now = time.perf_counter()
                # retroactive spans: wire = the successful attempt minus its
                # inline checksum share (placed at the attempt's tail — the
                # durations are exact, the sub-placement is synthetic)
                wire_end = max(t_att, now - cksum_s)
                lane = f"mover{mover}"
                extra = self._span_extra(chunk)
                self.tracer.add("move", "wire", t_att, wire_end,
                                task=self.task, lane=lane,
                                offset=chunk.offset, index=chunk.index,
                                attempt=attempts, **extra)
                if cksum_s > 0.0:
                    self.tracer.add("cksum_inline", "cksum", wire_end, now,
                                    task=self.task, lane=lane,
                                    offset=chunk.offset, index=chunk.index,
                                    **extra)
                self._m_wire.observe(signal_s + (now - t_att), task=self.task)
                return ChunkOutcome(
                    chunk, src_digest, attempts, mover, now - t0,
                    attempt_seconds=signal_s + (now - t_att),
                    cksum_seconds=cksum_s,
                    refetches=refetches,
                )
            except MoverCrash:
                raise
            except _ChunkCorruption as c:
                refetches += 1
                self.tracer.add("refetch", "stall", t_att,
                                time.perf_counter(), task=self.task,
                                lane=f"mover{mover}", offset=chunk.offset,
                                index=chunk.index, attempt=attempts)
                self._m_retry.inc(1, task=self.task, kind="refetch")
                with self._lock:
                    self._retries += 1
                    self._refetches += 1
                    self._quarantined.append(QuarantineRecord(
                        chunk.index, chunk.offset, chunk.length, attempts,
                        c.expected.hexdigest(), c.actual.hexdigest(), str(c),
                    ))
                if refetches > self.max_refetches:
                    raise IntegrityError(
                        f"chunk {chunk.index} digest mismatch persisted through "
                        f"{self.max_refetches} re-fetches (offset={chunk.offset}, "
                        f"len={chunk.length}): {c}"
                    ) from None
            except EndpointOutage:
                outages += 1
                with self._lock:
                    self._outage_retries_seen += 1
                self._m_retry.inc(1, task=self.task, kind="outage")
                if outages > self.outage_retries:
                    self.tracer.add("outage_wait", "stall", t_att,
                                    time.perf_counter(), task=self.task,
                                    lane=f"mover{mover}", offset=chunk.offset,
                                    index=chunk.index)
                    raise
                Backoff(self.outage_backoff_s, mode="linear",
                        lane=f"{self.task}:mover{mover}:{chunk.index}",
                        ).sleep(outages)
                # the rejected op plus its backoff is fault recovery, not
                # congestion — same exclusion rule as the tuner's rate signal
                self.tracer.add("outage_wait", "stall", t_att,
                                time.perf_counter(), task=self.task,
                                lane=f"mover{mover}", offset=chunk.offset,
                                index=chunk.index)
            except Exception:
                generic += 1
                now = time.perf_counter()
                signal_s += now - t_att   # congestion-like
                # a generic-I/O retry IS the path slowing down: its time is
                # wire, not stall (mirrors the tuner's congestion signal)
                self.tracer.add("move_retry", "wire", t_att, now,
                                task=self.task, lane=f"mover{mover}",
                                offset=chunk.offset, index=chunk.index,
                                attempt=attempts)
                self._m_retry.inc(1, task=self.task, kind="generic")
                if generic > self.max_retries:
                    raise
                with self._lock:
                    self._retries += 1

    def _enqueue(self, q: "queue.Queue[Chunk]", chunk: Chunk) -> None:
        """Queue a chunk, timestamping it so pickup emits a queue-wait span."""
        self._enq_t[chunk.index] = time.perf_counter()
        q.put(chunk)

    # -- worker loop: pull-from-queue == work stealing ---------------------
    def _worker(self, mover: int, q: "queue.Queue[Chunk]") -> None:
        try:
            while True:
                with self._lock:
                    if self._errors or len(self._outcomes) >= self._target:
                        return
                try:
                    chunk = q.get(timeout=0.02)
                except queue.Empty:
                    continue           # in-flight chunks may still re-queue
                with self._lock:
                    if chunk.index in self._outcomes:   # speculated twin landed
                        continue
                enq = self._enq_t.get(chunk.index)
                if enq is not None:
                    self.tracer.add("queue_wait", "queue", enq,
                                    time.perf_counter(), task=self.task,
                                    lane=f"mover{mover}", offset=chunk.offset,
                                    index=chunk.index,
                                    **self._span_extra(chunk))
                try:
                    out = self._move_chunk(chunk, mover)
                except MoverCrash:
                    # the mover dies; the chunk survives it (re-queued for
                    # whoever is left — or for a respawn if nobody is)
                    with self._lock:
                        self._mover_deaths += 1
                        over = self._mover_deaths > self._death_budget
                        if over:
                            self._errors.append(RuntimeError(
                                f"mover-death budget exhausted "
                                f"({self._mover_deaths} > {self._death_budget})"
                            ))
                    if not over:
                        self._enqueue(q, chunk)
                    return
                except BaseException as e:  # noqa: BLE001 — propagated to caller
                    with self._lock:
                        self._errors.append(e)
                    return
                if self._engine is not None:
                    # pipelined: the move landed; hand verification to the
                    # integrity engine and pull the next chunk NOW. Custody
                    # (outcome + journal) commits in _on_verified only; a
                    # corrupt landing re-queues the chunk in _on_corrupt.
                    self._engine.submit(VerifyJob(
                        key=chunk, offset=chunk.offset, length=chunk.length,
                        expected=out.digest, dest=self.dest,
                        enqueued_s=time.perf_counter(), payload=out,
                        source=self.source if out.digest is None else None,
                    ))
                    continue
                if not self._commit_outcome(chunk, out, q):
                    return
        finally:
            with self._cond:
                self._live_workers -= 1
                self._cond.notify_all()    # wake the supervisor on death/error

    # -- custody commit (serial workers AND integrity-engine callbacks) ----
    def _commit_outcome(self, chunk: Chunk, out: ChunkOutcome,
                        q: "queue.Queue[Chunk]") -> bool:
        """Record one verified chunk: outcome map, journal custody, tuner
        feed. Returns False when a hard error was recorded instead."""
        with self._lock:
            first = chunk.index not in self._outcomes
            if first:
                self._outcomes[chunk.index] = out
                if len(self._outcomes) >= self._target:
                    self._cond.notify_all()
        if first and self.journal is not None:
            t_j = time.perf_counter()
            try:
                self.journal.append(
                    JournalRecord(chunk.index, chunk.offset, chunk.length,
                                  out.digest.hexdigest())
                )
            except Exception as e:  # noqa: BLE001 — dead journal:
                with self._lock:    # fail fast, don't churn movers
                    self._errors.append(RuntimeError(
                        f"journal append failed for chunk {chunk.index}: {e}"
                    ))
                    self._cond.notify_all()
                return False
            # the journal fsync is a real per-chunk control-plane
            # cost: the tuner must see it, or it will shrink chunks
            # into a journal-bound regime on slow filesystems
            j_secs = time.perf_counter() - t_j
            out.seconds += j_secs
            out.attempt_seconds += j_secs
            self.tracer.add("journal_append", "journal", t_j, t_j + j_secs,
                            task=self.task, lane="journal",
                            offset=chunk.offset, index=chunk.index)
        if first:
            self._m_chunks.inc(1, task=self.task, pipeline=self.pipeline)
            self._m_bytes.inc(chunk.length, task=self.task,
                              pipeline=self.pipeline)
            # index population: a verified, journaled chunk is exactly what
            # a future transfer may dedup against (stripes index at the
            # parent level in _finish_stripe — probe keys are chunk-sized)
            if (self.dedup_index is not None and self.dedup_target
                    and chunk.index not in self._stripe_parent):
                try:
                    self.dedup_index.put(out.digest.hexdigest(), chunk.length,
                                         self.dedup_target, chunk.offset)
                except Exception:  # noqa: BLE001 — cache: failed put = miss
                    pass
        if not first:
            return True
        parent = self._stripe_parent.get(chunk.index)
        if parent is not None:
            # a stripe's journal record is its own custody; the parent-level
            # commit (tuner feed, stripe_commit mark) waits for the full set
            return self._finish_stripe(parent, chunk, out, q)
        return self._feed_tuner(out, q, chunk.index)

    def _finish_stripe(self, parent: Chunk, chunk: Chunk, out: ChunkOutcome,
                       q: "queue.Queue[Chunk]") -> bool:
        """Fold one verified stripe into its parent's stripe set; on the last
        stripe, derive the parent chunk digest via the merge law and feed the
        tuner ONE aggregated outcome (per-stripe samples would look like
        tiny chunks and drag the controller toward the floor)."""
        with self._lock:
            st = self._stripe_sets[parent.index]
            st.digests[chunk.offset] = out.digest
            st.attempts += out.attempts
            st.refetches += out.refetches
            st.seconds += out.seconds
            st.attempt_seconds += out.attempt_seconds
            st.cksum_seconds += out.cksum_seconds
            st.cksum_lag_s = max(st.cksum_lag_s, out.cksum_lag_s)
            done = len(st.digests) == st.n
        if not done:
            return True
        # partition refinement: stripe digests in offset order ARE the chunk
        # digest — no extra hashing pass over the parent's bytes
        digest = merge_all(d for _, d in sorted(st.digests.items()))
        self.tracer.mark("stripe_commit", "journal", task=self.task,
                         offset=parent.offset, index=parent.index,
                         stripes=st.n)
        if self.dedup_index is not None and self.dedup_target:
            try:
                self.dedup_index.put(digest.hexdigest(), parent.length,
                                     self.dedup_target, parent.offset)
            except Exception:  # noqa: BLE001 — cache: failed put = miss
                pass
        parent_out = ChunkOutcome(
            parent, digest, st.attempts, -1, st.seconds,
            attempt_seconds=st.attempt_seconds,
            cksum_seconds=st.cksum_seconds,
            cksum_lag_s=st.cksum_lag_s,
            refetches=st.refetches,
        )
        return self._feed_tuner(parent_out, q, parent.index)

    def _feed_tuner(self, out: ChunkOutcome, q: "queue.Queue[Chunk]",
                    idx: int) -> bool:
        """Feed one landed-chunk sample to the controller and act on its
        chunk-size / stripe-count targets. Returns False on controller error."""
        if self.tuner is None:
            return True
        try:
            with self._tune_lock:
                new = self.tuner.observe_outcome(out)
                stripe_changed = False
                ns = getattr(self.tuner, "target_stripes", None)
                if callable(ns):
                    want = int(ns())
                    if want >= 1 and want != self.stripes:
                        with self._lock:
                            self.stripes = want
                            self._stripe_replans += 1
                        self.tracer.mark("stripe_replan", "plan",
                                         task=self.task, stripes=want)
                        stripe_changed = True
                if new is not None and new != self._chunk_bytes_now:
                    self._replan_queued(q, new)
                elif stripe_changed:
                    # a stripe-count change alone must also re-expand the
                    # un-started tail: the new fan-out takes effect now, not
                    # at the next chunk-size replan (which may never come
                    # when the size is pinned at a bound)
                    self._replan_queued(q, self._chunk_bytes_now)
        except Exception as e:  # noqa: BLE001 — controller bug
            with self._lock:    # must fail the transfer, not hang it
                self._errors.append(RuntimeError(
                    f"autotuner failed after chunk {idx}: {e}"
                ))
                self._cond.notify_all()
            return False
        return True

    # -- integrity-engine callbacks (pipelined mode, verifier threads) -----
    def _on_verified(self, job: VerifyJob, lag_s: float, ck_s: float) -> None:
        del ck_s          # verify work is off the mover path; lag carries it
        chunk: Chunk = job.key
        out: ChunkOutcome = job.payload
        out.cksum_lag_s = lag_s
        if out.digest is None:
            out.digest = job.expected      # deferred source fingerprint
        with self._lock:
            out.refetches += self._verify_refetches.get(chunk.index, 0)
        self._commit_outcome(chunk, out, self._queue)

    def _on_corrupt(self, job: VerifyJob, actual: Digest, lag_s: float) -> None:
        """A lagging verifier caught a corrupt landing: quarantine the chunk
        and re-queue it for a source re-fetch (same budget as inline)."""
        del lag_s
        chunk: Chunk = job.key
        out: ChunkOutcome = job.payload
        detail = describe_mismatch(job.expected, actual)
        with self._lock:
            self._retries += 1
            self._refetches += 1
            n = self._verify_refetches.get(chunk.index, 0) + 1
            self._verify_refetches[chunk.index] = n
            self._quarantined.append(QuarantineRecord(
                chunk.index, chunk.offset, chunk.length, out.attempts,
                job.expected.hexdigest(), actual.hexdigest(), detail,
            ))
            over = n > self.max_refetches
            if over:
                self._errors.append(IntegrityError(
                    f"chunk {chunk.index} digest mismatch persisted through "
                    f"{self.max_refetches} re-fetches (offset={chunk.offset}, "
                    f"len={chunk.length}): {detail}"
                ))
                self._cond.notify_all()
        if not over:
            # re-move from source (quarantine heal)
            self._enqueue(self._queue, chunk)

    def _on_verify_error(self, job: VerifyJob, exc: BaseException) -> None:
        chunk: Chunk = job.key
        with self._lock:
            self._errors.append(RuntimeError(
                f"deferred verification read-back failed for chunk "
                f"{chunk.index} (offset={chunk.offset}): {exc}"
            ))
            self._cond.notify_all()

    # -- mid-flight tail re-planning (the autotuner's actuator) ------------
    def _replan_queued(self, q: "queue.Queue[Chunk]", new_bytes: int) -> int:
        """Re-partition the un-started tail at ``new_bytes`` nominal size.

        Only chunks still sitting in the queue — never started, never
        journaled — are re-cut. Journaled custody and in-flight chunks keep
        their exact boundaries, so partition refinement keeps the merge-law
        digest chain composable: the final (offset, digest) parts still tile
        the file exactly. Returns the number of chunks re-planned away.
        """
        drained: list[Chunk] = []
        while True:
            try:
                drained.append(q.get_nowait())
            except queue.Empty:
                break
        # stripe work items keep their boundaries: their parent's _StripeSet
        # is already sized, and a journaled sibling pins the partition — only
        # whole un-started plain chunks are re-cuttable
        kept = [c for c in drained if c.index >= STRIPE_INDEX_BASE]
        plain = [c for c in drained if c.index < STRIPE_INDEX_BASE]
        if not plain:
            for c in kept:
                self._enqueue(q, c)
            return 0
        regions = merge_regions([(c.offset, c.length) for c in plain])
        with self._lock:
            fresh = partition_regions(
                regions, new_bytes, start_index=self._next_index,
                movers=self.plan.movers, alignment=self.alignment,
            )
            self._next_index += len(fresh)
            fresh = self._expand_work(fresh)
            self._target += len(fresh) - len(plain)
            if max(self.alignment, int(new_bytes)) != self._chunk_bytes_now:
                self._replans += 1      # stripe-only re-expansions don't count
            self._chunk_bytes_now = max(self.alignment, int(new_bytes))
        self.tracer.mark("replan", "plan", task=self.task,
                         chunk_bytes=int(new_bytes), recut=len(fresh))
        for c in kept:
            self._enqueue(q, c)
        for c in fresh:
            self._enqueue(q, c)
        return len(plain)

    def run(self) -> TransferReport:
        t0 = time.perf_counter()
        recs: dict[int, JournalRecord] = (
            dict(self.journal.records) if self.journal is not None else {}
        )
        resumed_parts = [(r.offset, r.digest()) for r in recs.values()]
        # Static resume: every journaled record matches its plan chunk
        # byte-for-byte (the untuned engine's invariant — preserved exactly).
        # A journal written by a re-planned incarnation has records at other
        # boundaries; then resume is region-based: journaled custody regions
        # are subtracted from the file and fresh chunks (fresh indices, no id
        # collisions) are carved out of the gaps — a journaled chunk can
        # never be re-moved because its bytes are not in any gap.
        static_resume = all(
            idx < self.plan.n_chunks
            and self.plan.chunks[idx].offset == r.offset
            and self.plan.chunks[idx].length == r.length
            for idx, r in recs.items()
        )
        if static_resume:
            pending = [c for c in self.plan.chunks if c.index not in recs]
        else:
            gaps = subtract_regions(
                self.plan.total_bytes, [(r.offset, r.length) for r in recs.values()]
            )
            # the plain-index allocator must not absorb stripe-band ids: a
            # max() over a journal holding stripe records would catapult it
            # into the stripe band and collide with fresh stripe items
            self._next_index = max(
                max((i for i in recs if i < STRIPE_INDEX_BASE), default=-1) + 1,
                self.plan.n_chunks,
            )
            pending = partition_regions(
                gaps, self._chunk_bytes_now, start_index=self._next_index,
                movers=self.plan.movers, alignment=self.alignment,
            )
            self._next_index += len(pending)
        # stripe ids of a crashed striped incarnation are journal keys too:
        # resume the stripe allocator past them or the journal dict would
        # overwrite old custody records on the next crash
        self._next_stripe_index = max(
            self._next_stripe_index,
            max((i + 1 for i in recs if i >= STRIPE_INDEX_BASE),
                default=STRIPE_INDEX_BASE),
        )
        # content plane: satisfy index hits locally before any mover starts
        # (deduped chunks journal custody and leave pending entirely)
        if self.dedup_index is not None and pending:
            pending = self._negotiate_dedup(pending)
        pending = self._expand_work(pending)
        q: "queue.Queue[Chunk]" = queue.Queue()
        for c in pending:
            self._enqueue(q, c)
        self._target = len(pending)
        self._queue = q
        if self.pipeline == "pipelined" and self.integrity and pending:
            self._engine = IntegrityEngine(
                workers=self.integrity_workers, pool=self._pool,
                on_verified=self._on_verified, on_corrupt=self._on_corrupt,
                on_error=self._on_verify_error,
                tracer=self.tracer, task=self.task, device=self.device,
            )
        # warm start: a SimTuner-seeded controller may already disagree with
        # the static plan — re-cut the whole tail before the first byte moves
        if self.tuner is not None and pending:
            tgt = int(self.tuner.target())
            if tgt > 0 and tgt != self._chunk_bytes_now:
                self._replan_queued(q, tgt)
        n_pending = self._target

        movers = max(1, min(self.plan.movers, n_pending)) if n_pending else 0
        if self.max_mover_deaths is not None:
            self._death_budget = self.max_mover_deaths
        else:
            self._death_budget = 4 * movers + 4
        threads: list[threading.Thread] = []

        def spawn(mover_id: int) -> None:
            with self._lock:
                self._live_workers += 1
            th = threading.Thread(target=self._worker, args=(mover_id, q), daemon=True)
            threads.append(th)
            th.start()

        for m in range(movers):
            spawn(m)
        # Straggler mitigation: when the queue drains, re-enqueue the oldest
        # in-flight chunks so idle movers can duplicate them (first write wins
        # — writes are idempotent on disjoint ranges). Only meaningful for
        # static plans: a region-resumed tail has fresh indices the static
        # plan does not know about (and tuner+speculation is rejected above).
        if self.speculative_factor > 0 and pending and static_resume:
            watcher = threading.Thread(
                target=self._speculate,
                args=(q, movers, set(recs) | self._dedup_skip), daemon=True
            )
            watcher.start()
        # Supervise: the transfer outlives its movers. If every worker died
        # (MoverCrash) with work outstanding, spawn a replacement. Sleeps on
        # the condition workers signal at completion, error, and death — no
        # busy-polling in the fault-free path.
        next_mover = movers
        while n_pending:
            with self._cond:
                if self._errors or len(self._outcomes) >= self._target:
                    break
                if self._live_workers > 0:
                    self._cond.wait(0.1)
                    continue
            spawn(next_mover)
            next_mover += 1
        for th in threads:
            th.join()
        if self._engine is not None:
            # fault-free exits leave an empty digest queue (movers only stop
            # once every outcome landed); on error, let queued jobs get their
            # verdicts — their quarantine records are part of the story
            self._engine.close(abandon=False)
        # the root span carries the makespan (obs.attr's default window) and
        # is emitted on the error path too — post-mortem traces need it most
        self.tracer.add("transfer", "task", t0, time.perf_counter(),
                        task=self.task, lane="", pipeline=self.pipeline,
                        bytes=self.plan.total_bytes)
        if self._errors:
            raise self._errors[0]

        # merge-law combine over whatever boundaries actually landed: chunk
        # sets from re-planned incarnations tile the file just as well as the
        # original plan (partition refinement keeps digests composable)
        parts = [(out.chunk.offset, out.digest) for out in self._outcomes.values()]
        parts += resumed_parts
        parts += self._deduped_parts
        file_digest = combine_at_offsets(parts, self.plan.total_bytes)
        return TransferReport(
            total_bytes=self.plan.total_bytes,
            file_digest=file_digest,
            outcomes=self._outcomes,
            seconds=time.perf_counter() - t0,
            retries=self._retries,
            skipped_chunks=len(recs),
            speculated=self._speculated,
            refetches=self._refetches,
            mover_deaths=self._mover_deaths,
            outage_retries=self._outage_retries_seen,
            quarantined=tuple(self._quarantined),
            replans=self._replans,
            chunk_bytes_final=self._chunk_bytes_now,
            pipeline=self.pipeline,
            cksum_lag_s=sum(o.cksum_lag_s for o in self._outcomes.values()),
            stripes=self.stripes,
            striped_chunks=self._striped_chunks,
            stripe_replans=self._stripe_replans,
            deduped_chunks=self._deduped_chunks,
            dedup_bytes_saved=self._dedup_bytes_saved,
            dedup_demoted=self._dedup_demoted,
        )

    def _speculate(self, q: "queue.Queue[Chunk]", movers: int, skip: set[int]) -> None:
        # NOTE: journaled chunks (``skip``) must never be duplicated — a
        # speculated twin of an already-landed chunk would re-move journaled
        # bytes, the exact thing partial restart exists to avoid.
        target = self._target
        while True:
            time.sleep(0.005)
            with self._lock:
                done = len(self._outcomes)
                if done >= target or self._errors:
                    return
                if q.qsize() <= movers and target - done <= movers:
                    missing = [c for c in self.plan.chunks
                               if c.index not in self._outcomes and c.index not in skip]
                    for c in missing[: movers]:
                        self._enqueue(q, c)
                        self._speculated += 1
                    return


def transfer_verified(
    source: ByteSource,
    dest: ByteDest,
    plan: ChunkPlan,
    expected: Digest | None = None,
    **kw,
) -> TransferReport:
    """One-shot helper: run the transfer; optionally check the end-to-end digest."""
    report = ChunkedTransfer(source, dest, plan, **kw).run()
    if expected is not None and not verify(expected, report.file_digest):
        raise IntegrityError(
            f"end-to-end digest mismatch: expected {expected.hexdigest()}, "
            f"got {report.file_digest.hexdigest()}"
        )
    return report
