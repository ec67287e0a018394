"""The multi-tenant asynchronous transfer-task service.

This is the service layer the paper's client-driven chunking lives inside of:
clients *submit* transfer tasks and walk away; the service batches, schedules,
monitors, retries, integrity-checks and journals them across tenants.

Architecture (one TransferService per service root):

  * submit() batches requests into tasks (service.batcher), persists them to
    the TaskStore and returns task ids immediately;
  * one scheduler thread activates PENDING tasks under the global
    concurrent-task cap with tenant-fair selection (service.scheduler), and
    reallocates the global mover budget across ACTIVE tasks with the
    chunk-aware marginal-benefit policy whenever the active set changes;
  * each ACTIVE task runs a _TaskRunner thread owning a work queue of chunks
    (natural work stealing) and a dynamic pool of mover threads sized by the
    current allocation; chunk moves are fingerprinted, verified by dest
    read-back, retried with exponential backoff, and journaled;
  * a crash (or kill()) loses nothing: on construction the service replays the
    task log, re-queues durable non-terminal tasks, and their journals make
    the runners skip every chunk that already landed.

Client API: submit / submit_many / submit_buffers / status / status_many /
tasks (cursor-paginated) / wait / wait_all / cancel / pause / resume /
subscribe (cursor-resumable) / events_from / flush / close / kill.

This is the port's copy of ``repro.service.service``. It differs in two
places. ``TransferService(device=...)`` resolves the device once, at
construction (``"cuda"``, the default, raises where there is no card;
``"cpu"`` runs the kernels' plain versions), and every digest the service
takes runs there: each pipelined task's integrity engine, the serial and
single-pass movers' source and read-back digests, the pipelined movers'
streaming source digest, the dedup probes, the content index's entry
checks and the scrubber — the reference takes all of them on the host.
And ``integrity_stats(task_id)`` reads a pipelined task's engine counters
after the task.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import queue
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core.backoff import Backoff
from repro_torch.core.chunker import (
    Chunk,
    ChunkPlan,
    MiB,
    merge_regions,
    partition_regions,
    plan_chunks,
    plan_stripes,
    subtract_regions,
)
from repro_torch.core.integrity import (
    EMPTY_DIGEST,
    combine_at_offsets,
    verify,
)
from repro_torch.core.dataplane import (
    DEFAULT_STREAM_GRANULE,
    BufferPool,
    IntegrityEngine,
    IntegrityStats,
    VerifyJob,
    fingerprint_on_device,
    resolve_device,
    stream_chunk,
)
from repro_torch.cas import ChunkIndex
from repro_torch.resil.scrub import Scrubber, ScrubReport, ScrubTarget
from repro_torch.core.journal import ChunkJournal, JournalRecord
from repro_torch.core.scheduler import TransferRequest
from repro_torch.obs import metrics as obsmetrics
from repro_torch.obs.clock import mono_s, wall_s
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import Tracer
from repro_torch.core.simulator import ALCF, DEFAULT_LINK, NERSC, LinkConfig, SiteConfig
from repro_torch.core.transfer import (
    BufferSource,
    ByteDest,
    ByteSource,
    EndpointOutage,
    FileDest,
    FileSource,
    IntegrityError,
    MoverCrash,
)
from repro_torch.service import events as ev
from repro_torch.service.batcher import BatchConfig, Batcher
from repro_torch.service.events import EventBus
from repro_torch.service.scheduler import (
    DEFAULT_QUOTA,
    ActivationIndex,
    AllocationEngine,
    TenantQuota,
)
from repro_torch.service import task as tk
from repro_torch.service.store import TaskStore
from repro_torch.service.task import (
    FaultReport,
    ItemReport,
    TaskSpec,
    TaskStatus,
    TransferItem,
    TransitionError,
    classify_fault,
)
from repro_torch.tune.controller import ChunkController
from repro_torch.tune.probe import ChunkSample
from repro_torch.tune.simtune import SimTuner

# Journal ids for re-planned (tuned) chunks live in a reserved band far above
# any static plan's ids, partitioned per item, so a record always names its
# item and can never collide with a static chunk id across restarts.
TUNE_GID_BASE = 1 << 40
TUNE_ITEM_STRIDE = 1 << 28

# Stripe work items get their own band ABOVE the tuned band (the band test in
# item_of_gidx must check this one first): each stripe is journaled as its own
# custody record, so a restart re-moves only the stripes that never verified.
STRIPE_GID_BASE = 1 << 50
STRIPE_ITEM_STRIDE = 1 << 28


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    mover_budget: int = 8            # global mover threads across tasks
    max_concurrent_tasks: int = 4    # ACTIVE task cap (<= mover_budget)
    policy: str = "marginal"         # fair | file_bound | marginal
    chunk_bytes: int = 8 * MiB       # default chunk size for task items
    integrity: bool = True           # dest read-back verification per chunk
    max_retries: int = 3             # per-chunk generic-I/O retries
    max_refetches: int = 3           # per-chunk source re-reads on digest mismatch
    outage_retries: int = 64         # per-chunk endpoint-outage budget
    max_mover_deaths: int = 16       # per-task mover-crash budget
    retry_backoff_s: float = 0.01    # exponential backoff base
    tick_s: float = 0.005            # scheduler/runner poll period
    batch: BatchConfig = dataclasses.field(default_factory=BatchConfig)
    quotas: dict[str, TenantQuota] = dataclasses.field(default_factory=dict)
    default_quota: TenantQuota = DEFAULT_QUOTA
    src_site: SiteConfig = ALCF      # cost-model endpoints for allocation
    dst_site: SiteConfig = NERSC
    link: LinkConfig = DEFAULT_LINK
    alloc_step: int = 2              # water-filling granularity
    # ---- autotuning (closed-loop chunk sizing) ---------------------------
    tuning: str = "static"           # default per-task policy: static | auto
    tune_min_chunk: int = 64 * 1024  # controller lower bound for tuned tasks
    tune_max_chunk: int = 64 * MiB   # controller upper bound for tuned tasks
    tune_epoch_chunks: int = 4       # chunks per controller decision epoch
    tune_seed: str = "none"          # "sim" warm-starts from the simulator
    # ---- data plane (zero-copy pipelined movement + integrity) -----------
    pipeline: str = "serial"         # serial | single_pass | pipelined
    integrity_workers: int = 2       # per-task checksum workers (pipelined)
    stream_granule: int = DEFAULT_STREAM_GRANULE
    # ---- intra-chunk striping (concurrent sub-streams per large chunk) ---
    stripes: int = 1                 # stripe count per eligible chunk
    stripe_min_bytes: int = 4 * MiB  # smallest stripe worth its overhead
    # ---- content plane (dedup against the endpoint chunk index) ----------
    dedup: str = "off"               # default per-task policy: off | on
    # ---- resilience plane (route failover by route-aware layers) ---------
    failover: str = "off"            # default per-task policy: off | auto

    def __post_init__(self):
        if self.max_concurrent_tasks > self.mover_budget:
            raise ValueError(
                f"max_concurrent_tasks ({self.max_concurrent_tasks}) must be "
                f"<= mover_budget ({self.mover_budget}): every active task "
                "needs at least one mover"
            )
        if self.tuning not in ("static", "auto"):
            raise ValueError(f"tuning must be 'static' or 'auto', got {self.tuning!r}")
        if self.tune_seed not in ("none", "sim"):
            raise ValueError(f"tune_seed must be 'none' or 'sim', got {self.tune_seed!r}")
        if self.pipeline not in ("serial", "single_pass", "pipelined"):
            raise ValueError(
                f"pipeline must be 'serial', 'single_pass' or 'pipelined', "
                f"got {self.pipeline!r}"
            )
        if self.integrity_workers < 1:
            raise ValueError("integrity_workers must be >= 1")
        if self.stripes < 1:
            raise ValueError(f"stripes must be >= 1, got {self.stripes}")
        if self.stripe_min_bytes < 1:
            raise ValueError(
                f"stripe_min_bytes must be >= 1, got {self.stripe_min_bytes}")
        if self.dedup not in ("off", "on"):
            raise ValueError(f"dedup must be 'off' or 'on', got {self.dedup!r}")
        if self.failover not in ("off", "auto"):
            raise ValueError(
                f"failover must be 'off' or 'auto', got {self.failover!r}")


class _Task:
    """Service-internal mutable task state (specs stay frozen)."""

    def __init__(self, spec: TaskSpec, seq: int, chunk_bytes: int,
                 tuning: str = "static", dedup: str = "off"):
        self.spec = spec
        self.seq = seq
        self.tuning = tuning                     # effective policy (spec or default)
        self.dedup = dedup                       # content-plane policy (spec or default)
        self.failovers = 0                       # route re-plans recorded
        self.scrub_repairs = 0                   # scrub heals on landed regions
        self.chunks_deduped = 0
        self.wire_bytes_saved = 0
        self.dedup_demoted = 0
        self.controller: ChunkController | None = None
        self.replans = 0
        self.chunk_bytes_now = spec.chunk_bytes or chunk_bytes
        # per-item sequence allocators for tuned-band / stripe-band journal ids
        self.next_tune_seq = [0] * len(spec.items)
        self.next_stripe_seq = [0] * len(spec.items)
        self.striped_chunks = 0
        self.state = tk.PENDING
        self.error: str | None = None
        self.lock = threading.Lock()
        # observability: per-worker lane ids, queue-entry timestamps (queue-
        # wait spans), the task's monotonic activation mark and root span id
        self.worker_seq = 0
        self.enq_t: dict[int, float] = {}
        self.t0_mono: float | None = None
        self.root_sid = 0
        self.pause_evt = threading.Event()
        self.cancel_evt = threading.Event()
        self.target_movers = 1
        self.n_workers = 0
        self.failed_error: str | None = None
        self.fault: FaultReport | None = None
        self.started_s: float | None = None
        self.finished_s: float | None = None
        self.retries = 0
        self.refetches = 0
        self.outages = 0
        self.mover_deaths = 0
        self.resumed_chunks = 0
        self.item_reports: tuple[ItemReport, ...] = ()
        # data-plane accounting + pipelined-verification state
        self.cksum_s = 0.0
        self.cksum_lag_s = 0.0
        self.pool: BufferPool | None = None
        self.engine: IntegrityEngine | None = None
        self.verify_refetches: dict[int, int] = {}   # per-gidx deferred heals

        # Deterministic chunk plans (same across service incarnations): the
        # journal's global chunk ids must mean the same byte ranges forever.
        self.plans: list[ChunkPlan] = []
        self.chunk_base: list[int] = []
        base = 0
        for it in spec.items:
            plan = (
                plan_chunks(
                    it.nbytes, 1, chunk_bytes=spec.chunk_bytes or chunk_bytes,
                    min_chunk=1, max_chunk=1 << 62, alignment=1,
                )
                if it.nbytes
                else plan_chunks(0, 1)
            )
            self.plans.append(plan)
            self.chunk_base.append(base)
            base += plan.n_chunks
        self.chunks_total = base
        self.chunks_done = 0
        self.bytes_total = spec.total_bytes
        self.bytes_done = 0

        # lazily-opened per-item endpoints (shared by this task's movers)
        self._sources: dict[int, ByteSource] = {}
        self._dests: dict[int, ByteDest] = {}

    # -- journal-id bands ---------------------------------------------------
    def item_of_gidx(self, gidx: int) -> int:
        """Which item a journaled chunk id belongs to (any band). The stripe
        band sits ABOVE the tuned band, so it must be tested first — the
        tune-band test alone would assign a stripe gid a nonsense item."""
        if gidx >= STRIPE_GID_BASE:
            return (gidx - STRIPE_GID_BASE) // STRIPE_ITEM_STRIDE
        if gidx >= TUNE_GID_BASE:
            return (gidx - TUNE_GID_BASE) // TUNE_ITEM_STRIDE
        for i in reversed(range(len(self.chunk_base))):
            if gidx >= self.chunk_base[i]:
                return i
        return 0

    def tune_gidx(self, item_idx: int, seq: int) -> int:
        return TUNE_GID_BASE + item_idx * TUNE_ITEM_STRIDE + seq

    def stripe_gidx(self, item_idx: int, seq: int) -> int:
        return STRIPE_GID_BASE + item_idx * STRIPE_ITEM_STRIDE + seq

    def static_record_ok(self, gidx: int, rec) -> bool:
        """Does this journal record match the static plan byte-for-byte?"""
        if gidx >= TUNE_GID_BASE:
            return False
        i = self.item_of_gidx(gidx)
        local = gidx - self.chunk_base[i]
        if not (0 <= local < self.plans[i].n_chunks):
            return False
        c = self.plans[i].chunks[local]
        return c.offset == rec.offset and c.length == rec.length


class TransferService:
    """Multi-tenant async task manager over the chunked-transfer engine."""

    def __init__(
        self,
        root: str | os.PathLike,
        config: ServiceConfig | None = None,
        *,
        fault_injector: Callable[[str, int, Any, int], None] | None = None,
        source_wrapper: Callable[[str, int, ByteSource], ByteSource] | None = None,
        dest_wrapper: Callable[[str, int, ByteDest], ByteDest] | None = None,
        tracer: Tracer | None = None,
        device="cuda",
    ):
        # resolved once, here: a missing card fails the constructor, not
        # each task's runner thread one by one
        self.device = resolve_device(device)
        self.config = config or ServiceConfig()
        self.store = TaskStore(root)
        # event spill log beside the task shards: cursor subscribers can
        # resume from any seq, and numbering survives restarts
        self.events = EventBus(
            spill_path=os.path.join(str(root), "events.log"))
        # observability: a bounded span tracer, a flight recorder fed from
        # the event stream (auto-dumps a post-mortem bundle next to the task
        # log when a fault fails a task), and per-task metric families
        self.tracer = tracer if tracer is not None else Tracer()
        self.recorder = FlightRecorder(
            tracer=self.tracer,
            dump_dir=os.path.join(str(root), "flight"))
        self.events.subscribe(
            lambda e: self.recorder.record(
                e.task_id, e.kind, e.payload, t=e.time_s))
        self._m_chunks = obsmetrics.REGISTRY.counter(
            "service_chunks_total", "landed chunks", ("tenant", "task"))
        self._m_bytes = obsmetrics.REGISTRY.counter(
            "service_bytes_total", "landed bytes", ("tenant", "task"))
        self._m_faults = obsmetrics.REGISTRY.counter(
            "service_faults_total", "chunk-level fault observations",
            ("tenant", "task", "kind"))
        self._m_wire = obsmetrics.REGISTRY.histogram(
            "service_chunk_wire_seconds",
            "fault-excluded per-chunk mover time", ("task",), scale=1e-4)
        self._m_active = obsmetrics.REGISTRY.gauge(
            "service_active_tasks", "tasks in ACTIVE state", ("tenant",))
        self._m_failovers = obsmetrics.REGISTRY.counter(
            "service_failovers_total",
            "route failovers recorded against tasks", ("tenant", "task"))
        self._m_scrub_repairs = obsmetrics.REGISTRY.counter(
            "service_scrub_repairs_total",
            "landed regions the scrubber healed", ("tenant", "task"))
        self.batcher = Batcher(self.config.batch)
        self.engine = AllocationEngine(
            policy=self.config.policy,
            mover_budget=self.config.mover_budget,
            src=self.config.src_site,
            dst=self.config.dst_site,
            link=self.config.link,
            step=self.config.alloc_step,
            quotas=self.config.quotas,
            default_quota=self.config.default_quota,
        )
        self._fault_injector = fault_injector
        # chaos hooks: wrap the per-item endpoints ((task_id, item_idx,
        # endpoint) -> endpoint) so fault campaigns can corrupt/outage/kill
        # the data path without the service knowing
        self._source_wrapper = source_wrapper
        self._dest_wrapper = dest_wrapper
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._tasks: dict[str, _Task] = {}
        self._mem_sources: dict[tuple[str, int], ByteSource] = {}
        self._runners: dict[str, threading.Thread] = {}
        self._stop_evt = threading.Event()
        self._kill_evt = threading.Event()
        self._alloc_dirty = True
        self._served: dict[str, int] = {}    # per-tenant activation history
        # control-plane indexes — scheduler and listing cost must not scale
        # with the total task count:
        #   _order / _order_pos: submission-ordered ids for cursor pagination
        #   _active_ids: the ACTIVE set (allocation requests are O(active))
        #   _activation: heap-indexed PENDING queues (O(log n) activation)
        self._order: list[str] = []
        self._order_pos: dict[str, int] = {}
        self._active_ids: set[str] = set()
        self._activation = ActivationIndex(served=self._served)
        # wall time of recent scheduler passes (activation + request build
        # + allocation), for the cycle-time flatness gate in service_load
        self.sched_cycles: collections.deque[float] = collections.deque(maxlen=512)
        self.moved_chunks = 0        # chunks physically moved by THIS incarnation
        # content plane: the service root's endpoint chunk index, opened
        # lazily (first dedup-enabled task) or eagerly when the configured
        # default is "on" — non-dedup services never pay index appends
        self.cas: ChunkIndex | None = None
        if self.config.dedup == "on":
            self.cas_index()
        # resilience plane: one scrubber per service so its round-robin
        # cursor persists across scrub() calls (budgeted cadence resumes
        # where the last pass stopped instead of re-reading the same head)
        self._scrubber: Scrubber | None = None

        self._recover()
        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="transferd-sched", daemon=True
        )
        self._scheduler.start()

    # ------------------------------------------------------------------
    # content plane
    # ------------------------------------------------------------------
    def cas_index(self) -> ChunkIndex:
        """This service root's endpoint chunk index (lazily opened).

        Lives at ``<root>/cas/index.log`` — a self-checksummed append log
        with torn-tail repair and compaction, surviving service restarts the
        same way journals do. Populated as verified chunks commit; probed by
        dedup-enabled tasks before their movers start.
        """
        with self._lock:
            if self.cas is None:
                self.cas = ChunkIndex(
                    os.path.join(str(self.store.root), "cas", "index.log"),
                    scope="service", device=self.device)
            return self.cas

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def _recover(self) -> None:
        """Rebuild tasks from the log; re-queue durable non-terminal tasks."""
        for task_id, rec in sorted(self.store.records.items(), key=lambda kv: kv[1].seq):
            t = _Task(rec.spec, rec.seq, self.config.chunk_bytes,
                      tuning=rec.spec.tuning or self.config.tuning,
                      dedup=rec.spec.dedup or self.config.dedup)
            t.state = rec.state
            t.error = rec.error
            if rec.state in tk.TERMINAL:
                t.finished_s = rec.spec.submitted_s   # best effort: log has no ts
                if rec.state == tk.SUCCEEDED:
                    t.chunks_done = t.chunks_total
                    t.bytes_done = t.bytes_total
                self._index_task(task_id, t)
                continue
            if not rec.spec.durable:
                # in-memory sources died with the previous process
                t.state = tk.FAILED
                t.error = "ephemeral source lost across service restart"
                t.finished_s = wall_s()
                self.store.append_state(task_id, tk.FAILED, t.error)
                self._index_task(task_id, t)
                self.events.emit(ev.FAILED, task_id, rec.spec.tenant, error=t.error)
                continue
            # ACTIVE at crash time -> PENDING; PAUSED stays PAUSED.
            if rec.state in (tk.ACTIVE, tk.PENDING):
                t.state = tk.PENDING
                if rec.state == tk.ACTIVE:
                    self.store.append_state(task_id, tk.PENDING, "recovered after restart")
            elif rec.state == tk.PAUSED:
                t.pause_evt.set()
            self._index_task(task_id, t)

    def _index_task(self, task_id: str, t: _Task) -> None:
        """Publish a task into every control-plane index (caller ordered by
        seq during recovery; under the service lock during submission)."""
        self._tasks[task_id] = t
        self._order_pos[task_id] = len(self._order)
        self._order.append(task_id)
        if t.state == tk.PENDING:
            self._activation.add(t.seq, task_id, t.spec.tenant)

    # ------------------------------------------------------------------
    # client API: submission
    # ------------------------------------------------------------------
    def submit(
        self,
        items: Sequence[TransferItem | tuple[str, str] | tuple[str, str, int]],
        *,
        tenant: str = "default",
        label: str = "",
        chunk_bytes: int | None = None,
        batch: bool = True,
        tuning: str | None = None,
        dedup: str | None = None,
        failover: str | None = None,
    ) -> list[str]:
        """Submit a transfer request; returns the task ids it was split into.

        Items are (src_path, dst_path[, nbytes]) or TransferItem. With
        ``batch=True`` the Batcher coalesces small files into shared tasks and
        routes large files to dedicated chunked tasks; ``batch=False`` forces
        a single task for the whole request. ``tuning="auto"`` closes the
        chunk-size loop over these tasks ("static" pins the plan; None defers
        to ``ServiceConfig.tuning``). ``dedup="on"`` probes the endpoint's
        chunk index before moving — chunks the destination already holds are
        satisfied by a local copy instead of wire moves ("off" bypasses the
        index; None defers to ``ServiceConfig.dedup``). ``failover="auto"``
        lets route-aware layers (relay, campaigns) re-plan this task's path
        around dead endpoints mid-flight ("off" pins the route; None defers
        to ``ServiceConfig.failover``).
        """
        norm = [self._norm_item(it) for it in items]
        if not norm:
            raise ValueError("empty submission")
        if tuning not in (None, "static", "auto"):
            raise ValueError(f"tuning must be 'static', 'auto' or None, got {tuning!r}")
        if dedup not in (None, "off", "on"):
            raise ValueError(f"dedup must be 'off', 'on' or None, got {dedup!r}")
        if failover not in (None, "off", "auto"):
            raise ValueError(
                f"failover must be 'off', 'auto' or None, got {failover!r}")
        groups = self.batcher.split(norm) if batch else [list(norm)]
        return [self._submit_group(g, tenant, label, chunk_bytes, tuning,
                                   dedup, failover)
                for g in groups]

    def submit_buffers(
        self,
        buffers: Sequence[tuple[bytes | np.ndarray | ByteSource, str]],
        *,
        tenant: str = "default",
        label: str = "",
        chunk_bytes: int | None = None,
        tuning: str | None = None,
        dedup: str | None = None,
    ) -> str:
        """Submit in-memory payloads (e.g. checkpoint arrays) as ONE task.

        Ephemeral by construction: if the service dies before the task
        completes, recovery fails the task (the bytes are gone) — callers at
        a higher level (repro_torch.service.ckpt_bridge) re-submit and the destination journals
        still prevent re-moving landed chunks.
        """
        if dedup not in (None, "off", "on"):
            raise ValueError(f"dedup must be 'off', 'on' or None, got {dedup!r}")
        items, sources = [], []
        for i, (payload, dst) in enumerate(buffers):
            src = payload if hasattr(payload, "read") else BufferSource(payload)
            items.append(TransferItem(f"mem:{i}", str(dst), src.nbytes, mem=True))
            sources.append(src)
        # register the sources under the SAME lock hold that publishes the
        # task: the scheduler may activate it the instant the lock drops,
        # and a dedup-enabled runner reads the source at seeding time
        with self._lock:
            task_id = self._submit_group(items, tenant, label, chunk_bytes,
                                         tuning, dedup)
            for i, src in enumerate(sources):
                self._mem_sources[(task_id, i)] = src
        return task_id

    def _norm_item(self, it) -> TransferItem:
        if isinstance(it, TransferItem):
            return it
        if len(it) == 2:
            src, dst = it
            return TransferItem(str(src), str(dst), os.path.getsize(src))
        src, dst, nbytes = it
        return TransferItem(str(src), str(dst), int(nbytes))

    def _submit_group(
        self, items: Sequence[TransferItem], tenant: str, label: str,
        chunk_bytes: int | None, tuning: str | None = None,
        dedup: str | None = None, failover: str | None = None,
    ) -> str:
        with self._cond:
            if self._stop_evt.is_set():
                raise RuntimeError("service is shut down")
            task_id = self.store.next_task_id(tenant)
            # pin the EFFECTIVE chunk size (and tuning/dedup policies) into
            # the persisted spec: chunk plans (and so the journal's global
            # chunk ids) must mean the same byte ranges even if the service
            # restarts with a different configured default
            spec = TaskSpec(
                task_id=task_id, tenant=tenant, label=label,
                items=tuple(items),
                chunk_bytes=chunk_bytes or self.config.chunk_bytes,
                tuning=tuning or self.config.tuning,
                dedup=dedup or self.config.dedup,
                failover=failover or self.config.failover,
            )
            rec = self.store.append_submit(spec)
            t = _Task(spec, rec.seq, self.config.chunk_bytes,
                      tuning=spec.tuning or self.config.tuning,
                      dedup=spec.dedup or self.config.dedup)
            self._index_task(task_id, t)
            self._cond.notify_all()
        self.events.emit(
            ev.SUBMITTED, task_id, tenant,
            files=len(items), bytes=sum(i.nbytes for i in items), label=label,
        )
        return task_id

    def submit_many(
        self,
        requests: Sequence[Sequence[TransferItem | tuple[str, str] | tuple[str, str, int]]],
        *,
        tenant: str = "default",
        label: str = "",
        chunk_bytes: int | None = None,
        batch: bool = True,
        tuning: str | None = None,
        dedup: str | None = None,
        failover: str | None = None,
    ) -> list[list[str]]:
        """Bulk submission: one lock hold and one fsync per store shard for
        the whole batch, instead of a lock round-trip and fsync per task.
        Returns one task-id list per request (same split rules as submit).
        """
        if tuning not in (None, "static", "auto"):
            raise ValueError(f"tuning must be 'static', 'auto' or None, got {tuning!r}")
        if dedup not in (None, "off", "on"):
            raise ValueError(f"dedup must be 'off', 'on' or None, got {dedup!r}")
        if failover not in (None, "off", "auto"):
            raise ValueError(
                f"failover must be 'off', 'auto' or None, got {failover!r}")
        groups_per_req: list[list[list[TransferItem]]] = []
        for items in requests:
            norm = [self._norm_item(it) for it in items]
            if not norm:
                raise ValueError("empty submission in bulk request")
            groups_per_req.append(
                [list(g) for g in (self.batcher.split(norm) if batch else [norm])])
        out: list[list[str]] = []
        emits: list[tuple[str, int, int]] = []
        with self._cond:
            if self._stop_evt.is_set():
                raise RuntimeError("service is shut down")
            specs: list[TaskSpec] = []
            for groups in groups_per_req:
                ids: list[str] = []
                for group in groups:
                    task_id = self.store.next_task_id(tenant)
                    specs.append(TaskSpec(
                        task_id=task_id, tenant=tenant, label=label,
                        items=tuple(group),
                        chunk_bytes=chunk_bytes or self.config.chunk_bytes,
                        tuning=tuning or self.config.tuning,
                        dedup=dedup or self.config.dedup,
                        failover=failover or self.config.failover,
                    ))
                    ids.append(task_id)
                    emits.append((task_id, len(group),
                                  sum(i.nbytes for i in group)))
                out.append(ids)
            for spec, rec in zip(specs, self.store.append_submit_many(specs)):
                self._index_task(spec.task_id, _Task(
                    spec, rec.seq, self.config.chunk_bytes,
                    tuning=spec.tuning or self.config.tuning,
                    dedup=spec.dedup or self.config.dedup))
            self._cond.notify_all()
        for task_id, files, nbytes in emits:
            self.events.emit(ev.SUBMITTED, task_id, tenant,
                             files=files, bytes=nbytes, label=label)
        return out

    # ------------------------------------------------------------------
    # client API: lifecycle
    # ------------------------------------------------------------------
    def status(self, task_id: str) -> TaskStatus:
        with self._lock:
            t = self._require(task_id)
            return self._snapshot(t)

    def status_many(self, task_ids: Sequence[str]) -> list[TaskStatus]:
        """Bulk status: one lock hold for the whole batch."""
        with self._lock:
            return [self._snapshot(self._require(tid)) for tid in task_ids]

    def tasks(
        self,
        *,
        tenant: str | None = None,
        state: str | None = None,
        cursor: str | None = None,
        limit: int | None = None,
    ) -> list[TaskStatus]:
        """List tasks in submission order, optionally filtered and paginated.

        ``cursor`` is the last task_id of the previous page: the listing
        resumes strictly after it, so walking ``cursor=page[-1].task_id``
        until an empty page visits every task exactly once even while new
        submissions land (they append after the cursor). Only the returned
        page is snapshotted — a page over a million-task service does not
        materialize a million statuses.
        """
        with self._lock:
            start = 0
            if cursor is not None:
                pos = self._order_pos.get(cursor)
                if pos is None:
                    raise KeyError(f"unknown cursor task {cursor!r}")
                start = pos + 1
            picked: list[_Task] = []
            for tid in itertools.islice(self._order, start, None):
                t = self._tasks[tid]
                if tenant is not None and t.spec.tenant != tenant:
                    continue
                if state is not None and t.state != state:
                    continue
                picked.append(t)
                if limit is not None and len(picked) >= limit:
                    break
            return [self._snapshot(t) for t in picked]

    def wait(self, task_id: str, timeout: float | None = None) -> TaskStatus:
        """Block until the task reaches a terminal state."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            t = self._require(task_id)
            while t.state not in tk.TERMINAL:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"task {task_id} still {t.state} after {timeout}s")
                self._cond.wait(remaining if remaining is not None else 0.5)
            return self._snapshot(t)

    def integrity_stats(self, task_id: str) -> IntegrityStats | None:
        """The integrity engine's counters for a pipelined task (twin of
        ``ChunkedTransfer.integrity_stats``): fused jobs, rows digested on
        the device and on the host, per-job verifies on the device
        (``device_jobs``) and on the host (``per_job``). A copy, read after
        the task finished; None when the task ran no engine in this
        incarnation (serial and single-pass tasks, or a task that finished
        before a restart)."""
        with self._lock:
            engine = self._require(task_id).engine
        return dataclasses.replace(engine.stats) if engine is not None else None

    def wait_all(self, task_ids: Sequence[str], timeout: float | None = None) -> list[TaskStatus]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [
            self.wait(tid, None if deadline is None else max(0.0, deadline - time.monotonic()))
            for tid in task_ids
        ]

    def cancel(self, task_id: str) -> TaskStatus:
        with self._cond:
            t = self._require(task_id)
            if t.state in tk.TERMINAL:
                return self._snapshot(t)
            if t.state in (tk.PENDING, tk.PAUSED):
                self._transition(t, tk.CANCELED)
                self.events.emit(ev.CANCELED, task_id, t.spec.tenant)
            else:
                t.cancel_evt.set()     # runner finalizes the transition
            self._cond.notify_all()
        return self.status(task_id)

    def pause(self, task_id: str) -> TaskStatus:
        with self._cond:
            t = self._require(task_id)
            if t.state == tk.PENDING:
                self._transition(t, tk.PAUSED)
                t.pause_evt.set()
                self.events.emit(ev.PAUSED, task_id, t.spec.tenant)
            elif t.state == tk.ACTIVE:
                t.pause_evt.set()      # runner drains in-flight chunks first
            self._cond.notify_all()
        return self.status(task_id)

    def resume(self, task_id: str) -> TaskStatus:
        with self._cond:
            t = self._require(task_id)
            if t.state == tk.PAUSED:
                t.pause_evt.clear()
                self._transition(t, tk.PENDING)
                self.events.emit(ev.RESUMED, task_id, t.spec.tenant)
                self._cond.notify_all()
            elif t.state == tk.ACTIVE and t.pause_evt.is_set():
                # pause still draining: withdraw it; _finish() sees the
                # cleared event and re-queues instead of landing on PAUSED
                t.pause_evt.clear()
                self.events.emit(ev.RESUMED, task_id, t.spec.tenant)
                self._cond.notify_all()
        return self.status(task_id)

    def subscribe(self, cb, *, from_seq: int | None = None) -> Callable[[], None]:
        """Register an event callback. With ``from_seq``, the subscriber is
        first caught up from that event sequence number (served from the
        spill log if the ring has wrapped), then receives live events — a
        late joiner resumes exactly where its cursor left off."""
        return self.events.subscribe(cb, from_seq=from_seq)

    def events_from(self, start_seq: int, *, limit: int | None = None):
        """Read historical events at seq >= start_seq (cursor polling)."""
        return self.events.read_from(start_seq, limit=limit)

    # ------------------------------------------------------------------
    # client API: resilience plane
    # ------------------------------------------------------------------
    def record_failover(self, task_id: str, **payload: Any) -> None:
        """Record a mid-flight route failover executed on this task's behalf.

        Route-aware layers (relay transfers, campaign re-parenting) own the
        actual re-plan; the service is the system of record — it bumps the
        task's failover counter, the per-tenant metric, and emits a FAILOVER
        event carrying the re-plan detail (sick_link, new_path,
        resumed_chunks).
        """
        with self._lock:
            t = self._require(task_id)
            t.failovers += 1
            tenant = t.spec.tenant
        self._m_failovers.inc(1, tenant=tenant, task=task_id)
        self.events.emit(ev.FAILOVER, task_id, tenant, **payload)

    def scrub_targets(self, task_id: str | None = None) -> list[ScrubTarget]:
        """Landed regions eligible for scrubbing, journal digests attached.

        Every chunk of every SUCCEEDED task (or just ``task_id``) becomes one
        target: the destination file region plus the digest custody recorded
        at landing time. The scrubber re-fingerprints each region against
        that digest — bit-rot after landing is the only way they diverge.
        """
        with self._lock:
            if task_id is not None:
                tasks = [self._require(task_id)]
            else:
                tasks = [self._tasks[tid] for tid in self._order]
            out: list[ScrubTarget] = []
            for t in tasks:
                if t.state != tk.SUCCEEDED:
                    continue
                if t.item_reports:
                    for i, rep in enumerate(t.item_reports):
                        for c in rep.chunks:
                            if not c.get("digest") or not int(c["length"]):
                                continue
                            out.append(ScrubTarget(
                                path=os.path.abspath(rep.dst),
                                offset=int(c["offset"]), length=int(c["length"]),
                                digest_hex=c["digest"], task_id=t.spec.task_id,
                                item=i, chunk=int(c.get("index", 0))))
                    continue
                # restart-replayed task: the in-memory reports are gone but
                # the chunk journal on disk still holds every landed region's
                # digest custody — scrub works across service restarts
                try:
                    journal = self.store.open_journal(t.spec.task_id)
                except OSError:
                    continue
                try:
                    recs = dict(journal.records)
                finally:
                    journal.close()
                for g in sorted(recs):
                    r = recs[g]
                    if r.status != "done" or not r.length or not r.digest_hex:
                        continue
                    i = t.item_of_gidx(g)
                    if i >= len(t.spec.items):
                        continue
                    out.append(ScrubTarget(
                        path=os.path.abspath(t.spec.items[i].dst),
                        offset=int(r.offset), length=int(r.length),
                        digest_hex=r.digest_hex, task_id=t.spec.task_id,
                        item=i, chunk=int(r.chunk_index)))
        return out

    def scrub(self, task_id: str | None = None, *,
              budget_bytes: int | None = None,
              repair: bool = True) -> ScrubReport:
        """One scrub pass over landed regions (all SUCCEEDED tasks or one).

        Re-verifies each region against its journal digest, repairs rot from
        replicas via the CAS index when a verified donor exists, quarantines
        (and emits a FAULT event) when none does. ``budget_bytes`` caps the
        bytes read this pass; the cursor persists so the next call resumes
        where this one stopped.
        """
        targets = self.scrub_targets(task_id)
        # open the chunk index even when dedup never did: the index log on
        # disk is the donor map for repairs, whatever populated it
        index = self.cas_index()
        with self._lock:
            if self._scrubber is None:
                self._scrubber = Scrubber(index=index, device=self.device)
            scrubber = self._scrubber
            scrubber.index = index
            scrubber.budget_bytes = budget_bytes
        report = scrubber.scrub(targets, repair=repair)
        # charge outcomes back to their tasks, then tell the event stream
        touched: dict[str, dict[str, int]] = {}
        for tgt in report.repairs:
            with self._lock:
                t = self._tasks.get(tgt.task_id)
                if t is not None:
                    t.scrub_repairs += 1
                    self._m_scrub_repairs.inc(
                        1, tenant=t.spec.tenant, task=tgt.task_id)
            d = touched.setdefault(tgt.task_id, collections.Counter())
            d["repaired"] += 1
        for tgt in report.quarantines:
            d = touched.setdefault(tgt.task_id, collections.Counter())
            d["quarantined"] += 1
            with self._lock:
                t = self._tasks.get(tgt.task_id)
                tenant = t.spec.tenant if t is not None else "default"
            self.events.emit(
                ev.FAULT, tgt.task_id, tenant, fault="bitrot",
                item=tgt.item, chunk=tgt.chunk, offset=tgt.offset,
                fatal=False, quarantined=True)
        for tid, counts in touched.items():
            with self._lock:
                t = self._tasks.get(tid)
                tenant = t.spec.tenant if t is not None else "default"
            self.events.emit(
                ev.SCRUB, tid, tenant, scanned=report.scanned,
                rot_detected=counts["repaired"] + counts["quarantined"],
                repaired=counts["repaired"],
                quarantined=counts["quarantined"])
        return report

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def close(self, *, drain: bool = False, timeout: float | None = None) -> None:
        """Graceful stop. ``drain=True`` waits for active+pending work first;
        otherwise non-terminal tasks stay journaled and resume on restart."""
        if drain:
            open_ids = [t.spec.task_id for t in self._tasks.values()
                        if t.state not in tk.TERMINAL and not t.pause_evt.is_set()]
            self.wait_all(open_ids, timeout)
        self._stop_evt.set()
        with self._cond:
            still_active = any(t.state == tk.ACTIVE for t in self._tasks.values())
            self._cond.notify_all()
        if still_active:
            # suspend in-flight movers crash-consistently: journals keep what
            # landed, the log keeps ACTIVE, and a restart re-queues the tasks
            self._kill_evt.set()
        self._scheduler.join(timeout=5.0)
        for r in list(self._runners.values()):
            r.join(timeout=5.0)
        self.store.close()
        self.events.close()
        if self.cas is not None:
            self.cas.close()

    def kill(self) -> None:
        """Crash simulation: abandon all threads mid-flight, record nothing.

        Chunk journals and the task log keep whatever had already been
        fsynced — exactly the state a SIGKILL would leave behind.
        """
        self._kill_evt.set()
        self._stop_evt.set()
        with self._cond:
            self._cond.notify_all()
        self._scheduler.join(timeout=5.0)
        for r in list(self._runners.values()):
            r.join(timeout=5.0)
        self.store.close()
        self.events.close()

    # ------------------------------------------------------------------
    # scheduler loop
    # ------------------------------------------------------------------
    def _scheduler_loop(self) -> None:
        while not self._stop_evt.is_set():
            t0 = mono_s()
            with self._cond:
                self._activate_locked()
                dirty = self._alloc_dirty
                self._alloc_dirty = False
                reqs = self._allocation_requests_locked() if dirty else None
            if reqs:
                # predictions may run the event-stepped simulator on cache
                # misses — keep the service lock free while they do
                movers = self.engine.allocate(reqs)
                self._apply_allocation(movers)
            self.sched_cycles.append(mono_s() - t0)
            with self._cond:
                self._cond.wait(self.config.tick_s)

    def _activate_locked(self) -> None:
        free = self.config.max_concurrent_tasks - len(self._active_ids)
        if free <= 0:
            return
        # heap-indexed selection: cost scales with the decision count, not
        # with how many tasks are resident. The validate hook lazily drops
        # entries whose task left PENDING (canceled, paused) since add().
        chosen = self._activation.select(
            free,
            quotas=self.config.quotas, default_quota=self.config.default_quota,
            validate=lambda tid: (
                (tt := self._tasks.get(tid)) is not None
                and tt.state == tk.PENDING),
        )
        for task_id in chosen:
            t = self._tasks[task_id]
            self._transition(t, tk.ACTIVE)
            self._active_ids.add(task_id)
            t.started_s = t.started_s or wall_s()
            t.t0_mono = mono_s()
            # the root span id rides on every task-level event so an event
            # stream entry can be located inside an exported trace
            t.root_sid = self.tracer.mark(
                "activated", "task", task=task_id, tenant=t.spec.tenant)
            self._m_active.add(1, tenant=t.spec.tenant)
            runner = threading.Thread(
                target=self._run_task, args=(t,), name=f"runner-{task_id}", daemon=True
            )
            self._runners[task_id] = runner
            runner.start()
            self.events.emit(ev.ACTIVATED, task_id, t.spec.tenant,
                             span=t.root_sid)
            self._alloc_dirty = True

    def _allocation_requests_locked(self) -> list[tuple[str, str, TransferRequest]]:
        # O(active): iterate the maintained ACTIVE set, not every task ever
        # submitted (sorted for deterministic allocation order)
        out: list[tuple[str, str, TransferRequest]] = []
        for tid in sorted(self._active_ids):
            t = self._tasks.get(tid)
            if t is None or t.state != tk.ACTIVE:
                continue
            out.append((
                t.spec.task_id,
                t.spec.tenant,
                TransferRequest(
                    name=t.spec.task_id,
                    src=self.config.src_site,
                    dst=self.config.dst_site,
                    file_bytes=tuple(max(1, it.nbytes) for it in t.spec.items),
                    chunk_bytes=t.spec.chunk_bytes or self.config.chunk_bytes,
                    integrity=self.config.integrity,
                ),
            ))
        return out

    def _apply_allocation(self, movers: dict[str, int]) -> None:
        with self._lock:
            for tid, m in movers.items():
                t = self._tasks.get(tid)
                if t is not None and t.state == tk.ACTIVE:
                    t.target_movers = max(1, m)
        self.events.emit(
            ev.REALLOC, "-", "-",
            allocation=dict(movers), policy=self.config.policy,
        )

    # ------------------------------------------------------------------
    # task runner (one thread per ACTIVE task)
    # ------------------------------------------------------------------
    def _run_task(self, t: _Task) -> None:
        task_id = t.spec.task_id
        try:
            journal = self.store.open_journal(task_id)
        except Exception as e:  # noqa: BLE001
            self._finish(t, tk.FAILED, error=f"journal open failed: {e}")
            return
        jlock = threading.Lock()
        try:
            recs = dict(journal.records)
            with t.lock:
                t.resumed_chunks = len(recs)
                t.chunks_done = len(recs)
                t.bytes_done = sum(r.length for r in recs.values())
            work: "queue.Queue[tuple[int, int, Any]]" = queue.Queue()
            n_work = 0
            # Static seeding works whenever every journaled record matches
            # the deterministic static plans byte-for-byte (all untuned
            # tasks, and tuned tasks that never re-planned). A journal left
            # by a re-planned incarnation has records at other boundaries:
            # then the pending tail is region-based — journaled custody is
            # subtracted per item and fresh tuned-band chunks are carved
            # from the gaps, so a journaled chunk is never re-moved.
            if all(t.static_record_ok(g, r) for g, r in recs.items()):
                for i, plan in enumerate(t.plans):
                    if plan.n_chunks == 0:
                        self._dest(t, i)    # zero-byte item: materialize the file
                        continue
                    base = t.chunk_base[i]
                    entries = [(base + c.index, i, c) for c in plan.chunks
                               if base + c.index not in recs]
                    # content plane: satisfy index hits locally before any
                    # mover starts (deduped chunks journal custody and are
                    # counted done; only misses become wire work items)
                    if t.dedup == "on":
                        entries = self._dedup_entries(t, journal, jlock, i,
                                                      entries)
                    with t.lock:
                        expanded = self._expand_entries_locked(t, entries)
                    for e in expanded:
                        self._enq(t, work, e)
                        n_work += 1
            else:
                per_item: dict[int, list] = {i: [] for i in range(len(t.spec.items))}
                for g, r in recs.items():
                    per_item[t.item_of_gidx(g)].append(r)
                for i, item in enumerate(t.spec.items):
                    if t.plans[i].n_chunks == 0:
                        self._dest(t, i)
                        continue
                    with t.lock:
                        t.next_tune_seq[i] = max(
                            ((g - TUNE_GID_BASE) % TUNE_ITEM_STRIDE
                             for g in recs if TUNE_GID_BASE <= g < STRIPE_GID_BASE
                             and t.item_of_gidx(g) == i),
                            default=-1,
                        ) + 1
                        # resume the stripe allocator past journaled stripe
                        # ids: reusing one would overwrite custody in the
                        # journal's replay dict on the NEXT restart
                        t.next_stripe_seq[i] = max(
                            ((g - STRIPE_GID_BASE) % STRIPE_ITEM_STRIDE
                             for g in recs if g >= STRIPE_GID_BASE
                             and t.item_of_gidx(g) == i),
                            default=-1,
                        ) + 1
                        gaps = subtract_regions(
                            item.nbytes,
                            [(r.offset, r.length) for r in per_item[i]],
                        )
                        fresh = partition_regions(
                            gaps, t.chunk_bytes_now,
                            start_index=t.next_tune_seq[i],
                        )
                        t.next_tune_seq[i] += len(fresh)
                    raw = [(t.tune_gidx(i, c.index), i, c) for c in fresh]
                    if t.dedup == "on":
                        # dedup runs OUTSIDE t.lock: it opens endpoints
                        # (_source/_dest take the lock) and probes the index
                        raw = self._dedup_entries(t, journal, jlock, i, raw)
                    with t.lock:
                        entries = self._expand_entries_locked(t, raw)
                    for e in entries:
                        self._enq(t, work, e)
                        n_work += 1
            # total = done so far (resumed + deduped) + queued work items:
            # stripe expansion and dedup both change the count, so it is
            # recomputed here for every seeding path (for the plain static
            # case this equals the plans' chunk total exactly)
            with t.lock:
                t.chunks_total = t.chunks_done + n_work
            if t.tuning == "auto":
                self._arm_tuner(t, work)
            if self.config.pipeline != "serial":
                t.pool = BufferPool(
                    max(self.config.stream_granule,
                        min(t.chunk_bytes_now or 1, 64 * MiB)),
                    capacity=(self.config.mover_budget
                              + self.config.integrity_workers + 2),
                )
            if self.config.pipeline == "pipelined" and self.config.integrity:
                # decoupled integrity engine: movers enqueue, checksum
                # workers verify concurrently with later chunk moves. The
                # custody rule lives in _verify_pass: the journal record
                # commits only once the deferred verification lands.
                t.engine = IntegrityEngine(
                    workers=self.config.integrity_workers, pool=t.pool,
                    on_verified=lambda job, lag, ck: self._verify_pass(
                        t, work, journal, jlock, job, lag),
                    on_corrupt=lambda job, actual, lag: self._verify_fail(
                        t, work, job),
                    on_error=lambda job, exc: self._verify_error(t, job, exc),
                    tracer=self.tracer, task=task_id,
                    backend="device", device=self.device,
                )

            reason = self._drive_workers(t, work, journal, jlock, n_work)
            if t.engine is not None:
                if reason is None:
                    t.engine.close(abandon=True)   # kill(): crash mid-flight
                else:
                    # drain before finalizing: a paused/canceled/failed task
                    # still journals every chunk its verifiers vouch for, so
                    # a resume re-moves only genuinely unverified chunks
                    t.engine.drain()
                    t.engine.close()
            if reason is None:          # killed: vanish without a trace
                return
            if reason == tk.SUCCEEDED:
                try:
                    reports = self._build_reports(t, journal)
                except Exception as e:  # noqa: BLE001
                    self._finish(t, tk.FAILED, error=f"finalize failed: {e}")
                    return
                self._finish(t, tk.SUCCEEDED, reports=reports)
            elif reason == tk.PAUSED:
                self._finish(t, tk.PAUSED)
            elif reason == tk.CANCELED:
                self._finish(t, tk.CANCELED)
            else:
                self._finish(t, tk.FAILED, error=t.failed_error or "unknown failure")
        finally:
            # on kill() the handle is left open, as a real SIGKILL would leave
            # it: a straggler mover may still be appending its last record
            if not self._kill_evt.is_set():
                journal.close()
            with self._lock:
                # a resumed task may already have a NEW runner registered
                if self._runners.get(task_id) is threading.current_thread():
                    self._runners.pop(task_id, None)

    def _drive_workers(self, t, work, journal, jlock, n_work) -> str | None:
        """Spawn/trim movers until the task reaches an outcome; returns the
        outcome state, or None when the service was killed mid-flight."""
        while True:
            if self._kill_evt.is_set():
                return None
            if t.cancel_evt.is_set():
                outcome = tk.CANCELED
            elif t.pause_evt.is_set():
                outcome = tk.PAUSED
            else:
                with t.lock:
                    if t.failed_error:
                        outcome = tk.FAILED
                    elif t.chunks_done >= t.chunks_total:
                        outcome = tk.SUCCEEDED
                    else:
                        outcome = ""
            if outcome:
                break
            with t.lock:
                want = min(max(1, t.target_movers), max(1, t.chunks_total - t.chunks_done))
                # don't spawn movers that would find an empty queue: the last
                # chunks are in flight with the workers already holding them
                want = min(want, work.qsize() + t.n_workers)
                short = want - t.n_workers
                for _ in range(max(0, short)):
                    t.n_workers += 1
                    t.worker_seq += 1
                    threading.Thread(
                        target=self._worker,
                        args=(t, work, journal, jlock, t.worker_seq),
                        daemon=True,
                    ).start()
            time.sleep(self.config.tick_s)
        # wind down: workers observe the same events/counters and drain
        while True:
            with t.lock:
                if t.n_workers == 0:
                    return outcome
            if self._kill_evt.is_set():
                return None
            time.sleep(self.config.tick_s / 2)

    # ------------------------------------------------------------------
    # autotuning (closed-loop chunk sizing per task)
    # ------------------------------------------------------------------
    def _arm_tuner(self, t: _Task, work) -> None:
        """Create the task's ChunkController (optionally SimTuner-seeded)
        and apply the warm-start re-plan before any byte moves."""
        chunk0 = t.chunk_bytes_now
        lo = min(self.config.tune_min_chunk, chunk0)
        hi = max(self.config.tune_max_chunk, chunk0)
        target0 = chunk0
        if self.config.tune_seed == "sim" and t.bytes_total > 0:
            sim = SimTuner(self.config.src_site, self.config.dst_site,
                           self.config.link)
            target0 = max(lo, min(hi, sim.seed_chunk(t.bytes_total)))
        t.controller = ChunkController(
            chunk_bytes=target0, min_chunk=lo, max_chunk=hi,
            epoch_chunks=self.config.tune_epoch_chunks,
        )
        if target0 != chunk0:
            self._replan_task(t, work, target0, rate_Bps=0.0)

    def _replan_task(self, t: _Task, work, new_bytes: int, *,
                     rate_Bps: float = 0.0, cksum_lag_s: float = 0.0) -> int:
        """Re-partition the task's un-started tail at ``new_bytes``.

        Drains the work queue (chunks never handed to a mover — journaled
        custody and in-flight chunks are untouchable by construction),
        re-cuts each item's drained regions, and re-enqueues under fresh
        tuned-band journal ids. Emits a TUNE event.
        """
        drained: list[tuple[int, int, Any]] = []
        while True:
            try:
                drained.append(work.get_nowait())
            except queue.Empty:
                break
        if not drained:
            return 0
        # stripe work items keep their boundaries (their journaled siblings
        # pin the partition) — only whole un-started plain chunks are re-cut
        kept = [e for e in drained if e[0] >= STRIPE_GID_BASE]
        plain = [e for e in drained if e[0] < STRIPE_GID_BASE]
        if not plain:
            for e in kept:
                self._enq(t, work, e)
            return 0
        by_item: dict[int, list[tuple[int, int]]] = {}
        for _g, i, c in plain:
            by_item.setdefault(i, []).append((c.offset, c.length))
        entries: list[tuple[int, int, Any]] = []
        with t.lock:
            for i in sorted(by_item):
                fresh = partition_regions(
                    merge_regions(by_item[i]), new_bytes,
                    start_index=t.next_tune_seq[i],
                )
                t.next_tune_seq[i] += len(fresh)
                entries.extend(self._expand_entries_locked(
                    t, [(t.tune_gidx(i, c.index), i, c) for c in fresh]))
            t.chunks_total += len(entries) - len(plain)
            t.replans += 1
            old = t.chunk_bytes_now
            t.chunk_bytes_now = int(new_bytes)
        for e in kept:
            self._enq(t, work, e)
        for e in entries:
            self._enq(t, work, e)
        self.tracer.mark("replan", "plan", task=t.spec.task_id,
                         chunk_bytes=int(new_bytes), recut=len(entries))
        self.events.emit(
            ev.TUNE, t.spec.task_id, t.spec.tenant,
            old_chunk_bytes=old, chunk_bytes=int(new_bytes),
            drained=len(drained), requeued=len(entries),
            rate_Bps=round(rate_Bps, 3),
            cksum_lag_s=round(cksum_lag_s, 6),
        )
        return len(drained)

    def _feed_tuner(self, t: _Task, work, chunk, sample: ChunkSample) -> None:
        with t.lock:
            ctrl = t.controller
            if ctrl is None:
                return
            new = ctrl.observe(sample)
            cur = t.chunk_bytes_now
        if new is not None and new != cur:
            self._replan_task(t, work, new, rate_Bps=sample.rate_Bps,
                              cksum_lag_s=sample.cksum_lag_s)

    def _expand_entries_locked(self, t: _Task, entries):
        """Split stripe-eligible work entries into stripe-band entries.

        Caller holds ``t.lock`` (or is the single-threaded runner during
        seeding). Each stripe is an independent work item with its own
        stripe-band journal id: custody is per-stripe, so a restart re-moves
        only the stripes whose verification never landed — the journaled
        ones are subtracted as regions like any other custody record.
        """
        cfg = self.config
        if cfg.stripes <= 1:
            return entries
        out = []
        for gidx, i, c in entries:
            sp = plan_stripes(c, cfg.stripes,
                              stripe_min_bytes=cfg.stripe_min_bytes)
            if sp.n_stripes <= 1:
                out.append((gidx, i, c))
                continue
            t.striped_chunks += 1
            for s in sp.stripes:
                seq = t.next_stripe_seq[i]
                t.next_stripe_seq[i] = seq + 1
                out.append((t.stripe_gidx(i, seq), i,
                            Chunk(index=seq, offset=s.offset,
                                  length=s.length, mover=0)))
        return out

    def _enq(self, t: _Task, work, entry) -> None:
        """Queue a work entry, timestamping it for the queue-wait span."""
        t.enq_t[entry[0]] = mono_s()
        work.put(entry)

    # ------------------------------------------------------------------
    # content plane (dedup negotiation during task seeding)
    # ------------------------------------------------------------------
    def _dedup_entries(self, t: _Task, journal, jlock, item_idx: int,
                       entries):
        """Probe one item's pending work entries against the chunk index;
        returns the entries that still need wire moves.

        Runs during seeding, before any mover spawns (and outside
        ``t.lock``). Each pending chunk's source bytes are fingerprinted and
        probed; a hit is satisfied locally — alias entries (the destination
        already holds the bytes at the right offset) need only read-back
        verification, other entries' backing bytes are re-verified, copied
        in, and verified again after landing. Satisfied chunks journal
        custody immediately and count as done; a stale entry is discarded
        (demotion to wire, ``stale_index`` fault metric), so a wrong index
        can cost a wire move but never an integrity escape. Deduped chunks
        never reach ``_move_chunk``: they feed neither the tuner's
        congestion signal nor ``moved_chunks`` (the chaos re-move counter).
        """
        index = self.cas_index()
        item = t.spec.items[item_idx]
        dst_path = os.path.abspath(item.dst)
        src = self._source(t, item_idx)
        dst = self._dest(t, item_idx)
        tid = t.spec.task_id
        keep = []
        hits = saved = demoted = 0
        for gidx, i, chunk in entries:
            t_p = mono_s()
            try:
                data = src.read(chunk.offset, chunk.length)
            except Exception:  # noqa: BLE001 — probe failure = wire move
                keep.append((gidx, i, chunk))
                continue
            if len(data) != chunk.length:
                keep.append((gidx, i, chunk))
                continue
            want = fingerprint_on_device(data, self.device)
            del data
            satisfied = aliased = stale_here = False
            for e in index.lookup(want.hexdigest(), chunk.length):
                alias = (os.path.abspath(e.path) == dst_path
                         and e.offset == chunk.offset)
                backing = index.verify_entry(e)
                if backing is None:
                    # stale: backing bytes vanished or rotted — drop the
                    # entry and keep probing other locations
                    index.discard(e.digest_hex, e.length, e.path, e.offset)
                    index.note_stale()
                    stale_here = True
                    continue
                try:
                    if not alias:
                        dst.write(chunk.offset, backing)
                    back = dst.read_back(chunk.offset, chunk.length)
                except Exception:  # noqa: BLE001 — local copy failed
                    stale_here = True
                    continue
                if not verify(want, fingerprint_on_device(back, self.device)):
                    stale_here = True     # copy landed corrupt: wire instead
                    continue
                satisfied, aliased = True, alias
                break
            now = mono_s()
            if not satisfied:
                if stale_here:
                    demoted += 1
                    with t.lock:
                        t.dedup_demoted += 1
                    self._m_faults.inc(1, tenant=t.spec.tenant, task=tid,
                                       kind="stale_index")
                    self.tracer.add("dedup_demote", "dedup", t_p, now,
                                    task=tid, lane="dedup",
                                    offset=chunk.offset, item=item_idx)
                else:
                    self.tracer.add("dedup_probe", "dedup", t_p, now,
                                    task=tid, lane="dedup",
                                    offset=chunk.offset, item=item_idx)
                keep.append((gidx, i, chunk))
                continue
            # custody first: a kill+restart must see the deduped chunk as
            # landed (journaled bytes are never re-moved — the same rule
            # wire moves live by)
            try:
                with jlock:
                    journal.append(JournalRecord(
                        gidx, chunk.offset, chunk.length, want.hexdigest()))
            except Exception:  # noqa: BLE001 — no custody, no dedup
                keep.append((gidx, i, chunk))
                continue
            if not aliased:
                try:
                    index.put(want.hexdigest(), chunk.length, dst_path,
                              chunk.offset)
                except Exception:  # noqa: BLE001 — cache: failed put = miss
                    pass
            with t.lock:
                t.chunks_done += 1
                t.bytes_done += chunk.length
                t.chunks_deduped += 1
                t.wire_bytes_saved += chunk.length
            hits += 1
            saved += chunk.length
            self.tracer.add("dedup_hit", "dedup", t_p, now, task=tid,
                            lane="dedup", offset=chunk.offset, item=item_idx,
                            alias=int(aliased))
        if hits or demoted:
            self.events.emit(
                ev.DEDUP, tid, t.spec.tenant, item=item_idx, chunks=hits,
                bytes_saved=saved, demoted=demoted, span=t.root_sid,
            )
        return keep

    def _worker(self, t: _Task, work, journal, jlock, wid: int = 0) -> None:
        lane = f"mover{wid}"
        try:
            while True:
                if (
                    self._kill_evt.is_set()
                    or t.cancel_evt.is_set()
                    or t.pause_evt.is_set()
                ):
                    return
                with t.lock:
                    if t.failed_error:
                        return
                    if t.n_workers > max(1, t.target_movers):
                        return               # trimmed by reallocation
                try:
                    gidx, item_idx, chunk = work.get_nowait()
                except queue.Empty:
                    return
                enq = t.enq_t.get(gidx)
                if enq is not None:
                    self.tracer.add(
                        "queue_wait", "queue", enq, mono_s(),
                        task=t.spec.task_id, lane=lane,
                        offset=chunk.offset, item=item_idx)
                try:
                    digest, sample = self._move_chunk(t, item_idx, chunk,
                                                      lane=lane)
                except MoverCrash as e:
                    # the mover thread dies; the chunk survives it. Re-queue
                    # the chunk for the remaining movers (the driver tops the
                    # pool back up) unless the death budget is exhausted.
                    with t.lock:
                        t.mover_deaths += 1
                        over = t.mover_deaths > self.config.max_mover_deaths
                        if over:
                            t.failed_error = (
                                f"mover-death budget exhausted "
                                f"({t.mover_deaths} > {self.config.max_mover_deaths})"
                            )
                            t.fault = self._fault_report(t, "mover_death", item_idx, chunk, e)
                    self._m_faults.inc(1, tenant=t.spec.tenant,
                                       task=t.spec.task_id, kind="mover_death")
                    self.events.emit(
                        ev.FAULT, t.spec.task_id, t.spec.tenant,
                        fault="mover_death", item=item_idx, chunk=chunk.index,
                        fatal=over, span=t.root_sid,
                    )
                    if not over:
                        self._enq(t, work, (gidx, item_idx, chunk))
                    return
                except Exception as e:  # noqa: BLE001
                    with t.lock:
                        t.failed_error = (
                            f"item {item_idx} chunk {chunk.index} "
                            f"(offset={chunk.offset}): {e}"
                        )
                        t.fault = self._fault_report(t, classify_fault(e), item_idx, chunk, e)
                    return
                if t.engine is not None:
                    # pipelined: the move landed; enqueue the deferred
                    # verification and pull the next chunk NOW. Journal +
                    # progress commit in _verify_pass (the custody rule).
                    t.engine.submit(VerifyJob(
                        key=gidx, offset=chunk.offset, length=chunk.length,
                        expected=digest, dest=self._dest(t, item_idx),
                        enqueued_s=time.perf_counter(),
                        payload=(gidx, item_idx, chunk, sample),
                    ))
                    continue
                if not self._commit_chunk(t, work, journal, jlock,
                                          gidx, item_idx, chunk, digest, sample):
                    return
        finally:
            with t.lock:
                t.n_workers -= 1

    def _commit_chunk(self, t: _Task, work, journal, jlock, gidx: int,
                      item_idx: int, chunk, digest, sample: ChunkSample) -> bool:
        """Make one verified chunk durable and visible: journal custody,
        counters, PROGRESS event, tuner feed. Shared by the serial mover
        path and the integrity engine's verdict callbacks; returns False
        when the task was failed instead."""
        t_j = time.perf_counter()
        try:
            with jlock:
                journal.append(JournalRecord(
                    gidx, chunk.offset, chunk.length, digest.hexdigest()
                ))
        except Exception as e:  # noqa: BLE001
            if self._kill_evt.is_set():
                return False    # kill() closed the journal under us
            # a dead journal (ENOSPC, pulled mount) must FAIL the
            # task with a report, not strand it ACTIVE: completions
            # that can't be made durable are not completions
            with t.lock:
                t.failed_error = (
                    f"journal append failed for item {item_idx} chunk "
                    f"{chunk.index}: {e}"
                )
                t.fault = self._fault_report(t, "io", item_idx, chunk, e)
            return False
        self.tracer.add("journal_append", "journal", t_j, time.perf_counter(),
                        task=t.spec.task_id, lane="journal",
                        offset=chunk.offset, item=item_idx)
        if self.cas is not None:
            # index population: every verified, journaled chunk is content a
            # future task (or checkpoint save) may dedup against
            try:
                self.cas.put(digest.hexdigest(), chunk.length,
                             os.path.abspath(t.spec.items[item_idx].dst),
                             chunk.offset)
            except Exception:  # noqa: BLE001 — cache: failed put = miss
                pass
        self._m_chunks.inc(1, tenant=t.spec.tenant, task=t.spec.task_id)
        self._m_bytes.inc(chunk.length, tenant=t.spec.tenant,
                          task=t.spec.task_id)
        with self._lock:
            self.moved_chunks += 1
        with t.lock:
            t.chunks_done += 1
            t.bytes_done += chunk.length
            t.cksum_s += sample.cksum_seconds
            t.cksum_lag_s += sample.cksum_lag_s
            done, total = t.chunks_done, t.chunks_total
        self.events.emit(
            ev.PROGRESS, t.spec.task_id, t.spec.tenant,
            chunks_done=done, chunks_total=total,
        )
        if t.controller is not None:
            # fold the journal fsync into the sample: it is a real
            # per-chunk control-plane cost the tuner must weigh
            j_secs = time.perf_counter() - t_j
            sample = dataclasses.replace(
                sample, seconds=sample.seconds + j_secs,
                attempt_seconds=sample.attempt_seconds + j_secs,
            )
            self._feed_tuner(t, work, chunk, sample)
        if done >= total:
            with self._cond:
                self._cond.notify_all()
        return True

    # ------------------------------------------------------------------
    # integrity-engine verdicts (pipelined data plane, verifier threads)
    # ------------------------------------------------------------------
    def _verify_pass(self, t: _Task, work, journal, jlock,
                     job: VerifyJob, lag_s: float) -> None:
        gidx, item_idx, chunk, sample = job.payload
        sample = dataclasses.replace(sample, cksum_lag_s=lag_s)
        self._commit_chunk(t, work, journal, jlock,
                           gidx, item_idx, chunk, job.expected, sample)

    def _verify_fail(self, t: _Task, work, job: VerifyJob) -> None:
        """A lagging verifier caught a corrupt landing: quarantine + re-queue
        the chunk for a source re-fetch, on the same re-fetch budget the
        inline path uses; the budget exhausting fails the task with a
        structured corruption report."""
        gidx, item_idx, chunk, _sample = job.payload
        with t.lock:
            t.retries += 1
            t.refetches += 1
            n = t.verify_refetches.get(gidx, 0) + 1
            t.verify_refetches[gidx] = n
            over = n > self.config.max_refetches
            if over:
                exc = IntegrityError(
                    f"deferred read-back digest mismatch persisted through "
                    f"{self.config.max_refetches} re-fetches "
                    f"(item {item_idx} @ {chunk.offset})"
                )
                t.failed_error = (
                    f"item {item_idx} chunk {chunk.index} "
                    f"(offset={chunk.offset}): {exc}"
                )
                t.fault = self._fault_report(t, "corruption", item_idx, chunk, exc)
        self._m_faults.inc(1, tenant=t.spec.tenant, task=t.spec.task_id,
                           kind="corruption")
        self.events.emit(
            ev.FAULT, t.spec.task_id, t.spec.tenant,
            fault="corruption", item=item_idx, chunk=chunk.index,
            deferred=True, fatal=over, span=t.root_sid,
        )
        if not over:
            self._enq(t, work, (gidx, item_idx, chunk))

    def _verify_error(self, t: _Task, job: VerifyJob, exc: BaseException) -> None:
        gidx, item_idx, chunk, _sample = job.payload
        if self._kill_evt.is_set():
            return                  # kill() tore the endpoints down under us
        with t.lock:
            t.failed_error = (
                f"deferred verification read-back failed for item {item_idx} "
                f"chunk {chunk.index}: {exc}"
            )
            t.fault = self._fault_report(t, classify_fault(exc), item_idx, chunk, exc)

    def _fault_report(self, t: _Task, kind: str, item_idx: int, chunk,
                      exc: BaseException) -> FaultReport:
        """Structured terminal-fault description (caller holds t.lock)."""
        return FaultReport(
            kind=kind, item=item_idx, chunk=chunk.index, offset=chunk.offset,
            error=str(exc), retries=t.retries, refetches=t.refetches,
            outages=t.outages, mover_deaths=t.mover_deaths,
        )

    def _move_chunk(self, t: _Task, item_idx: int, chunk, *,
                    lane: str = "mover0"):
        """One chunk: read -> fingerprint -> write -> read-back verify, with
        per-failure-class recovery budgets (chunk-granular fault recovery):

        * digest mismatch -> immediate re-fetch from source (quarantine the
          landing), up to ``max_refetches``;
        * endpoint outage -> wait the window out with backoff on the (larger)
          ``outage_retries`` budget — outages heal on their own clock;
        * mover crash -> propagates to the worker, which re-queues the chunk;
        * anything else -> exponential-backoff retries up to ``max_retries``.

        Every fault is propagated through the event stream (FAULT/RETRY); the
        task only FAILs — with a structured FaultReport — after the budget of
        the terminal failure class is exhausted.
        """
        item = t.spec.items[item_idx]
        src = self._source(t, item_idx)
        dst = self._dest(t, item_idx)
        attempts = generic = refetches = outages = 0
        t0 = time.perf_counter()
        signal_s = 0.0   # fault-excluded work time: generic retries count
        # (congestion), corruption re-fetches and outage waits do not
        while True:
            attempts += 1
            t_att = time.perf_counter()
            try:
                if self._fault_injector is not None:
                    self._fault_injector(t.spec.task_id, item_idx, chunk, attempts)
                if self.config.pipeline == "serial" or t.pool is None:
                    data = src.read(chunk.offset, chunk.length)
                    if len(data) != chunk.length:
                        raise IOError(
                            f"short read at {chunk.offset}: {len(data)}/{chunk.length}"
                        )
                    t_ck = time.perf_counter()
                    digest = fingerprint_on_device(data, self.device)
                    cksum_s = time.perf_counter() - t_ck
                    dst.write(chunk.offset, data)
                else:
                    # single-pass streaming: the source fingerprint
                    # accumulates while each granule streams into the
                    # destination through a pooled zero-copy buffer
                    digest, cksum_s = stream_chunk(
                        src, dst, chunk.offset, chunk.length,
                        pool=t.pool, granule=self.config.stream_granule,
                        device=self.device,
                    )
                if self.config.integrity and self.config.pipeline != "pipelined":
                    t_ck = time.perf_counter()
                    back = dst.read_back(chunk.offset, chunk.length)
                    ok = verify(digest, fingerprint_on_device(back, self.device))
                    cksum_s += time.perf_counter() - t_ck
                    if not ok:
                        raise IntegrityError(
                            f"read-back digest mismatch ({item.dst} @ {chunk.offset})"
                        )
                now = time.perf_counter()
                # retroactive spans: the successful attempt minus its inline
                # checksum share is wire; the checksum share sits at the tail
                wire_end = max(t_att, now - cksum_s)
                tid = t.spec.task_id
                self.tracer.add("move", "wire", t_att, wire_end, task=tid,
                                lane=lane, offset=chunk.offset, item=item_idx,
                                attempt=attempts)
                if cksum_s > 0.0:
                    self.tracer.add("cksum_inline", "cksum", wire_end, now,
                                    task=tid, lane=lane, offset=chunk.offset,
                                    item=item_idx)
                self._m_wire.observe(signal_s + (now - t_att), task=tid)
                return digest, ChunkSample(
                    offset=chunk.offset, length=chunk.length,
                    seconds=now - t0,
                    attempt_seconds=signal_s + (now - t_att),
                    cksum_seconds=cksum_s, attempts=attempts,
                    refetches=refetches,
                )
            except MoverCrash:
                raise                      # the mover is gone; no in-place retry
            except IntegrityError:
                refetches += 1
                with t.lock:
                    t.retries += 1
                    t.refetches += 1
                sid = self.tracer.add(
                    "refetch", "stall", t_att, time.perf_counter(),
                    task=t.spec.task_id, lane=lane, offset=chunk.offset,
                    item=item_idx, attempt=attempts)
                self._m_faults.inc(1, tenant=t.spec.tenant,
                                   task=t.spec.task_id, kind="corruption")
                self.events.emit(
                    ev.FAULT, t.spec.task_id, t.spec.tenant,
                    fault="corruption", item=item_idx, chunk=chunk.index,
                    attempt=attempts, fatal=refetches > self.config.max_refetches,
                    span=sid,
                )
                if refetches > self.config.max_refetches:
                    raise
            except EndpointOutage:
                outages += 1
                with t.lock:
                    t.outages += 1
                over = outages > self.config.outage_retries
                if not over:
                    Backoff(self.config.retry_backoff_s, mode="linear",
                            lane=f"{t.spec.task_id}:{lane}:c{chunk.index}",
                            ).sleep(outages)
                # the rejected op plus its backoff is fault recovery, not
                # congestion (the tuner's fault-exclusion rule)
                sid = self.tracer.add(
                    "outage_wait", "stall", t_att, time.perf_counter(),
                    task=t.spec.task_id, lane=lane, offset=chunk.offset,
                    item=item_idx)
                self._m_faults.inc(1, tenant=t.spec.tenant,
                                   task=t.spec.task_id, kind="outage")
                self.events.emit(
                    ev.FAULT, t.spec.task_id, t.spec.tenant,
                    fault="outage", item=item_idx, chunk=chunk.index,
                    attempt=attempts, fatal=over, span=sid,
                )
                if over:
                    raise
            except Exception:
                generic += 1
                now = time.perf_counter()
                signal_s += now - t_att   # congestion-like
                # generic retries ARE the path slowing down: wire, not stall
                sid = self.tracer.add(
                    "move_retry", "wire", t_att, now, task=t.spec.task_id,
                    lane=lane, offset=chunk.offset, item=item_idx,
                    attempt=attempts)
                self._m_faults.inc(1, tenant=t.spec.tenant,
                                   task=t.spec.task_id, kind="generic")
                if generic > self.config.max_retries:
                    raise
                with t.lock:
                    t.retries += 1
                self.events.emit(
                    ev.RETRY, t.spec.task_id, t.spec.tenant,
                    item=item_idx, chunk=chunk.index, attempt=attempts,
                    span=sid,
                )
                Backoff(self.config.retry_backoff_s,
                        lane=f"{t.spec.task_id}:{lane}:c{chunk.index}",
                        ).sleep(generic)

    def _source(self, t: _Task, item_idx: int) -> ByteSource:
        with t.lock:
            src = t._sources.get(item_idx)
            if src is None:
                item = t.spec.items[item_idx]
                if item.mem:
                    src = self._mem_sources[(t.spec.task_id, item_idx)]
                else:
                    src = FileSource(item.src)
                if self._source_wrapper is not None:
                    src = self._source_wrapper(t.spec.task_id, item_idx, src)
                t._sources[item_idx] = src
            return src

    def _dest(self, t: _Task, item_idx: int) -> ByteDest:
        with t.lock:
            dst = t._dests.get(item_idx)
            if dst is None:
                item = t.spec.items[item_idx]
                parent = os.path.dirname(item.dst)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                dst = FileDest(item.dst, item.nbytes)
                if self._dest_wrapper is not None:
                    dst = self._dest_wrapper(t.spec.task_id, item_idx, dst)
                t._dests[item_idx] = dst
            return dst

    def _build_reports(self, t: _Task, journal: ChunkJournal) -> tuple[ItemReport, ...]:
        if any(g >= TUNE_GID_BASE for g in journal.records):
            return self._build_reports_regions(t, journal)
        reports = []
        for i, (item, plan) in enumerate(zip(t.spec.items, t.plans)):
            base = t.chunk_base[i]
            chunks, parts = [], []
            for c in plan.chunks:
                rec = journal.records[base + c.index]
                parts.append((rec.offset, rec.digest()))
                chunks.append({
                    "index": c.index, "offset": c.offset,
                    "length": c.length, "digest": rec.digest_hex,
                })
            digest = combine_at_offsets(parts, item.nbytes) if parts else EMPTY_DIGEST
            reports.append(ItemReport(
                src=item.src, dst=item.dst, nbytes=item.nbytes,
                digest_hex=digest.hexdigest(),
                chunk_bytes=plan.chunk_bytes, chunks=tuple(chunks),
            ))
        return tuple(reports)

    def _build_reports_regions(self, t: _Task, journal: ChunkJournal) -> tuple[ItemReport, ...]:
        """Item reports for a re-planned (tuned) task: the journal's byte
        regions are authoritative — the merge-law combine works over any
        boundary set that tiles each item exactly."""
        per_item: dict[int, list] = {i: [] for i in range(len(t.spec.items))}
        for g, rec in journal.records.items():
            per_item[t.item_of_gidx(g)].append(rec)
        reports = []
        for i, item in enumerate(t.spec.items):
            rl = sorted(per_item[i], key=lambda r: r.offset)
            parts = [(r.offset, r.digest()) for r in rl]
            digest = combine_at_offsets(parts, item.nbytes) if parts else EMPTY_DIGEST
            chunks = tuple(
                {"index": r.chunk_index, "offset": r.offset,
                 "length": r.length, "digest": r.digest_hex}
                for r in rl
            )
            reports.append(ItemReport(
                src=item.src, dst=item.dst, nbytes=item.nbytes,
                digest_hex=digest.hexdigest(),
                chunk_bytes=t.chunk_bytes_now, chunks=chunks,
            ))
        return tuple(reports)

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    def _require(self, task_id: str) -> _Task:
        t = self._tasks.get(task_id)
        if t is None:
            raise KeyError(f"unknown task {task_id!r}")
        return t

    def _transition(self, t: _Task, state: str, error: str | None = None) -> None:
        if not tk.can_transition(t.state, state):
            raise TransitionError(t.spec.task_id, t.state, state)
        prev, task_id = t.state, t.spec.task_id
        t.state = state
        t.error = error
        # keep the control-plane indexes in lockstep with the state machine
        # (callers hold the service lock): leaving ACTIVE shrinks the active
        # set and the tenant's quota usage; re-entering PENDING (resume, a
        # withdrawn pause) re-queues the task for activation
        if prev == tk.ACTIVE and state != tk.ACTIVE:
            self._active_ids.discard(task_id)
            self._activation.active_delta(t.spec.tenant, -1)
        if state == tk.PENDING and prev != tk.PENDING:
            self._activation.add(t.seq, task_id, t.spec.tenant)
        self.store.append_state(task_id, state, error)

    def _finish(self, t: _Task, state: str, *, error: str | None = None,
                reports: tuple[ItemReport, ...] = ()) -> None:
        with self._cond:
            if state == tk.PAUSED and not t.pause_evt.is_set():
                state = tk.PENDING      # resume() raced the pause drain
            self._transition(t, state, error)
            if state in tk.TERMINAL:
                t.finished_s = wall_s()
            if state == tk.SUCCEEDED:
                t.item_reports = reports
            self._alloc_dirty = True
        # waiters are notified AFTER the terminal event is emitted (below),
        # so a client woken by wait() observes the event-stream effect of the
        # transition too — subscribers never lag a returned wait()
        if t.t0_mono is not None:
            # task root span: the makespan window obs.attr sweeps by default
            self.tracer.add("task", "task", t.t0_mono, mono_s(),
                            task=t.spec.task_id, tenant=t.spec.tenant,
                            state=state)
            self._m_active.add(-1, tenant=t.spec.tenant)
            t.t0_mono = None
        kind = {
            tk.SUCCEEDED: ev.SUCCEEDED, tk.FAILED: ev.FAILED,
            tk.CANCELED: ev.CANCELED, tk.PAUSED: ev.PAUSED,
            tk.PENDING: ev.RESUMED,     # pause withdrawn mid-drain
        }[state]
        payload: dict[str, Any] = {"chunks_done": t.chunks_done,
                                   "span": t.root_sid}
        if error:
            payload["error"] = error
        if state == tk.FAILED and t.fault is not None:
            payload["fault"] = t.fault.to_json()
        try:
            self.events.emit(kind, t.spec.task_id, t.spec.tenant, **payload)
            if state == tk.FAILED and t.fault is not None:
                # post-mortem flight-recorder bundle: the event ring, the
                # faulted chunk's span chain, a metrics snapshot, journal tail
                try:
                    self.recorder.dump(
                        t.spec.task_id, t.fault.kind, offset=t.fault.offset,
                        journal_path=self.store.journal_path(t.spec.task_id),
                        extra={"error": t.fault.error,
                               "chunk": t.fault.chunk, "item": t.fault.item})
                except Exception:  # noqa: BLE001 — a failing dump must never
                    pass           # mask the task failure it is documenting
        finally:
            with self._cond:
                self._cond.notify_all()

    def _task_metrics(self, t: _Task) -> dict[str, Any]:
        """The TaskStatus ``metrics`` view: per-task registry readout."""
        tid = t.spec.task_id
        ten = t.spec.tenant
        lag = obsmetrics.REGISTRY.histogram(
            "verify_lag_seconds", "move-landed -> verified delay",
            ("task",), scale=1e-5)
        return {
            "chunks": self._m_chunks.value(tenant=ten, task=tid),
            "bytes": self._m_bytes.value(tenant=ten, task=tid),
            "wire_p50_s": round(self._m_wire.quantile(0.5, task=tid), 6),
            "wire_p99_s": round(self._m_wire.quantile(0.99, task=tid), 6),
            "verify_lag_p50_s": round(lag.quantile(0.5, task=tid), 6),
            "verify_lag_p99_s": round(lag.quantile(0.99, task=tid), 6),
            "faults": {
                kind: self._m_faults.value(tenant=ten, task=tid, kind=kind)
                for kind in ("corruption", "outage", "generic", "mover_death",
                             "stale_index")
            },
            "spans": len(self.tracer.spans(tid)),
        }

    def _snapshot(self, t: _Task) -> TaskStatus:
        metrics_view = self._task_metrics(t)
        with t.lock:
            return TaskStatus(
                task_id=t.spec.task_id,
                tenant=t.spec.tenant,
                label=t.spec.label,
                state=t.state,
                error=t.error or t.failed_error,
                n_files=t.spec.n_files,
                bytes_total=t.bytes_total,
                bytes_done=t.bytes_done,
                chunks_total=t.chunks_total,
                chunks_done=t.chunks_done,
                resumed_chunks=t.resumed_chunks,
                retries=t.retries,
                movers=t.target_movers if t.state == tk.ACTIVE else 0,
                submitted_s=t.spec.submitted_s,
                started_s=t.started_s,
                finished_s=t.finished_s,
                item_reports=t.item_reports,
                refetches=t.refetches,
                outages=t.outages,
                mover_deaths=t.mover_deaths,
                failovers=t.failovers,
                scrub_repairs=t.scrub_repairs,
                fault=t.fault,
                tuning=t.tuning,
                replans=t.replans,
                chunk_bytes_current=t.chunk_bytes_now,
                stripes=self.config.stripes,
                striped_chunks=t.striped_chunks,
                chunks_deduped=t.chunks_deduped,
                wire_bytes_saved=t.wire_bytes_saved,
                dedup_demoted=t.dedup_demoted,
                pipeline=self.config.pipeline,
                cksum_seconds=round(t.cksum_s, 6),
                cksum_lag_s=round(t.cksum_lag_s, 6),
                metrics=metrics_view,
            )
