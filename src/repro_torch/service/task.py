"""Transfer-task model: specs, the task state machine, and status snapshots.

A *task* is the service-side unit of work (the Globus "transfer task"): a set
of (source, destination) items owned by one tenant, moved chunk-by-chunk with
per-chunk integrity fingerprints and a journal that makes a restarted service
resume the task at chunk granularity.

State machine (persisted transition-by-transition in the TaskStore):

    PENDING ──► ACTIVE ──► SUCCEEDED
       │           │  ╲──► FAILED
       │           │  ╲──► CANCELED
       │           ▼
       │        PAUSED ──► PENDING   (resume re-queues; journal is kept)
       ╰──────────────────► CANCELED

A service crash records nothing: recovery treats on-disk ACTIVE as PENDING
(durable tasks) or FAILED (ephemeral in-memory sources), and the chunk journal
ensures already-moved chunks are never moved again.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.obs.clock import wall_s

# ---------------------------------------------------------------------------
# States
# ---------------------------------------------------------------------------
PENDING = "PENDING"
ACTIVE = "ACTIVE"
PAUSED = "PAUSED"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
CANCELED = "CANCELED"

STATES = (PENDING, ACTIVE, PAUSED, SUCCEEDED, FAILED, CANCELED)
TERMINAL = frozenset({SUCCEEDED, FAILED, CANCELED})

_ALLOWED: dict[str, frozenset[str]] = {
    PENDING: frozenset({ACTIVE, CANCELED, FAILED}),
    ACTIVE: frozenset({SUCCEEDED, FAILED, CANCELED, PAUSED, PENDING}),
    PAUSED: frozenset({PENDING, ACTIVE, CANCELED, FAILED}),
    SUCCEEDED: frozenset(),
    FAILED: frozenset(),
    CANCELED: frozenset(),
}


def can_transition(src: str, dst: str) -> bool:
    return dst in _ALLOWED.get(src, frozenset())


class TransitionError(RuntimeError):
    def __init__(self, task_id: str, src: str, dst: str):
        super().__init__(f"task {task_id}: illegal transition {src} -> {dst}")
        self.src, self.dst = src, dst


# ---------------------------------------------------------------------------
# Specs (persisted)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TransferItem:
    """One (source, destination) pair inside a task.

    ``mem=True`` marks an ephemeral in-process source (e.g. a checkpoint
    array); such tasks are not crash-recoverable and are failed on restart.
    """

    src: str
    dst: str
    nbytes: int
    mem: bool = False

    def to_json(self) -> dict[str, Any]:
        return {"src": self.src, "dst": self.dst, "nbytes": self.nbytes, "mem": self.mem}

    @staticmethod
    def from_json(obj: dict[str, Any]) -> "TransferItem":
        return TransferItem(obj["src"], obj["dst"], int(obj["nbytes"]), bool(obj.get("mem")))


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """The persisted description of a task — enough to re-create it on restart."""

    task_id: str
    tenant: str
    label: str
    items: tuple[TransferItem, ...]
    chunk_bytes: int | None = None
    # per-task tuning policy: "auto" closes the chunk-size loop over this
    # task's tail, "static" pins the plan; None defers to the service default
    tuning: str | None = None
    # per-task dedup policy: "on" probes the destination endpoint's chunk
    # index before moving, "off" bypasses it; None defers to the service
    dedup: str | None = None
    # per-task failover policy: "auto" lets route-aware layers (relay,
    # campaigns) re-plan around dead endpoints mid-flight, "off" pins the
    # original route; None defers to the service default
    failover: str | None = None
    submitted_s: float = dataclasses.field(default_factory=wall_s)

    @property
    def durable(self) -> bool:
        return all(not it.mem for it in self.items)

    @property
    def total_bytes(self) -> int:
        return sum(it.nbytes for it in self.items)

    @property
    def n_files(self) -> int:
        return len(self.items)

    def to_json(self) -> dict[str, Any]:
        return {
            "task_id": self.task_id,
            "tenant": self.tenant,
            "label": self.label,
            "items": [it.to_json() for it in self.items],
            "chunk_bytes": self.chunk_bytes,
            "tuning": self.tuning,
            "dedup": self.dedup,
            "failover": self.failover,
            "submitted_s": self.submitted_s,
        }

    @staticmethod
    def from_json(obj: dict[str, Any]) -> "TaskSpec":
        return TaskSpec(
            task_id=obj["task_id"],
            tenant=obj["tenant"],
            label=obj.get("label", ""),
            items=tuple(TransferItem.from_json(o) for o in obj["items"]),
            chunk_bytes=obj.get("chunk_bytes"),
            tuning=obj.get("tuning"),
            dedup=obj.get("dedup"),
            failover=obj.get("failover"),
            submitted_s=float(obj.get("submitted_s", 0.0)),
        )


# ---------------------------------------------------------------------------
# Reports / status snapshots (API surface)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultReport:
    """Structured description of the fault that failed a task.

    Attached to TaskStatus (and the FAILED event payload) only after the
    per-class retry budgets exhausted: ``kind`` names the terminal failure
    class, the coordinates pin the chunk that could not be recovered, and the
    counters record how much recovery was attempted before giving up.
    """

    kind: str          # "corruption" | "outage" | "mover_death" | "io" | "error"
    item: int
    chunk: int
    offset: int
    error: str
    retries: int = 0
    refetches: int = 0
    outages: int = 0
    mover_deaths: int = 0

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def classify_fault(exc: BaseException) -> str:
    """Map an exception from the chunk-move path to a FaultReport kind."""
    from repro_torch.core.transfer import EndpointOutage, IntegrityError, MoverCrash

    if isinstance(exc, IntegrityError):
        return "corruption"
    if isinstance(exc, EndpointOutage):
        return "outage"
    if isinstance(exc, MoverCrash):
        return "mover_death"
    if isinstance(exc, OSError):
        return "io"
    return "error"


@dataclasses.dataclass(frozen=True)
class ItemReport:
    """Per-item outcome of a SUCCEEDED task (digests come from the journal)."""

    src: str
    dst: str
    nbytes: int
    digest_hex: str
    chunk_bytes: int
    chunks: tuple[dict[str, Any], ...]   # {"index", "offset", "length", "digest"}


@dataclasses.dataclass(frozen=True)
class TaskStatus:
    """Immutable snapshot returned by the client API (status/wait)."""

    task_id: str
    tenant: str
    label: str
    state: str
    error: str | None
    n_files: int
    bytes_total: int
    bytes_done: int
    chunks_total: int
    chunks_done: int
    resumed_chunks: int
    retries: int
    movers: int
    submitted_s: float
    started_s: float | None
    finished_s: float | None
    item_reports: tuple[ItemReport, ...] = ()
    # chunk-level fault/recovery accounting (chaos-hardened recovery):
    refetches: int = 0        # corrupt chunk landings healed by source re-read
    outages: int = 0          # ops rejected by endpoint outage windows
    mover_deaths: int = 0     # movers lost mid-chunk (chunks re-queued)
    # resilience-plane accounting:
    failovers: int = 0        # route re-plans recorded against this task
    scrub_repairs: int = 0    # landed regions the scrubber healed from donors
    fault: FaultReport | None = None    # set when state == FAILED
    # autotuner accounting (tuned-vs-static visibility):
    tuning: str = "static"    # effective policy this task ran under
    replans: int = 0          # mid-flight tail re-partitions
    chunk_bytes_current: int | None = None   # nominal tail chunk size now
    # intra-chunk striping accounting (stripe-band work items):
    stripes: int = 1          # configured stripe count per eligible chunk
    striped_chunks: int = 0   # parent chunks that were split into stripes
    # content-plane accounting (dedup against the endpoint chunk index):
    chunks_deduped: int = 0   # chunks satisfied locally, no wire move
    wire_bytes_saved: int = 0 # bytes those chunks would have moved
    dedup_demoted: int = 0    # stale index hits demoted to wire moves
    # data-plane accounting (pipelined integrity engine visibility):
    pipeline: str = "serial"  # serial | single_pass | pipelined
    cksum_seconds: float = 0.0   # checksum work on the mover path (cumulative)
    cksum_lag_s: float = 0.0     # deferred-verification lag (cumulative; the
    #                              distance integrity ran behind movement)
    # observability view: per-task numbers pulled from the obs metrics
    # registry at snapshot time (wire-time quantiles, verify lag, retry
    # counts by class) — what ``transferd top`` renders per row
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL

    @property
    def latency_s(self) -> float | None:
        if self.finished_s is None:
            return None
        return self.finished_s - self.submitted_s

    @property
    def progress(self) -> float:
        return self.bytes_done / self.bytes_total if self.bytes_total else 1.0
