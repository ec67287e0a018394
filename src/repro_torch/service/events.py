"""Task event stream — progress callbacks for service clients.

Subscribers get every TaskEvent in emission order — globally, across
emitting threads. Emission (seq assignment) happens under the bus lock;
delivery drains a FIFO queue under a separate delivery lock, so two events
emitted back-to-back from different service threads can never reach
subscribers reversed. Callbacks run on service threads, so they must be
quick and must not raise; a raising subscriber is isolated (the error is
recorded, other subscribers still fire). A bounded ring buffer keeps recent
history for quick lookups.

Cursor subscription: with ``spill_path`` set, every event is also appended
to a plain JSONL spill log, and ``read_from(seq)`` / ``subscribe(cb,
from_seq=N)`` replay from an arbitrary sequence number — late joiners are
not limited to the bounded ring. The spill is an observability stream, not
the source of truth (that's the TaskStore), so it is flushed but not
fsynced; on reopen the bus resumes numbering after the last spilled seq.

Event payloads may carry a ``span`` key — the obs.trace span id of the
interval the event describes (fault events name their stall span, terminal
events the task's root span), linking the event stream to exported traces.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
from typing import Any, Callable, Iterator

from repro_torch.obs.clock import wall_s

# event kinds
SUBMITTED = "SUBMITTED"
ACTIVATED = "ACTIVATED"
PROGRESS = "PROGRESS"
RETRY = "RETRY"
# chunk-level fault observation: payload carries fault= "corruption" |
# "outage" | "mover_death", the (item, chunk, attempt) coordinates, and
# fatal=True when the fault exhausted its retry budget and failed the task.
FAULT = "FAULT"
# autotuner re-plan: the task's untransferred tail was re-partitioned.
# Payload: old_chunk_bytes, chunk_bytes (new), drained, requeued, rate_Bps.
TUNE = "TUNE"
# content-plane dedup: chunks satisfied from the endpoint's chunk index
# instead of wire moves. Payload: item, chunks (deduped count), bytes_saved,
# demoted (stale hits demoted back to wire moves).
DEDUP = "DEDUP"
# resilience plane: a route-aware layer re-planned this task's path around a
# sick endpoint/link. Payload: sick_link, new_path, resumed_chunks.
FAILOVER = "FAILOVER"
# resilience plane: a scrub pass touched this task's landed regions.
# Payload: scanned, rot_detected, repaired, quarantined.
SCRUB = "SCRUB"
REALLOC = "REALLOC"
PAUSED = "PAUSED"
RESUMED = "RESUMED"
CANCELED = "CANCELED"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"


@dataclasses.dataclass(frozen=True)
class TaskEvent:
    seq: int
    time_s: float
    kind: str
    task_id: str
    tenant: str
    payload: dict[str, Any]

    def to_json(self) -> dict:
        return {"seq": self.seq, "time_s": self.time_s, "kind": self.kind,
                "task_id": self.task_id, "tenant": self.tenant,
                "payload": self.payload}

    @classmethod
    def from_json(cls, body: dict) -> "TaskEvent":
        return cls(int(body["seq"]), float(body["time_s"]), body["kind"],
                   body["task_id"], body["tenant"], body.get("payload") or {})


class EventBus:
    def __init__(self, history: int = 4096, spill_path: str | None = None):
        self._lock = threading.Lock()
        self._subs: list[Callable[[TaskEvent], None]] = []
        self._seq = 0
        self._history: collections.deque[TaskEvent] = collections.deque(maxlen=history)
        self.subscriber_errors = 0
        # ordered delivery: emit enqueues under _lock, then whoever holds
        # _deliver_lock drains the queue in seq order. _delivered_seq is the
        # last seq handed to subscribers (cursor catch-up stops there —
        # anything later is queued and will arrive through the live path).
        self._pending: collections.deque[TaskEvent] = collections.deque()
        self._deliver_lock = threading.Lock()
        self._delivered_seq = -1
        self._delivered_cond = threading.Condition(self._lock)
        self._local = threading.local()     # reentrant-drain detection
        self._spill_path = spill_path
        self._spill_fh = None
        if spill_path is not None:
            self._seq = _resume_seq(spill_path)
            self._delivered_seq = self._seq - 1
            self._spill_fh = open(spill_path, "a", encoding="utf-8")

    def subscribe(
        self,
        cb: Callable[[TaskEvent], None],
        *,
        from_seq: int | None = None,
    ) -> Callable[[], None]:
        """Register a callback; returns an unsubscribe function.

        With ``from_seq``, the subscriber is first caught up with every
        already-delivered event at seq >= from_seq (from the ring or the
        spill log), then registered for live delivery — no gap and no
        duplicate at the seam: catch-up runs while holding the delivery
        lock, so nothing can be delivered live until the cursor replay ends
        exactly where live delivery will resume.
        """
        if from_seq is None:
            with self._lock:
                self._subs.append(cb)
        else:
            with self._deliver_lock:
                self._local.draining = True     # a cb that emits must not
                try:                            # block on its own delivery
                    with self._lock:
                        upto = self._delivered_seq
                    for ev in self.read_from(from_seq, upto=upto):
                        try:
                            cb(ev)
                        except Exception:
                            with self._lock:
                                self.subscriber_errors += 1
                    with self._lock:
                        self._subs.append(cb)
                finally:
                    self._local.draining = False
            self._drain()   # deliver anything queued while we caught up

        def unsubscribe() -> None:
            with self._lock:
                if cb in self._subs:
                    self._subs.remove(cb)

        return unsubscribe

    def emit(self, kind: str, task_id: str, tenant: str, **payload: Any) -> TaskEvent:
        with self._lock:
            ev = TaskEvent(self._seq, wall_s(), kind, task_id, tenant, payload)
            self._seq += 1
            self._history.append(ev)
            self._pending.append(ev)
            if self._spill_fh is not None:
                # flush (not fsync): the spill is a stream, not custody
                self._spill_fh.write(
                    json.dumps(ev.to_json(), default=str) + "\n")
                self._spill_fh.flush()
        self._drain()
        # emit() returns only after THIS event reached subscribers (the
        # pre-queue bus delivered synchronously; callers rely on it) — unless
        # we're inside a callback of an in-progress drain, where waiting
        # would deadlock: the queued event is delivered when the callback
        # returns to the drain loop.
        while not getattr(self._local, "draining", False):
            with self._lock:
                if self._delivered_seq >= ev.seq:
                    break
            self._drain()   # self-heal: the previous holder may be gone
            with self._delivered_cond:
                if self._delivered_seq >= ev.seq:
                    break
                self._delivered_cond.wait(0.02)
        return ev

    def _drain(self) -> None:
        """Deliver queued events in seq order.

        Exactly one thread holds _deliver_lock and delivers; emitters that
        lose the race return immediately — their event is already queued and
        the holder will deliver it. After releasing, the holder re-checks
        the queue (an emit may have enqueued between its last pop and the
        release) and loops if needed, so nothing is stranded. Reentrant
        emits from a callback land on the queue and are drained by the
        in-progress inner loop.
        """
        while True:
            if not self._deliver_lock.acquire(blocking=False):
                return
            self._local.draining = True
            try:
                while True:
                    with self._lock:
                        if not self._pending:
                            break
                        ev = self._pending.popleft()
                        subs = list(self._subs)
                    for cb in subs:
                        try:
                            cb(ev)
                        except Exception:
                            with self._lock:
                                self.subscriber_errors += 1
                    with self._lock:
                        self._delivered_seq = max(self._delivered_seq, ev.seq)
                        self._delivered_cond.notify_all()
            finally:
                self._local.draining = False
                self._deliver_lock.release()
            with self._lock:
                if not self._pending:
                    return

    def read_from(
        self,
        start_seq: int,
        *,
        limit: int | None = None,
        upto: int | None = None,
    ) -> list[TaskEvent]:
        """Events with ``start_seq <= seq`` (``<= upto`` if given), oldest
        first. Served from the ring when it still covers start_seq, else
        from the spill log; without a spill, events older than the ring are
        gone (the ring is bounded by design)."""
        with self._lock:
            ring = list(self._history)
        ring_start = ring[0].seq if ring else self._seq
        out: list[TaskEvent] = []
        if start_seq >= ring_start:
            out = [e for e in ring if e.seq >= start_seq]
        elif self._spill_path is not None:
            out = [e for e in self._iter_spill() if e.seq >= start_seq]
        else:
            out = list(ring)
        if upto is not None:
            out = [e for e in out if e.seq <= upto]
        if limit is not None:
            out = out[:limit]
        return out

    def _iter_spill(self) -> Iterator[TaskEvent]:
        if self._spill_path is None or not os.path.exists(self._spill_path):
            return
        with self._lock:
            if self._spill_fh is not None:
                self._spill_fh.flush()
        with open(self._spill_path, "r", encoding="utf-8") as fh:
            for line in fh:
                try:
                    yield TaskEvent.from_json(json.loads(line))
                except (ValueError, KeyError, TypeError):
                    continue    # torn/damaged spill line: skip, keep reading

    def history(self, kind: str | None = None) -> list[TaskEvent]:
        with self._lock:
            evs = list(self._history)
        return evs if kind is None else [e for e in evs if e.kind == kind]

    @property
    def next_seq(self) -> int:
        with self._lock:
            return self._seq

    def close(self) -> None:
        self._drain()
        with self._lock:
            if self._spill_fh is not None:
                self._spill_fh.close()
                self._spill_fh = None


def _resume_seq(spill_path: str) -> int:
    """Next seq after the last parseable spilled event.

    Tail scan with a widening window: one event line can exceed any fixed
    window (large payloads), and resuming at 0 on a parse miss would mint
    duplicate seqs, so on a miss the window doubles backwards until a
    parseable line or start-of-file is reached.
    """
    try:
        size = os.path.getsize(spill_path)
    except OSError:
        return 0
    window = 65536
    with open(spill_path, "rb") as fh:
        while True:
            start = max(0, size - window)
            fh.seek(start)
            tail = fh.read().decode("utf-8", errors="replace")
            lines = tail.splitlines()
            if start > 0 and lines:
                lines = lines[1:]   # first line may start mid-record
            for line in reversed(lines):
                try:
                    return int(json.loads(line)["seq"]) + 1
                except (ValueError, KeyError, TypeError):
                    continue
            if start == 0:
                return 0
            window *= 2
