"""Span tracer — the chunk-lifecycle flight log.

A *span* is one named interval on one lane of one task: the wire time of
chunk 7's second attempt, the verify queue-wait of chunk 12, the journal
append of a commit. The engine emits them **retroactively** — it already
measures every phase for the tuner, so the tracer just records the
(t0, t1) pairs it had anyway; the hot path gains one method call and one
deque append per phase, which is how the overlap gate's <= 2% overhead
budget is met.

Span categories are a closed vocabulary shared with ``obs.attr`` (the
attribution report) — every second of a transfer's makespan folds into
exactly one of:

    plan      chunk planning / re-planning markers
    queue     chunk waited in the work queue for a mover
    wire      a mover was moving bytes (fault-excluded attempt time)
    cksum     checksum work (source fingerprint, read-back verify)
    cksum_wait  a landed chunk waited for a free verify worker
    journal   custody record append
    dedup     content-plane work: index probes, local-copy satisfaction,
              hit re-verification (cas.ChunkIndex negotiation)
    stall     fault recovery: corruption re-fetch, outage wait, backoff
    task      per-task root spans and service-level intervals

Clocks are pluggable (``obs.clock.Clock``): real engine runs trace on the
monotonic clock; virtual testbed/fabric runs hand the tracer their
``VirtualClock``, which — together with sequence-counter span ids and
sorted-key serialisation — makes a trace a pure function of the seed
(byte-identical across replays, asserted by ``tests/test_determinism.py``).

``export()`` writes Chrome ``trace_event`` JSON: load it at
https://ui.perfetto.dev (or chrome://tracing). Tasks map to processes,
lanes (movers, verifiers, hops) to threads.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
from typing import Deque, Dict, List, Optional

from .clock import Clock

# the closed category vocabulary (attr.py folds over these)
CATEGORIES = ("plan", "queue", "wire", "cksum", "cksum_wait", "journal",
              "dedup", "stall", "failover", "task")


@dataclasses.dataclass(frozen=True)
class Span:
    """One named interval on one lane of one task."""

    sid: int                 # sequence id, unique per tracer, allocation order
    name: str                # e.g. "move", "verify", "journal_append"
    cat: str                 # one of CATEGORIES
    t0: float                # clock seconds (monotonic or virtual)
    t1: float
    task: str = ""           # owning task id ("" = anonymous / engine-level)
    lane: str = ""           # mover/verifier/hop lane within the task
    args: tuple = ()         # sorted ((key, value), ...) detail pairs

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


class Tracer:
    """Bounded per-task span buffers plus Chrome trace_event export."""

    def __init__(self, clock: Optional[Clock] = None, *,
                 max_spans_per_task: int = 50_000):
        self.clock = clock or Clock.monotonic()
        self.max_spans_per_task = max_spans_per_task
        self._lock = threading.Lock()
        self._seq = 0
        self._buffers: Dict[str, Deque[Span]] = {}
        self.dropped = 0     # spans evicted from full buffers

    # -- recording ----------------------------------------------------------
    def now(self) -> float:
        return self.clock.now()

    def add(self, name: str, cat: str, t0: float, t1: float, *,
            task: str = "", lane: str = "", **args) -> int:
        """Record a completed interval; returns its span id.

        ``t0``/``t1`` must come from this tracer's clock (``now()``) or from
        the same time base (perf_counter timestamps the engine already
        took). Zero-length spans are legal — they render as instants.
        """
        if cat not in CATEGORIES:
            raise ValueError(f"unknown span category {cat!r}")
        if t1 < t0:
            t1 = t0
        packed = tuple(sorted(args.items()))
        with self._lock:
            self._seq += 1
            sid = self._seq
            buf = self._buffers.get(task)
            if buf is None:
                buf = collections.deque(maxlen=self.max_spans_per_task)
                self._buffers[task] = buf
            if len(buf) == buf.maxlen:
                self.dropped += 1
            buf.append(Span(sid, name, cat, t0, t1, task, lane, packed))
        return sid

    def mark(self, name: str, cat: str = "task", *, task: str = "",
             lane: str = "", **args) -> int:
        """Record an instant (zero-length span) at the current clock time."""
        t = self.now()
        return self.add(name, cat, t, t, task=task, lane=lane, **args)

    # -- reading ------------------------------------------------------------
    def spans(self, task: Optional[str] = None) -> List[Span]:
        """Spans in allocation (sid) order, optionally for one task."""
        with self._lock:
            if task is not None:
                out = list(self._buffers.get(task, ()))
            else:
                out = [s for buf in self._buffers.values() for s in buf]
        out.sort(key=lambda s: s.sid)
        return out

    def tasks(self) -> List[str]:
        with self._lock:
            return sorted(self._buffers)

    def chunk_chain(self, task: str, offset: int) -> List[Span]:
        """Every span belonging to the chunk at ``offset`` — its lifecycle
        chain (queue -> wire [-> stall/refetch] -> cksum -> journal), in
        time order. Stripe spans carry ``parent_offset`` pointing at their
        parent chunk, so a striped chunk's chain includes every stripe's
        sub-lifecycle. This is what the flight recorder prints for a
        faulted chunk."""
        chain = [s for s in self.spans(task)
                 if s.arg("offset") == offset
                 or s.arg("parent_offset") == offset]
        chain.sort(key=lambda s: (s.t0, s.sid))
        return chain

    # -- export -------------------------------------------------------------
    def to_trace_events(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object (deterministic).

        Tasks become processes (pid assigned by sorted task id), lanes
        become threads; process_name/thread_name metadata events label
        them. Timestamps are microseconds relative to the earliest span so
        virtual and monotonic traces both start near zero.
        """
        spans = self.spans()
        t_base = min((s.t0 for s in spans), default=0.0)
        pids = {t: i + 1 for i, t in enumerate(sorted({s.task for s in spans}))}
        tids: Dict[tuple, int] = {}
        events = []
        for t, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": t or "engine"}})
        for s in spans:
            lane_key = (s.task, s.lane)
            tid = tids.get(lane_key)
            if tid is None:
                tid = len([k for k in tids if k[0] == s.task]) + 1
                tids[lane_key] = tid
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pids[s.task], "tid": tid,
                               "args": {"name": s.lane or "main"}})
            events.append({
                "ph": "X",
                "name": s.name,
                "cat": s.cat,
                "ts": round((s.t0 - t_base) * 1e6, 3),
                "dur": round((s.t1 - s.t0) * 1e6, 3),
                "pid": pids[s.task],
                "tid": tid,
                "args": dict(s.args, sid=s.sid),
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "clock": "virtual" if self.clock.virtual else "monotonic",
                "spans": len(spans),
                "dropped": self.dropped,
            },
        }

    def export_json(self) -> str:
        """Deterministic serialisation (sorted keys, fixed separators)."""
        return json.dumps(self.to_trace_events(), sort_keys=True,
                          separators=(",", ":"))

    def export(self, path: str) -> str:
        """Write the trace_event file; returns the path."""
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(self.export_json())
        return path


class NullTracer(Tracer):
    """Recording disabled; every hook is a cheap no-op.

    Instrumented code paths take a tracer unconditionally and the engine
    defaults to this, so call sites never need ``if tracer is not None``
    guards.
    """

    def add(self, name, cat, t0, t1, *, task="", lane="", **args) -> int:  # noqa: D102
        return 0

    def mark(self, name, cat="task", *, task="", lane="", **args) -> int:  # noqa: D102
        return 0


NULL = NullTracer()
