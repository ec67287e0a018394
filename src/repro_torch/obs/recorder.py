"""Flight recorder — the "last five minutes" of every task, dumped on crash.

Facility operators debug incidents from what the system remembers about the
moments BEFORE the failure, not from what a live dashboard shows after.
The recorder keeps a bounded ring of recent events per task (cheap enough
to feed from every EventBus emit) and, when something goes wrong — a
FaultReport, a retry-budget exhaustion, a benchmark gate violation — writes
a post-mortem bundle:

  * the event ring (what the task was doing, in order);
  * the faulted chunk's full span chain from the tracer (queue -> wire ->
    re-fetch -> verify -> journal, with timings), when the trigger names a
    chunk offset;
  * a metrics snapshot (the registry's view of the world at dump time);
  * a journal tail summary (the last committed custody records — what is
    provably safe on disk vs what was in flight).

Dumps are JSON files named ``flight_<task>_<reason>.json`` in ``dump_dir``
(or returned as dicts when no dir is configured, which is what tests use).
"""
from __future__ import annotations

import collections
import json
import os
import threading
from typing import Deque, Dict, List, Optional

from .clock import wall_s
from .metrics import REGISTRY, Registry
from .trace import NULL, Tracer


def journal_tail_summary(path: str, n: int = 8) -> dict:
    """Parse the journal's last ``n`` self-checksummed records (best effort).

    Damaged or torn lines are skipped exactly as replay would skip them;
    the summary reports how many lines were readable so a truncated tail is
    visible in the dump.
    """
    if not path or not os.path.exists(path):
        return {"path": path, "present": False}
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError as exc:
        return {"path": path, "present": True, "error": str(exc)}
    lines = raw.decode("utf-8", errors="replace").splitlines()
    tail: List[dict] = []
    bad = 0
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            body = {k: rec[k] for k in
                    ("chunk_index", "offset", "length", "status")
                    if k in rec}
            if not body:
                bad += 1
                continue
            tail.append(body)
        except ValueError:
            bad += 1
    return {
        "path": path,
        "present": True,
        "records": len(tail),
        "unreadable_lines": bad,
        "tail": tail[-n:],
    }


class FlightRecorder:
    """Per-task event rings + post-mortem bundle dumps."""

    def __init__(self, *, tracer: Optional[Tracer] = None,
                 registry: Optional[Registry] = None,
                 capacity: int = 256, dump_dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.tracer = tracer if tracer is not None else NULL
        self.registry = registry if registry is not None else REGISTRY
        self.capacity = capacity
        self.dump_dir = dump_dir
        self._lock = threading.Lock()
        self._rings: Dict[str, Deque[dict]] = {}
        self.dumps: List[str] = []      # paths written (or reasons, dir-less)

    # -- feeding ------------------------------------------------------------
    def record(self, task: str, kind: str, detail: Optional[dict] = None,
               *, t: Optional[float] = None) -> None:
        """Append one event to the task's ring (drops the oldest when full)."""
        ev = {"t": wall_s() if t is None else t, "kind": kind,
              "detail": dict(detail or {})}
        with self._lock:
            ring = self._rings.get(task)
            if ring is None:
                ring = collections.deque(maxlen=self.capacity)
                self._rings[task] = ring
            ring.append(ev)

    def events(self, task: str) -> List[dict]:
        with self._lock:
            return list(self._rings.get(task, ()))

    # -- dumping ------------------------------------------------------------
    def dump(self, task: str, reason: str, *,
             offset: Optional[int] = None,
             journal_path: Optional[str] = None,
             extra: Optional[dict] = None) -> dict:
        """Build (and, with ``dump_dir``, write) a post-mortem bundle.

        ``offset`` selects the faulted chunk whose span chain to include;
        without it the bundle carries the task's most recent spans instead.
        """
        spans = self.tracer.spans(task)
        if offset is not None:
            chain = self.tracer.chunk_chain(task, offset)
        else:
            chain = spans[-32:]
        bundle = {
            "task": task,
            "reason": reason,
            "wall_time_s": wall_s(),
            "events": self.events(task),
            "span_chain": [
                {"sid": s.sid, "name": s.name, "cat": s.cat,
                 "t0": s.t0, "t1": s.t1, "dur_s": s.dur,
                 "lane": s.lane, "args": dict(s.args)}
                for s in chain
            ],
            "chunk_offset": offset,
            "total_spans": len(spans),
            "metrics": self.registry.snapshot(),
            "journal": journal_tail_summary(journal_path) if journal_path
            else {"present": False},
        }
        if extra:
            bundle["extra"] = dict(extra)
        if self.dump_dir:
            os.makedirs(self.dump_dir, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in f"{task}_{reason}")
            path = os.path.join(self.dump_dir, f"flight_{safe}.json")
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(bundle, fh, indent=1, sort_keys=True, default=repr)
            bundle["dump_path"] = path
            with self._lock:
                self.dumps.append(path)
        else:
            with self._lock:
                self.dumps.append(f"{task}:{reason}")
        return bundle
