"""Persistent task store — the service's crash-recoverable source of truth.

Sharded for the million-task control plane. On-disk state under one root:

    <root>/tasks/shard-NNN.log          tenant-hash-sharded task event logs
    <root>/journals/<task_id>.journal   per-task chunk-completion journal
    <root>/tasks.log.migrated           pre-shard log, kept after migration

Each shard log records submissions and every state transition for the
tenants hashed onto it. Like the chunk journal (core.journal) each line is
self-checksummed; replay keeps every verified record (damaged lines in
between are skipped — each record vouches for itself) and truncates the
torn tail after the last verified record per shard before reopening for
append, so recovery never glues a new record onto a half-written line.

Submission order is NOT derived from file order: every submit record
carries its global ``seq`` explicitly, assigned under the same lock hold
that appends the record, so two interleaved submitters can never persist in
one order and number in the other — replay agrees with the live process by
construction. State records for one task always live in that task's shard
(tasks are sharded by tenant), so in-file order is authoritative for them;
when ``n_shards`` changes between incarnations a task's submit and its
newer states can sit in different files, so replay visits orphaned
wider-incarnation shards first and defers any state record seen before its
task's submit until every file has replayed.

Durability model — group commit: appends write+flush under the shard lock,
then wait for an fsync that covers them. Whoever finds the sync slot free
fsyncs ONCE for every record flushed so far (its cohort); concurrent
appenders piggyback on that fsync instead of issuing their own, and bulk
appends (``append_submit_many``) pay one fsync per touched shard for the
whole batch. Every append is still durable before it returns — the batch is
whatever accumulated while the previous fsync was in flight, so flush
latency is bounded by ~2 fsyncs. ``group_commit=False`` restores the legacy
fsync-per-append behaviour (the benchmark baseline).

Background compaction: shards accumulate dead state records forever;
when a shard's append count sufficiently exceeds its live-task count a
daemon thread rewrites it to one combined record per task (submit + last
state, seq preserved), fsyncs the temp file and atomically renames it over
the shard — replay of the compacted shard reconstructs the identical
record set. A crash leaves either the old shard or the new one, never a mix.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import threading
import zlib
from typing import IO

from repro_torch.core.journal import ChunkJournal, checked_line, replay_checked_lines
from repro_torch.service.task import PENDING, STATES, TaskSpec

DEFAULT_SHARDS = 16
# dead records a shard may accumulate before the compactor rewrites it
DEFAULT_COMPACT_SLACK = 4096

# task ids are zero-padded so lexicographic order == submission order; 9
# digits clears the million-task target with three orders of headroom (the
# legacy 06d format wrapped exactly at 10^6 tasks)
ID_WIDTH = 9


def shard_of(tenant: str, n_shards: int) -> int:
    """Stable tenant -> shard mapping (crc32: Python's str hash is salted
    per process, which would scatter a tenant across shards on restart)."""
    return zlib.crc32(tenant.encode("utf-8")) % n_shards


@dataclasses.dataclass
class TaskRecord:
    """Replayed view of one task: spec + last persisted state."""

    seq: int                     # submission order (persisted in the record)
    spec: TaskSpec
    state: str = PENDING
    error: str | None = None


class _Shard:
    """One append log: a write lock plus group-commit sync state."""

    __slots__ = ("path", "lock", "cond", "fh", "written", "synced",
                 "syncing", "appends", "task_ids")

    def __init__(self, path: str):
        self.path = path
        self.lock = threading.Lock()        # serializes write+flush and swap
        self.cond = threading.Condition()   # guards synced/syncing
        self.fh: IO[str] | None = None
        self.written = 0        # records flushed to the OS so far
        self.synced = 0         # records covered by a completed fsync
        self.syncing = False
        self.appends = 0        # records appended since the last compaction
        self.task_ids: set[str] = set()     # tasks homed on this shard


class TaskStore:
    """Sharded, self-checksummed task log + per-task chunk journals."""

    def __init__(
        self,
        root: str | os.PathLike,
        *,
        n_shards: int = DEFAULT_SHARDS,
        group_commit: bool = True,
        compact_slack: int = DEFAULT_COMPACT_SLACK,
        auto_compact: bool = True,
    ):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.root = str(root)
        self.n_shards = n_shards
        self.group_commit = group_commit
        self.compact_slack = compact_slack
        os.makedirs(os.path.join(self.root, "journals"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "tasks"), exist_ok=True)
        self.log_path = os.path.join(self.root, "tasks.log")   # legacy location
        # _lock guards records / seq counters / id reservations; shard locks
        # guard file appends. Lock order: shard.lock -> self._lock.
        self._lock = threading.Lock()
        self.records: dict[str, TaskRecord] = {}
        self._n_submitted = 0
        self._next_id = 0            # id reservation counter (>= _n_submitted)
        self.torn_tail_bytes = 0     # bytes dropped from crashed appends (all shards)
        self.fsyncs = 0              # fsync calls issued (group-commit visibility)
        self.compactions = 0

        self._shards = [
            _Shard(os.path.join(self.root, "tasks", f"shard-{i:03d}.log"))
            for i in range(n_shards)
        ]
        self._replay_seq = 0         # fallback numbering for legacy records
        # during shard replay only: state records whose task is not known
        # yet (its submit record lives in a shard that replays later —
        # possible whenever n_shards changed between incarnations)
        self._deferred_states: list[dict] | None = None
        if os.path.exists(self.log_path):
            self._migrate_legacy()
        self._replay_shards()
        with self._lock:
            if self.records:
                self._n_submitted = max(r.seq for r in self.records.values()) + 1
                self._next_id = max(
                    self._n_submitted,
                    max((_id_number(tid) for tid in self.records), default=-1) + 1,
                )
        for sh in self._shards:
            sh.fh = open(sh.path, "a", encoding="utf-8")
            sh.written = sh.synced = 0
        self._stop_evt = threading.Event()
        self._compact_evt = threading.Event()
        self._compactor: threading.Thread | None = None
        if auto_compact:
            self._compactor = threading.Thread(
                target=self._compact_loop, name="taskstore-compact", daemon=True
            )
            self._compactor.start()

    # records per submit_batch line: bounds both the line length a torn tail
    # can lose (none of it was acked) and the replay memory per line
    BATCH_LINE_CAP = 512

    # -- replay ------------------------------------------------------------
    def _replay_shards(self) -> None:
        # Shard files beyond n_shards (a previous incarnation ran wider) are
        # still replayed, and replay FIRST: they may hold a task's only
        # submit record while its newer state records live on the re-hashed
        # current shard. Replay order between files is otherwise not
        # authoritative (submits carry seq; a task's states normally share
        # its file), so states that arrive before their task's submit —
        # possible for any n_shards change, not just widening — are
        # deferred and applied once every file has replayed.
        paths = {sh.path for sh in self._shards}
        extra = sorted(
            p for p in glob.glob(os.path.join(self.root, "tasks", "shard-*.log"))
            if p not in paths
        )
        self._deferred_states = []
        for path in extra + [sh.path for sh in self._shards]:
            if not os.path.exists(path):
                continue
            data, valid_end = replay_checked_lines(path, self._apply)
            torn = len(data) - valid_end
            if torn:
                self.torn_tail_bytes += torn
                with open(path, "r+b") as fh:
                    fh.truncate(valid_end)
        deferred, self._deferred_states = self._deferred_states, None
        for body in deferred:
            self._apply_state(body)
        # home every replayed task on its shard (for compaction bookkeeping)
        for tid, rec in self.records.items():
            sh = self._shards[shard_of(rec.spec.tenant, self.n_shards)]
            sh.task_ids.add(tid)
            sh.appends += 1

    def _apply(self, body: dict) -> None:
        kind = body["type"]
        if kind == "submit":
            self._apply_submit(body)
        elif kind == "submit_batch":
            for entry in body["entries"]:
                self._apply_submit(entry)
        elif kind == "state":
            self._apply_state(body)

    def _apply_state(self, body: dict) -> None:
        rec = self.records.get(body.get("task_id"))
        if rec is None:
            # unknown task: during shard replay the submit may simply live
            # in a later-replaying shard — hold the record and retry after
            # all files are in. Outside replay (migration), drop it.
            if self._deferred_states is not None and body.get("task_id"):
                self._deferred_states.append(body)
            return
        if body.get("state") in STATES:
            rec.state = body["state"]
            rec.error = body.get("error")

    def _apply_submit(self, body: dict) -> None:
        spec = TaskSpec.from_json(body["spec"])
        seq = body.get("seq")
        if seq is None:                   # legacy record: file order numbers it
            seq = self._replay_seq
        self._replay_seq = max(self._replay_seq, int(seq) + 1)
        rec = TaskRecord(int(seq), spec)
        if "state" in body and body["state"] in STATES:       # compacted record
            rec.state = body["state"]
            rec.error = body.get("error")
        self.records[spec.task_id] = rec

    def _migrate_legacy(self) -> None:
        """One-time move of a pre-shard ``tasks.log`` into the shard files.

        Replays the legacy log, appends one combined record per task to its
        tenant's shard, fsyncs, then renames the legacy file out of the
        append path. A crash mid-migration re-runs it idempotently (replay
        overwrites by task_id; the rename is the commit point).
        """
        data, valid_end = replay_checked_lines(self.log_path, self._apply)
        self.torn_tail_bytes += len(data) - valid_end
        touched: set[int] = set()
        for tid, rec in sorted(self.records.items(), key=lambda kv: kv[1].seq):
            idx = shard_of(rec.spec.tenant, self.n_shards)
            touched.add(idx)
            with open(self._shards[idx].path, "a", encoding="utf-8") as fh:
                fh.write(checked_line(_combined_body(rec)) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        self.records.clear()            # shards are authoritative from here
        self._replay_seq = 0
        os.replace(self.log_path, self.log_path + ".migrated")

    # -- appends -----------------------------------------------------------
    def _write_locked(self, sh: _Shard, body: dict, n_records: int = 1) -> int:
        """Append one checked line to a shard (caller holds ``sh.lock``);
        returns the write watermark a commit must cover. ``n_records`` is how
        many task records the line carries (batch lines hold many)."""
        assert sh.fh is not None
        sh.fh.write(checked_line(body) + "\n")
        sh.fh.flush()
        sh.written += 1
        sh.appends += n_records
        return sh.written

    def _commit(self, sh: _Shard, upto: int) -> None:
        """Group commit: return once an fsync covering ``upto`` completed.

        The first waiter to find the sync slot free fsyncs for everyone
        flushed so far; the rest piggyback. A record is never reported
        durable before its bytes are fsynced.
        """
        if not self.group_commit:
            # legacy mode: fsync under the shard write lock, per append
            with sh.lock:
                if sh.fh is not None and sh.synced < upto:
                    os.fsync(sh.fh.fileno())
                    self.fsyncs += 1
                    sh.synced = sh.written
            return
        while True:
            with sh.cond:
                if sh.synced >= upto:
                    return
                if sh.syncing:
                    sh.cond.wait(0.05)
                    continue
                sh.syncing = True
            # target: everything flushed before the fsync starts is covered
            with sh.lock:
                target = sh.written
                fh = sh.fh
            try:
                if fh is not None:
                    os.fsync(fh.fileno())
                    self.fsyncs += 1
            finally:
                with sh.cond:
                    sh.syncing = False
                    sh.synced = max(sh.synced, target)
                    sh.cond.notify_all()

    def append_submit(self, spec: TaskSpec) -> TaskRecord:
        """Persist one submission; seq assignment, the log append and the
        in-memory record commit happen under ONE shard-lock hold, so replay
        order and live order can never disagree."""
        sh = self._shards[shard_of(spec.tenant, self.n_shards)]
        with sh.lock:
            with self._lock:
                seq = self._n_submitted
                self._n_submitted += 1
                self._next_id = max(self._next_id, seq + 1)
                rec = TaskRecord(seq, spec)
                self.records[spec.task_id] = rec
            sh.task_ids.add(spec.task_id)
            upto = self._write_locked(
                sh, {"type": "submit", "seq": seq, "spec": spec.to_json()})
        self._commit(sh, upto)
        self._maybe_compact(sh)
        return rec

    def append_submit_many(self, specs: list[TaskSpec]) -> list[TaskRecord]:
        """Bulk submission: per touched shard, ONE self-checksummed batch
        line (amortizing serialization + checksum over the batch) and ONE
        fsync — the group-commit amortization bulk clients rely on. Seqs are
        assigned in input order and persisted inside each entry, so replay
        reconstructs the exact submission order regardless of how the batch
        interleaved with concurrent single submits on other shards. Nothing
        is acknowledged until every touched shard's fsync covers it; a torn
        batch line on crash loses only unacknowledged submissions.
        """
        recs: list[TaskRecord] = []
        by_shard: dict[int, list[tuple[int, TaskSpec]]] = {}
        with self._lock:
            for spec in specs:
                seq = self._n_submitted
                self._n_submitted += 1
                self._next_id = max(self._next_id, seq + 1)
                rec = TaskRecord(seq, spec)
                self.records[spec.task_id] = rec
                recs.append(rec)
                by_shard.setdefault(
                    shard_of(spec.tenant, self.n_shards), []).append((seq, spec))
        marks: dict[int, int] = {}          # shard idx -> write watermark
        for idx, entries in by_shard.items():
            sh = self._shards[idx]
            with sh.lock:
                for i in range(0, len(entries), self.BATCH_LINE_CAP):
                    part = entries[i:i + self.BATCH_LINE_CAP]
                    marks[idx] = self._write_locked(
                        sh,
                        {"type": "submit_batch",
                         "entries": [{"seq": s, "spec": sp.to_json()}
                                     for s, sp in part]},
                        n_records=len(part))
                sh.task_ids.update(sp.task_id for _s, sp in entries)
        for idx, upto in marks.items():
            self._commit(self._shards[idx], upto)
        for idx in marks:
            self._maybe_compact(self._shards[idx])
        return recs

    def append_state(self, task_id: str, state: str, error: str | None = None) -> None:
        with self._lock:
            rec = self.records.get(task_id)
        if rec is None:
            return
        sh = self._shards[shard_of(rec.spec.tenant, self.n_shards)]
        with sh.lock:
            upto = self._write_locked(
                sh, {"type": "state", "task_id": task_id, "state": state,
                     "error": error})
            # memory commit under the same lock hold as the append: state
            # records replay in file order, which is now also update order
            rec.state = state
            rec.error = error
        self._commit(sh, upto)
        self._maybe_compact(sh)

    # -- compaction --------------------------------------------------------
    def _maybe_compact(self, sh: _Shard) -> None:
        if self._compactor is None:
            return
        with sh.lock:
            needed = self._needs_compact(sh)
        if needed:
            self._compact_evt.set()

    def _needs_compact(self, sh: _Shard) -> bool:
        dead = sh.appends - len(sh.task_ids)
        return dead > self.compact_slack and sh.appends > 2 * len(sh.task_ids)

    def _compact_loop(self) -> None:
        while not self._stop_evt.is_set():
            self._compact_evt.wait(0.5)
            self._compact_evt.clear()
            if self._stop_evt.is_set():
                return
            for sh in self._shards:
                with sh.lock:
                    needed = self._needs_compact(sh)
                if needed:
                    try:
                        self.compact_shard(sh)
                    except Exception:  # noqa: BLE001 — compaction is an
                        pass           # optimization; appends must survive it

    def _quiesce_and_lock(self, sh: _Shard) -> None:
        """Acquire ``sh.lock`` with no group-commit fsync in flight.

        Never waits for ``syncing`` while holding ``sh.lock``: a committer
        claims the sync slot under ``sh.cond`` and then needs ``sh.lock``
        to capture the fd and watermark, so waiting here with the lock held
        would deadlock against it (each side holding what the other needs,
        wedging every later append on the shard). Instead wait first, then
        take the lock and re-check — if a committer claimed the slot in the
        gap, back off and wait again. Once this returns, no committer can
        touch the old fd: claiming the slot is not enough, capturing the fd
        needs the lock we now hold.
        """
        while True:
            with sh.cond:
                while sh.syncing:
                    sh.cond.wait()
            sh.lock.acquire()
            with sh.cond:
                if not sh.syncing:
                    return
            sh.lock.release()

    def compact_shard(self, sh: _Shard) -> dict:
        """Rewrite one shard to combined live records only; atomic replace."""
        self._quiesce_and_lock(sh)      # excludes appends and in-flight fsyncs
        try:
            before = os.path.getsize(sh.path) if os.path.exists(sh.path) else 0
            with self._lock:
                live = sorted(
                    (self.records[tid] for tid in sh.task_ids
                     if tid in self.records),
                    key=lambda r: r.seq,
                )
                lines = [checked_line(_combined_body(rec)) for rec in live]
            tmp = sh.path + ".compact.tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                for line in lines:
                    fh.write(line + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            if sh.fh is not None:
                sh.fh.close()
            os.replace(tmp, sh.path)
            sh.fh = open(sh.path, "a", encoding="utf-8")
            with sh.cond:
                sh.synced = sh.written      # everything live is in the new file
            sh.appends = len(lines)
            after = os.path.getsize(sh.path)
            self.compactions += 1
        finally:
            sh.lock.release()
        return {"records": len(lines), "bytes_before": before,
                "bytes_after": after}

    def compact(self) -> dict:
        """Force-compact every shard (tests / CLI); returns totals."""
        totals = {"records": 0, "bytes_before": 0, "bytes_after": 0}
        for sh in self._shards:
            out = self.compact_shard(sh)
            for k in totals:
                totals[k] += out[k]
        return totals

    # -- journals ----------------------------------------------------------
    def journal_path(self, task_id: str) -> str:
        return os.path.join(self.root, "journals", f"{task_id}.journal")

    def open_journal(self, task_id: str) -> ChunkJournal:
        return ChunkJournal(self.journal_path(task_id))

    def next_task_id(self, tenant: str) -> str:
        """Mint a unique task id. Each call RESERVES its number (the legacy
        implementation read the submit counter without reserving, so two
        concurrent callers minted the same id and the second submit silently
        overwrote the first's TaskRecord)."""
        with self._lock:
            n = self._next_id
            self._next_id += 1
        return f"task-{n:0{ID_WIDTH}d}-{tenant}"

    def shard_paths(self) -> list[str]:
        return [sh.path for sh in self._shards]

    def close(self) -> None:
        self._stop_evt.set()
        self._compact_evt.set()
        if self._compactor is not None:
            self._compactor.join(timeout=5.0)
        for sh in self._shards:
            # quiesce first: closing under sh.lock alone could yank the fd
            # out from under a committer that captured it and is about to
            # fsync (ValueError mid-shutdown). A committer arriving after
            # the close finds fh=None and skips the fsync.
            self._quiesce_and_lock(sh)
            try:
                if sh.fh is not None:
                    sh.fh.close()
                    sh.fh = None
            finally:
                sh.lock.release()

    def __enter__(self) -> "TaskStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _combined_body(rec: TaskRecord) -> dict:
    """Submit record folding in the last persisted state (compaction and
    migration write these; replay reconstructs the identical TaskRecord)."""
    body = {"type": "submit", "seq": rec.seq, "spec": rec.spec.to_json()}
    if rec.state != PENDING or rec.error is not None:
        body["state"] = rec.state
        body["error"] = rec.error
    return body


def _id_number(task_id: str) -> int:
    """Numeric reservation component of ``task-NNN...-tenant`` ids (used to
    resume the id allocator past every id ever persisted)."""
    try:
        return int(task_id.split("-", 2)[1])
    except (IndexError, ValueError):
        return -1
