"""Chunk-completion journal — fault tolerance at chunk granularity.

"The implementation keeps track of which chunks have been transmitted
successfully so as to enable efficient partial restarts upon failures."
(paper §3.1). The journal is an append-only JSON-lines file; every record is
self-checksummed so torn writes (host crash mid-append) are detected on
replay.

Crash-consistency model: every record vouches for itself via its own
checksum, so replay keeps every verified record wherever it sits — damaged
lines in between (bit rot, or the legacy glued-line artifact of appending
onto a torn tail) are skipped without distrusting what follows. Only the
torn tail — the unverified bytes after the LAST verified record, i.e. a
crashed final append — is truncated away before the journal reopens for
appending, so a new record is never glued onto a half-written line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import IO

from repro_torch.core.integrity import Digest, fingerprint_bytes


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    chunk_index: int
    offset: int
    length: int
    digest_hex: str
    status: str = "done"     # "done" | "failed"

    def digest(self) -> Digest:
        return Digest.from_bytes(bytes.fromhex(self.digest_hex))


def _self_check(payload: str) -> str:
    return fingerprint_bytes(payload.encode()).hexdigest()[:16]


def checked_line(body: dict) -> str:
    """Serialise one self-checksummed JSONL record (no trailing newline).

    Shared by every append-log in the repo (chunk journal, task log, CAS
    chunk index) so compaction and replay agree on the byte format.
    """
    # Serialise the body once: embed the canonical (sort_keys) form directly
    # rather than dumping it a second time inside the wrapper. Replay parses
    # the line and re-canonicalises the body, so the bytes verify either way.
    canon = json.dumps(body, sort_keys=True)
    return '{"body": %s, "check": "%s"}' % (canon, _self_check(canon))


def replay_checked_lines(path: str, apply) -> tuple[bytes, int]:
    """Replay a self-checksummed JSONL file with crash-consistent repair.

    Calls ``apply(body)`` for each verified record, in order. Every record
    carries its own checksum, so each one vouches for itself independently:

    * a DAMAGED line (garbled JSON or failed self-check) is skipped, and
      replay continues — a later record that passes its self-check is
      genuine regardless of earlier damage. This also tolerates the legacy
      glued-line artifact (an appender that wrote a fresh record onto a torn
      partial line) without sacrificing anything that follows it;
    * the TORN TAIL — everything after the last verified record (a crashed
      final append, trailing garbage, or an unterminated line) — is excluded
      from the returned ``valid_end`` so callers may truncate it and new
      appends start on a clean line;
    * a SEMANTIC failure — ``apply`` raises on a record whose self-check
      passed (e.g. a record written by a newer code version) — stops further
      application, but the bytes are intact and stay inside ``valid_end``:
      truncating well-formed records over a schema mismatch would turn an
      upgrade/downgrade into data loss.

    Returns ``(raw_bytes, valid_end)`` where ``valid_end`` is the byte
    offset just past the last verified record. Shared by the chunk journal
    and the service task log (service.store).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    valid_end = 0
    applying = True
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            break                      # unterminated tail: torn final append
        line = data[pos:nl].strip()
        pos = nl + 1
        if not line:
            continue
        try:
            obj = json.loads(line.decode("utf-8"))
            body = obj["body"]
            verified = obj["check"] == _self_check(json.dumps(body, sort_keys=True))
        except Exception:              # noqa: BLE001 — damaged line
            verified = False
        if not verified:
            continue                   # skip: later records vouch for themselves
        valid_end = pos
        if applying:
            try:
                apply(body)
            except Exception:          # noqa: BLE001 — semantic: stop applying
                applying = False
    return data, valid_end


class ChunkJournal:
    """Append-only, crash-tolerant record of per-chunk completion."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._fh: IO[str] | None = None
        # appends must serialize: concurrent movers writing through one text
        # handle could interleave two records into one garbled line, and the
        # stop-at-first-damage replay would (correctly) distrust everything
        # after it — losing valid fsync'd records.
        self._append_lock = threading.Lock()
        self.records: dict[int, JournalRecord] = {}
        self.torn_tail_bytes = 0     # bytes dropped from a crashed append
        if os.path.exists(self.path):
            self._replay()
        self._fh = open(self.path, "a", encoding="utf-8")

    # ------------------------------------------------------------------
    def _replay(self) -> None:
        data, valid_end = replay_checked_lines(self.path, self._apply)
        self.torn_tail_bytes = len(data) - valid_end
        if self.torn_tail_bytes:
            # repair: drop the torn tail so the next append starts on a
            # clean line instead of gluing onto the half-written record
            with open(self.path, "r+b") as fh:
                fh.truncate(valid_end)

    def _apply(self, body: dict) -> None:
        rec = JournalRecord(**body)
        if rec.status == "done":
            self.records[rec.chunk_index] = rec
        else:
            self.records.pop(rec.chunk_index, None)

    def append(self, rec: JournalRecord) -> None:
        line = checked_line(dataclasses.asdict(rec))
        with self._append_lock:
            assert self._fh is not None
            self._fh.write(line + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            if rec.status == "done":
                self.records[rec.chunk_index] = rec
            else:
                self.records.pop(rec.chunk_index, None)

    def compact(self) -> dict:
        """Rewrite the log to live records only; atomic replace.

        Journals grow without bound across repeated saves: every "failed"
        record and every superseded append stays on disk forever. Compaction
        rewrites the current live-record set (sorted by chunk id) into a
        temp file, fsyncs it, and atomically renames it over the log, then
        reopens the append handle — a crash at any point leaves either the
        old log or the complete new one, never a mix. Returns
        ``{"records", "bytes_before", "bytes_after"}``.
        """
        with self._append_lock:
            before = os.path.getsize(self.path) if os.path.exists(self.path) else 0
            tmp = self.path + ".compact.tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                for idx in sorted(self.records):
                    fh.write(checked_line(dataclasses.asdict(self.records[idx])) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            if self._fh is not None:
                self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            self.torn_tail_bytes = 0
            after = os.path.getsize(self.path)
        return {"records": len(self.records), "bytes_before": before,
                "bytes_after": after}

    # ------------------------------------------------------------------
    def completed(self) -> set[int]:
        return set(self.records)

    def is_complete(self, n_chunks: int) -> bool:
        return len(self.records) == n_chunks and set(self.records) == set(range(n_chunks))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "ChunkJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
