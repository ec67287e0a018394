"""Per-endpoint chunk index: merge-law digest -> landed byte regions.

One ``ChunkIndex`` describes what content ONE endpoint (one filesystem /
staging volume) already holds, keyed by ``(digest_hex, length)`` of the
merge-law chunk fingerprint. Values are the landed locations —
``(path, offset)`` pairs — because the same content may sit in several
files (repeated checkpoint saves, replica staging dirs).

Persistence follows ``core.journal`` exactly: an append-only JSONL log
where every record is self-checksummed, replay keeps every verified
record, the torn tail after the last verified record is truncated before
reopening for append, and ``compact()`` rewrites live records with an
atomic rename. Unlike the chunk journal the index is a CACHE, not a
custody record: appends flush but do not fsync by default (losing a tail
entry across a crash costs a dedup miss, never correctness), and every
lookup hit is re-verified by a read-back fingerprint before it is
trusted — ``read_region`` + the caller's ``verify`` are the contract
that makes a stale or corrupted entry harmless.
"""
from __future__ import annotations

import dataclasses
import os
import threading

import torch

from repro_torch.core.dataplane import fingerprint_on_device, resolve_device
from repro_torch.core.integrity import Digest, verify
from repro_torch.core.journal import checked_line, replay_checked_lines
from repro_torch.obs import metrics as obsmetrics

_M_HITS = obsmetrics.REGISTRY.counter(
    "cas_index_hits_total", "dedup probes satisfied by the index", ("index",))
_M_MISSES = obsmetrics.REGISTRY.counter(
    "cas_index_misses_total", "dedup probes the index could not satisfy",
    ("index",))
_M_STALE = obsmetrics.REGISTRY.counter(
    "cas_index_stale_total",
    "index entries whose backing bytes failed re-verification", ("index",))


@dataclasses.dataclass(frozen=True)
class IndexEntry:
    """One landed location of one content chunk."""

    digest_hex: str
    length: int
    path: str
    offset: int


@dataclasses.dataclass
class DedupStats:
    """Aggregated outcome of one dedup negotiation phase."""

    probed: int = 0
    hits: int = 0              # chunks satisfied without a wire move
    bytes_saved: int = 0       # wire bytes those chunks would have cost
    demoted: int = 0           # stale/corrupt entries demoted to wire moves
    aliases: int = 0           # same-target hits (pure index insert, no copy)


class ChunkIndex:
    """Crash-safe, compactable content index for one endpoint.

    ``scope`` labels this index's metric series (defaults to the log's
    directory name). ``fsync=True`` upgrades appends to full durability —
    unnecessary for a cache, available for tests that assert replay.
    ``device`` is where ``verify_entry`` digests a donor's backing bytes
    (``"cuda"``, the default, raises at the first ``verify_entry`` where
    there is no card; ``"cpu"`` runs the kernels' plain versions) — the
    reference digests on the host. An index that never verifies, as
    ``transferd cas stats`` and ``cas gc`` use it, needs no device.
    """

    def __init__(self, path: str | os.PathLike, *, scope: str | None = None,
                 fsync: bool = False, device="cuda"):
        self._device_arg = device
        self._device: torch.device | None = None
        self.path = str(path)
        self.scope = scope or os.path.basename(os.path.dirname(self.path)) or "cas"
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None
        # (digest_hex, length) -> {(path, offset): None}  (ordered set)
        self._entries: dict[tuple[str, int], dict[tuple[str, int], None]] = {}
        self.torn_tail_bytes = 0
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        if os.path.exists(self.path):
            self._replay()
        self._fh = open(self.path, "a", encoding="utf-8")

    # -- replay ------------------------------------------------------------
    def _replay(self) -> None:
        data, valid_end = replay_checked_lines(self.path, self._apply)
        self.torn_tail_bytes = len(data) - valid_end
        if self.torn_tail_bytes:
            with open(self.path, "r+b") as fh:
                fh.truncate(valid_end)

    def _apply(self, body: dict) -> None:
        key = (body["digest"], int(body["length"]))
        loc = (body["path"], int(body["offset"]))
        if body["op"] == "put":
            self._entries.setdefault(key, {})[loc] = None
        else:  # "del"
            locs = self._entries.get(key)
            if locs is not None:
                locs.pop(loc, None)
                if not locs:
                    self._entries.pop(key, None)

    # -- appends -----------------------------------------------------------
    def _append(self, body: dict) -> None:
        line = checked_line(body)
        assert self._fh is not None
        self._fh.write(line + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def put(self, digest_hex: str, length: int, path: str, offset: int) -> bool:
        """Record a landed region; returns False if already indexed."""
        key = (digest_hex, int(length))
        loc = (str(path), int(offset))
        with self._lock:
            locs = self._entries.setdefault(key, {})
            if loc in locs:
                return False
            locs[loc] = None
            self._append({"op": "put", "digest": digest_hex,
                          "length": int(length), "path": loc[0],
                          "offset": loc[1]})
        return True

    def discard(self, digest_hex: str, length: int, path: str, offset: int) -> bool:
        """Drop one location (stale entry, deleted file); returns found."""
        key = (digest_hex, int(length))
        loc = (str(path), int(offset))
        with self._lock:
            locs = self._entries.get(key)
            if locs is None or loc not in locs:
                return False
            locs.pop(loc)
            if not locs:
                self._entries.pop(key)
            self._append({"op": "del", "digest": digest_hex,
                          "length": int(length), "path": loc[0],
                          "offset": loc[1]})
        return True

    # -- probes ------------------------------------------------------------
    def lookup(self, digest_hex: str, length: int) -> tuple[IndexEntry, ...]:
        """Every indexed location of this content (may be stale — verify!)."""
        with self._lock:
            locs = self._entries.get((digest_hex, int(length)), {})
            out = tuple(IndexEntry(digest_hex, int(length), p, o)
                        for p, o in locs)
        if out:
            _M_HITS.inc(1, index=self.scope)
        else:
            _M_MISSES.inc(1, index=self.scope)
        return out

    def note_stale(self, n: int = 1) -> None:
        """Metric hook: a hit's backing bytes failed re-verification."""
        _M_STALE.inc(n, index=self.scope)

    @staticmethod
    def read_region(entry: IndexEntry) -> bytes:
        """Read an entry's backing bytes (pread; raises OSError when gone)."""
        with open(entry.path, "rb") as fh:
            data = os.pread(fh.fileno(), entry.length, entry.offset)
        if len(data) != entry.length:
            raise OSError(
                f"indexed region truncated: {entry.path} @ {entry.offset} "
                f"has {len(data)}/{entry.length} bytes"
            )
        return data

    @property
    def device(self) -> torch.device:
        """The digest device, resolved at first use (``resolve_device``)."""
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    def verify_entry(self, entry: IndexEntry) -> bytes | None:
        """Read-back fingerprint an entry; bytes when genuine, None when
        stale (missing/truncated/corrupted backing). A stale entry is an
        expected condition, not an error; a failing device digest is an
        error and raises."""
        try:
            data = self.read_region(entry)
        except OSError:
            return None
        expected = Digest.from_bytes(bytes.fromhex(entry.digest_hex))
        if not verify(expected, fingerprint_on_device(data, self.device)):
            return None
        return data

    # -- maintenance -------------------------------------------------------
    def compact(self) -> dict:
        """Rewrite live entries only; atomic replace (same discipline as
        ``ChunkJournal.compact``). Returns before/after byte counts."""
        with self._lock:
            before = os.path.getsize(self.path) if os.path.exists(self.path) else 0
            tmp = self.path + ".compact.tmp"
            n = 0
            with open(tmp, "w", encoding="utf-8") as fh:
                for (digest_hex, length), locs in sorted(self._entries.items()):
                    for p, o in locs:
                        fh.write(checked_line(
                            {"op": "put", "digest": digest_hex,
                             "length": length, "path": p, "offset": o}) + "\n")
                        n += 1
                fh.flush()
                os.fsync(fh.fileno())
            if self._fh is not None:
                self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            self.torn_tail_bytes = 0
            after = os.path.getsize(self.path)
        return {"records": n, "bytes_before": before, "bytes_after": after}

    def stats(self) -> dict:
        with self._lock:
            n_locs = sum(len(v) for v in self._entries.values())
            indexed = sum(k[1] * len(v) for k, v in self._entries.items())
            return {
                "digests": len(self._entries),
                "locations": n_locs,
                "indexed_bytes": indexed,
                "log_bytes": os.path.getsize(self.path)
                if os.path.exists(self.path) else 0,
                "hits": _M_HITS.value(index=self.scope),
                "misses": _M_MISSES.value(index=self.scope),
                "stale": _M_STALE.value(index=self.scope),
            }

    @property
    def n_digests(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def n_locations(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._entries.values())

    def entries(self) -> tuple[IndexEntry, ...]:
        """Every live entry (deterministic order; tests + gc tooling)."""
        with self._lock:
            return tuple(
                IndexEntry(d, ln, p, o)
                for (d, ln), locs in sorted(self._entries.items())
                for p, o in locs
            )

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "ChunkIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def seed_index_from_manifest(index: ChunkIndex, manifest: dict,
                             save_dir: str | os.PathLike) -> int:
    """Register a previous checkpoint save's chunks in the index.

    A checkpoint MANIFEST.json already catalogs every leaf's chunks with
    their merge-law digests — it IS a content index of the save directory.
    Seeding the destination's ChunkIndex from it turns the next save into a
    delta: the dedup negotiation satisfies every unchanged chunk by a local
    copy from the previous save's files and only changed chunks ride the
    wire. Returns the number of entries registered.
    """
    n = 0
    for leaf in manifest.get("leaves", {}).values():
        path = os.path.abspath(os.path.join(str(save_dir), leaf["file"]))
        for c in leaf.get("chunks", ()):
            if index.put(c["digest"], int(c["length"]), path, int(c["offset"])):
                n += 1
    return n
