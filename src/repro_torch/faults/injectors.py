"""Deterministic, seedable fault injection for the transfer stack.

A ``FaultCampaign`` is one concrete realisation of a ``Scenario`` against one
transfer (or one service workload): it wraps the transfer's ``ByteSource`` /
``ByteDest`` endpoints and injects

  * **silent bit-flip corruption** — one-shot byte flips at a configured
    bytes-per-error rate (the paper's Globus logs: ~1 per 1.26 TB, §2.3),
    applied to the data *after* the source-side fingerprint was taken, so
    only the destination read-back digest can catch them;
  * **mover deaths mid-chunk** — after a partial (torn) chunk write the
    worker thread is killed with ``MoverCrash``; the chunk must be re-queued
    and re-moved by a surviving (or respawned) mover;
  * **stalled/straggler movers** — one-shot wall-clock stalls in the write
    path (speculative duplication territory);
  * **endpoint outages** — once the transfer crosses a progress fraction,
    the next N reads/writes raise ``EndpointOutage`` (the engine/service must
    wait the window out on the outage budget, not the chunk retry budget);
  * **torn journal tails** — ``tear_journal_tail`` truncates a journal
    mid-way through its final record, the on-disk state a crash mid-append
    leaves behind.

Everything is deterministic given ``(scenario, seed, total_bytes)``: the
random realisation comes from a private ``random.Random`` seeded through
SHA-256 (never the process-salted ``hash``), so a failing campaign replays
bit-for-bit. All counters live in ``FaultCampaign.stats`` so conformance
suites can assert *every* injected fault was observed and healed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import threading
import time

from repro_torch.core.transfer import ByteDest, ByteSource, EndpointOutage, MoverCrash
from repro_torch.faults.scenarios import Scenario


def _seed_int(*parts) -> int:
    blob = "|".join(repr(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")


@dataclasses.dataclass
class FaultStats:
    """What a campaign actually injected (the conformance ground truth)."""

    corruptions_injected: int = 0    # individual byte flips
    corrupt_writes: int = 0          # writes that landed >=1 flip (each must
                                     # cost exactly one read-back catch + re-fetch)
    corrupted_bytes: int = 0
    mover_kills: int = 0
    outage_rejections: int = 0       # window rejections (outage/down/flap)
    brownout_rejections: int = 0     # single-op brownout rejections
    stalls: int = 0
    torn_tail_bytes: int = 0
    stale_index_corruptions: int = 0  # chunk-index entries whose backing
                                      # bytes were corrupted under them
    landed_bitrot_flips: int = 0      # post-landing bit flips in verified
                                      # destination regions (scrub territory)


class FaultCampaign:
    """Binds a Scenario to one transfer: wrapped endpoints + injected faults.

    ``total_bytes`` is the goodput size of the transfer (sum of item sizes
    for a service task set); progress fractions and the corruption stream are
    measured against it. ``movers`` caps mover kills at the pool size (so the
    ``kill_all_movers`` scenario kills each mover once, forcing a respawn,
    instead of killing replacements forever). ``item_bytes`` lists the item
    sizes of ONE service task, in item order, so each item's local write
    offsets map into a distinct region of the [0, total_bytes) corruption
    plan; a campaign is scoped to a single task (or a single raw transfer) —
    use one campaign per task for multi-task workloads.
    """

    def __init__(
        self,
        scenario: Scenario,
        *,
        total_bytes: int,
        seed: int = 0,
        movers: int | None = None,
        item_bytes: "list[int] | tuple[int, ...] | None" = None,
    ):
        self.scenario = scenario
        self.total_bytes = int(total_bytes)
        self.seed = seed
        self.stats = FaultStats()
        self._lock = threading.Lock()
        self._rng = random.Random(_seed_int(seed, scenario.name, total_bytes))

        # corruption plan: one-shot byte OFFSETS in [0, total_bytes), drawn
        # by exponential inter-arrival skips so the expected count is
        # total/bytes_per_error. Keyed by offset (not stream position) and
        # popped on application: a re-fetched chunk re-writes the same
        # offsets, finds its positions consumed, and is guaranteed to heal —
        # matching reality, where re-reading after a random corruption does
        # not re-corrupt the same bytes.
        self._corrupt: dict[int, int] = {}
        if scenario.bytes_per_error is not None and self.total_bytes > 0:
            pos = self._rng.expovariate(1.0 / scenario.bytes_per_error)
            while pos < self.total_bytes:
                mask = 1 << self._rng.randrange(8)          # one flipped bit
                self._corrupt[int(pos)] = mask
                pos += self._rng.expovariate(1.0 / scenario.bytes_per_error)
        self.planned_corruptions = len(self._corrupt)

        # per-item offset bases: a service task's items each see LOCAL write
        # offsets in [0, item_size), but the corruption plan spans the whole
        # workload [0, total_bytes). ``item_bytes`` maps item i to the base
        # sum(sizes[:i]) so every planned offset is reachable and two items
        # never collide on the same plan position; without it (single-item /
        # raw-engine campaigns) the base is 0.
        self._item_base: dict[int, int] = {}
        if item_bytes is not None:
            base = 0
            for i, nb in enumerate(item_bytes):
                self._item_base[i] = base
                base += int(nb)

        # brownout marks: seeded byte positions whose covering write is
        # rejected once (keyed by position, like the corruption plan, so the
        # realisation is deterministic regardless of mover interleaving)
        self._brownout: set[int] = set()
        if scenario.brownout_events > 0 and self.total_bytes > 0:
            want = min(scenario.brownout_events, self.total_bytes)
            while len(self._brownout) < want:
                self._brownout.add(self._rng.randrange(self.total_bytes))

        self._written = 0            # stream position: bytes successfully written
        kills = scenario.kill_movers
        if movers is not None:
            kills = min(kills, movers)
        self._kills_left = kills
        self._kill_at = int(scenario.kill_at_frac * self.total_bytes)
        # outage windows, generalised: (arm-at-bytes, rejected-ops) pairs.
        # The classic single window, the hard endpoint-death window, and the
        # evenly-spread flap windows all share one arming mechanism.
        self._windows: list[tuple[int, int]] = []
        if scenario.outage_at_frac is not None:
            self._windows.append((int(scenario.outage_at_frac * self.total_bytes),
                                  scenario.outage_ops))
        if scenario.down_at_frac is not None:
            self._windows.append((int(scenario.down_at_frac * self.total_bytes),
                                  scenario.down_ops))
        for i in range(scenario.link_flaps):
            frac = (i + 1) / (scenario.link_flaps + 1)
            self._windows.append((int(frac * self.total_bytes),
                                  scenario.flap_ops))
        self._windows.sort()
        self._outage_ops_left = 0
        self._stalls_left = scenario.stall_movers

    # ------------------------------------------------------------------
    # per-op fault decisions (all under the campaign lock)
    # ------------------------------------------------------------------
    def _check_outage(self) -> None:
        while self._windows and self._written >= self._windows[0][0]:
            self._outage_ops_left += self._windows.pop(0)[1]
        if self._outage_ops_left > 0:
            self._outage_ops_left -= 1
            self.stats.outage_rejections += 1
            raise EndpointOutage(
                f"endpoint outage window: {self._outage_ops_left} rejections left"
            )

    def _check_brownout(self, offset: int, length: int) -> None:
        """Reject the write covering an unconsumed brownout mark (one-shot:
        the retry of the same write finds its mark consumed and succeeds)."""
        if not self._brownout:
            return
        lo, hi = offset, offset + length
        for p in self._brownout:
            if lo <= p < hi:
                self._brownout.discard(p)
                self.stats.brownout_rejections += 1
                raise EndpointOutage(f"brownout: op covering byte {p} refused")

    def _maybe_kill(self) -> bool:
        if self._kills_left > 0 and self._written >= self._kill_at:
            self._kills_left -= 1
            self.stats.mover_kills += 1
            return True
        return False

    def _maybe_stall(self) -> float:
        if self._stalls_left > 0:
            self._stalls_left -= 1
            self.stats.stalls += 1
            return self.scenario.stall_s
        return 0.0

    def _apply_corruption(self, offset: int, data: bytes) -> bytes:
        """Consume corruption offsets covered by this write (one-shot)."""
        if not self._corrupt:
            return data
        lo, hi = offset, offset + len(data)
        hits = [p for p in self._corrupt if lo <= p < hi]
        if not hits:
            return data
        buf = bytearray(data)
        for p in hits:
            buf[p - lo] ^= self._corrupt.pop(p)
            self.stats.corruptions_injected += 1
            self.stats.corrupted_bytes += 1
        self.stats.corrupt_writes += 1
        return bytes(buf)

    # ------------------------------------------------------------------
    # endpoint wrappers
    # ------------------------------------------------------------------
    def wrap_source(self, inner: ByteSource) -> "FaultySource":
        return FaultySource(self, inner)

    def wrap_dest(self, inner: ByteDest, *, base: int = 0) -> "FaultyDest":
        return FaultyDest(self, inner, base=base)

    # service-flavoured wrappers (TransferService passes task/item context).
    # Only the dest needs the per-item base: corruption is applied on the
    # write path, sources only see outage windows.
    def service_source_wrapper(self, task_id: str, item_idx: int,
                               inner: ByteSource) -> "FaultySource":
        return self.wrap_source(inner)

    def service_dest_wrapper(self, task_id: str, item_idx: int,
                             inner: ByteDest) -> "FaultyDest":
        return self.wrap_dest(inner, base=self._item_base.get(item_idx, 0))


class FaultySource:
    """ByteSource wrapper: outage windows hit reads too."""

    def __init__(self, campaign: FaultCampaign, inner: ByteSource):
        self._c, self._inner = campaign, inner
        self.nbytes = inner.nbytes

    def read(self, offset: int, length: int) -> bytes:
        with self._c._lock:
            self._c._check_outage()
        return self._inner.read(offset, length)


class FaultyDest:
    """ByteDest wrapper: the write path is where corruption lands, movers
    die mid-chunk (torn writes), and stragglers stall. Verification reads
    (``read_back``) pass through untouched — the read-back must see exactly
    the bytes that landed, or the integrity check would be theatre."""

    def __init__(self, campaign: FaultCampaign, inner: ByteDest, *, base: int = 0):
        self._c, self._inner = campaign, inner
        self._base = base

    def write(self, offset: int, data: bytes) -> None:
        c = self._c
        with c._lock:
            c._check_outage()
            c._check_brownout(self._base + offset, len(data))
            kill = c._maybe_kill()
            stall = 0.0 if kill else c._maybe_stall()
            if not kill:
                data = c._apply_corruption(self._base + offset, data)
                c._written += len(data)
        if kill:
            # torn chunk write: half the bytes land, then the mover dies.
            self._inner.write(offset, data[: len(data) // 2])
            raise MoverCrash(f"mover killed mid-write at offset {offset}")
        if stall:
            time.sleep(stall)
        self._inner.write(offset, data)

    def read_back(self, offset: int, length: int) -> bytes:
        return self._inner.read_back(offset, length)


# ---------------------------------------------------------------------------
# torn journal tails
# ---------------------------------------------------------------------------
def tear_journal_tail(path: str | os.PathLike, *, seed: int = 0,
                      cut_at: int | None = None) -> int:
    """Truncate a journal mid-way through its final record (crash mid-append).

    Picks a cut point strictly inside the last line (seeded, deterministic)
    unless ``cut_at`` gives an absolute byte offset. Returns the number of
    bytes removed. Replay must stop cleanly at the torn record and keep every
    complete record before it (core.journal's crash-consistency contract).
    """
    path = str(path)
    with open(path, "rb") as fh:
        data = fh.read()
    stripped = data.rstrip(b"\n")
    if not stripped:
        return 0
    start = stripped.rfind(b"\n") + 1        # first byte of the last record
    if cut_at is None:
        if len(stripped) - start < 2:
            cut_at = start               # 1-byte record: drop it whole
        else:
            rng = random.Random(_seed_int(seed, "tear", len(data)))
            # keep >=1 byte of the record, never its trailing newline:
            # the on-disk result is a genuinely torn, unterminated line
            cut_at = rng.randrange(start + 1, len(stripped))
    if not (0 <= cut_at <= len(data)):
        raise ValueError(f"cut_at {cut_at} outside file of {len(data)} bytes")
    with open(path, "r+b") as fh:
        fh.truncate(cut_at)
    return len(data) - cut_at


# ---------------------------------------------------------------------------
# stale chunk-index entries
# ---------------------------------------------------------------------------
def corrupt_index_backing(index, *, count: int, seed: int = 0,
                          stats: FaultStats | None = None) -> list:
    """Flip one byte behind each of ``count`` seeded victim chunk-index
    entries — the on-disk state an overwrite/bit-rot leaves behind: the index
    still promises content its backing path no longer holds.

    Victims are drawn deterministically from the index's live entries (seeded
    through SHA-256, one flipped bit at a seeded offset inside the entry's
    byte region). Returns the victim entries. The dedup path's contract under
    this fault: every probe that hits a victim must re-verify the backing
    bytes, demote the chunk to a wire move, and quarantine the entry — a
    lying index must never become an integrity escape.
    """
    entries = sorted(index.entries(),
                     key=lambda e: (e.path, e.offset, e.digest_hex))
    entries = [e for e in entries if e.length > 0 and os.path.exists(e.path)]
    if not entries or count <= 0:
        return []
    rng = random.Random(_seed_int(seed, "stale_index", len(entries)))
    victims = rng.sample(entries, min(count, len(entries)))
    for e in victims:
        flip_at = e.offset + rng.randrange(e.length)
        mask = 1 << rng.randrange(8)
        with open(e.path, "r+b") as fh:
            fh.seek(flip_at)
            byte = fh.read(1)
            if not byte:
                continue
            fh.seek(flip_at)
            fh.write(bytes([byte[0] ^ mask]))
        if stats is not None:
            stats.stale_index_corruptions += 1
    return victims


# ---------------------------------------------------------------------------
# landed bit-rot
# ---------------------------------------------------------------------------
def corrupt_landed_regions(regions, *, count: int, seed: int = 0,
                           stats: FaultStats | None = None) -> list:
    """Flip one bit inside each of ``count`` seeded victim LANDED regions —
    the decay storage inflicts after a transfer already read-back verified,
    journaled, and reported success (the Petascale DTN finding: corruption
    discovered *after* "successful" transfers).

    ``regions`` is an iterable of ``(path, offset, length)`` triples (e.g.
    built from a SUCCEEDED task's item-report chunks). Victims and flip
    positions are drawn deterministically through SHA-256, mirroring
    ``corrupt_index_backing``. Returns the victim triples. The scrub daemon's
    contract under this fault: every flipped region must be detected against
    its journal digest and either repaired from a verified replica or
    quarantined — never trusted again silently.
    """
    regions = sorted(
        (str(p), int(o), int(ln)) for p, o, ln in regions
        if int(ln) > 0 and os.path.exists(str(p))
    )
    if not regions or count <= 0:
        return []
    rng = random.Random(_seed_int(seed, "bitrot_landed", len(regions)))
    victims = rng.sample(regions, min(count, len(regions)))
    for path, offset, length in victims:
        flip_at = offset + rng.randrange(length)
        mask = 1 << rng.randrange(8)
        with open(path, "r+b") as fh:
            fh.seek(flip_at)
            byte = fh.read(1)
            if not byte:
                continue
            fh.seek(flip_at)
            fh.write(bytes([byte[0] ^ mask]))
        if stats is not None:
            stats.landed_bitrot_flips += 1
    return victims
