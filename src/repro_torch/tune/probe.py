"""Transfer telemetry — the measurement half of the closed chunking loop.

The paper's automated client-driven chunking (§6) needs *observations* before
it can adapt: per-chunk goodput, checksum latency, and retry amplification,
sampled from the data movers while the transfer is in flight. ``ChunkSample``
is one mover's report of one landed chunk; ``TransferProbe`` aggregates a
sliding window of them into the signals the controller consumes.

Two accounting rules matter and are enforced here, not in the controller:

  * **fault exclusion** — the rate signal uses ``attempt_seconds``: the
    successful attempt plus any *congestion-like* generic-I/O retries
    (loss IS the path slowing down and must be felt). Time burned by
    corruption-triggered re-fetches and outage waits is excluded, so
    injected faults (the fault campaigns of ``faults``) cannot masquerade as congestion and
    drive the chunk size to the floor. Fault pressure is still visible —
    as ``retry_amplification`` and ``fault_refetches`` — it just feeds
    reporting, not the congestion signal;
  * **no wall clock** — the probe never reads ``time.*``. Every timestamp
    arrives inside the sample, so replaying a recorded sample stream through
    the probe (or the controller above it) is bit-for-bit deterministic.
"""
from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass(frozen=True)
class ChunkSample:
    """One mover's telemetry for one landed chunk."""

    offset: int
    length: int
    seconds: float           # total time on this chunk, all recovery included
    attempt_seconds: float   # fault-excluded work time: successful attempt +
    #                          generic (congestion-like) retries; corruption
    #                          re-fetch and outage time excluded
    cksum_seconds: float = 0.0   # checksum work ON the mover path (source
    #                              fingerprint; + read-back verify when inline)
    cksum_lag_s: float = 0.0     # pipelined data plane: move-landed ->
    #                              verified delay (checksum work happening
    #                              OFF the mover path; sampled separately so
    #                              deferred verification never masquerades as
    #                              mover congestion)
    attempts: int = 1
    refetches: int = 0       # corruption-healing source re-reads
    mover: int = 0
    t_end: float = 0.0       # caller-supplied completion timestamp

    @property
    def rate_Bps(self) -> float:
        """Fault-excluded effective rate of the successful attempt."""
        return self.length / self.attempt_seconds if self.attempt_seconds > 0 else 0.0


class TransferProbe:
    """Sliding-window aggregation of ChunkSamples into control signals."""

    def __init__(self, window: int = 32):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window: collections.deque[ChunkSample] = collections.deque(maxlen=window)
        # lifetime totals (reporting; the window drives control decisions)
        self.chunks = 0
        self.bytes = 0
        self.attempts = 0
        self.refetches = 0
        self.move_seconds = 0.0
        self.attempt_seconds = 0.0
        self.cksum_seconds = 0.0
        self.cksum_lag_seconds = 0.0

    def add(self, sample: ChunkSample) -> None:
        self.window.append(sample)
        self.chunks += 1
        self.bytes += sample.length
        self.attempts += sample.attempts
        self.refetches += sample.refetches
        self.move_seconds += sample.seconds
        self.attempt_seconds += sample.attempt_seconds
        self.cksum_seconds += sample.cksum_seconds
        self.cksum_lag_seconds += sample.cksum_lag_s

    # -- control signals ----------------------------------------------------
    @property
    def goodput_Bps(self) -> float:
        """Windowed per-mover effective rate, fault time excluded."""
        secs = sum(s.attempt_seconds for s in self.window)
        return sum(s.length for s in self.window) / secs if secs > 0 else 0.0

    @property
    def cksum_latency_s(self) -> float:
        """Mean per-chunk checksum (fingerprint + read-back) latency."""
        n = len(self.window)
        return sum(s.cksum_seconds for s in self.window) / n if n else 0.0

    @property
    def cksum_lag_latency_s(self) -> float:
        """Mean per-chunk deferred-verification lag (pipelined data plane).

        Non-zero only when an integrity engine is verifying off the mover
        path; a growing value means the checksum workers are falling behind
        movement — the pipelined analogue of checksum starvation."""
        n = len(self.window)
        return sum(s.cksum_lag_s for s in self.window) / n if n else 0.0

    @property
    def retry_amplification(self) -> float:
        """Lifetime move attempts per landed chunk (1.0 = no retries)."""
        return self.attempts / self.chunks if self.chunks else 1.0

    @property
    def fault_refetches(self) -> int:
        """Lifetime corruption-healing re-fetches (excluded from goodput)."""
        return self.refetches

    @staticmethod
    def epoch_rate(samples: "list[ChunkSample] | tuple[ChunkSample, ...]") -> float:
        """Fault-excluded aggregate rate of one epoch's samples."""
        secs = sum(s.attempt_seconds for s in samples)
        return sum(s.length for s in samples) / secs if secs > 0 else 0.0


def sample_from_chain(chain, *, length: int = 0) -> ChunkSample:
    """Derive one ChunkSample from a chunk's ``obs.trace`` span chain.

    ``chain`` is what ``Tracer.chunk_chain(task, offset)`` returns: the
    time-ordered spans carrying this chunk's offset. The mapping enforces the
    probe's fault-exclusion rule span-categorically — ``wire`` spans (the
    landing move plus congestion-like generic retries) feed
    ``attempt_seconds``; ``stall`` spans (corruption re-fetch, outage waits)
    are counted but excluded; inline ``cksum`` spans feed ``cksum_seconds``
    and ``cksum_wait`` spans feed ``cksum_lag_s``. This lets replayed traces
    re-drive the controller with exactly the telemetry the live probe saw.
    """
    if not chain:
        raise ValueError("empty span chain")
    offset = int(chain[0].arg("offset", 0))
    wire_s = cksum_s = lag_s = stall_s = 0.0
    attempts = 1
    refetches = 0
    mover = 0
    t_end = 0.0
    for sp in chain:
        t_end = max(t_end, sp.t1)
        if sp.cat == "wire":
            wire_s += sp.dur
            attempts = max(attempts, int(sp.arg("attempt", 1)))
            if sp.lane.startswith("mover") and sp.lane[5:].isdigit():
                mover = int(sp.lane[5:])
        elif sp.cat == "cksum":
            if sp.name != "verify":        # off-path verification is lag-side
                cksum_s += sp.dur
        elif sp.cat == "cksum_wait":
            lag_s += sp.dur
        elif sp.cat == "stall":
            stall_s += sp.dur
            if sp.arg("kind", "") == "corruption" or sp.name == "refetch":
                refetches += 1
    return ChunkSample(
        offset=offset, length=length,
        seconds=wire_s + cksum_s + stall_s,
        attempt_seconds=wire_s + cksum_s,
        cksum_seconds=cksum_s, cksum_lag_s=lag_s,
        attempts=attempts, refetches=refetches, mover=mover, t_end=t_end,
    )
