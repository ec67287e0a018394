"""Seeded-jitter retry backoff — the shared de-correlation policy.

Every retry loop in the repo used to compute its own delay inline, and all
of them were the same two unjittered formulas::

    time.sleep(base * (2 ** (attempt - 1)))      # generic I/O retries
    time.sleep(base * min(attempt, 8))           # outage waits

Unjittered backoff synchronizes: when an endpoint outage rejects a burst of
operations, every mover that was hit computes the *same* delay and the whole
pool re-arrives as one retry storm — exactly the thundering herd a
recovering endpoint cannot absorb ("Reexamining Paradigms of End-to-End
Data Movement": recovery behaviour in the first minutes after a fault is
where transfers are won or lost). ``Backoff`` keeps the familiar shapes
(exponential with a capped exponent, linear with a capped multiplier) but
multiplies each delay by a per-``(seed, lane, attempt)`` jitter factor drawn
through SHA-256 — NOT the process-salted ``hash`` and NOT shared RNG state —
so:

  * two movers (distinct ``lane``) retrying the same attempt number get
    *different* delays — their retry instants de-correlate;
  * the same ``(seed, lane, attempt)`` always gets the *same* delay — a
    failing run replays bit-for-bit, and tests can assert exact schedules;
  * jitter only ever shortens the delay (factor in ``[1 - jitter, 1]``), so
    no caller's worst-case timeout budget grows.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time


def jitter_u(*parts) -> float:
    """Deterministic uniform in [0, 1) keyed by ``parts`` (SHA-256, not the
    process-salted ``hash``)."""
    blob = "|".join(repr(p) for p in parts).encode()
    n = int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")
    return n / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class Backoff:
    """One lane's deterministic retry-delay schedule.

    ``mode="exp"``: ``base_s * factor ** min(attempt - 1, cap_exp)``;
    ``mode="linear"``: ``base_s * min(attempt, cap_mult)`` (the outage-wait
    shape — outages heal on their own clock, so the wait grows gently).
    Either shape is then scaled by the seeded jitter factor. ``attempt``
    starts at 1 (the first retry).
    """

    base_s: float
    mode: str = "exp"                # "exp" | "linear"
    factor: float = 2.0
    cap_exp: int = 6                 # exp: exponent ceiling
    cap_mult: int = 8                # linear: multiplier ceiling
    jitter: float = 0.5              # delay scaled into [1 - jitter, 1]
    seed: int = 0
    lane: str = ""                   # the de-correlation key (mover/hop id)

    def __post_init__(self):
        if self.mode not in ("exp", "linear"):
            raise ValueError(f"unknown backoff mode {self.mode!r}")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError("jitter must be in [0, 1)")

    def delay(self, attempt: int) -> float:
        """The delay before retry ``attempt`` (>= 1), jittered, in seconds."""
        if attempt < 1:
            raise ValueError("attempt numbering starts at 1")
        if self.mode == "exp":
            d = self.base_s * self.factor ** min(attempt - 1, self.cap_exp)
        else:
            d = self.base_s * min(attempt, self.cap_mult)
        u = jitter_u(self.seed, self.lane, self.mode, attempt)
        return d * (1.0 - self.jitter * u)

    def sleep(self, attempt: int, *, sleep=time.sleep) -> float:
        """Sleep the jittered delay; returns the seconds slept."""
        d = self.delay(attempt)
        if d > 0.0:
            sleep(d)
        return d
