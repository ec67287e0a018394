"""Shared virtual-time utilities for the event-stepped backends.

Before this module existed, three event loops each hand-rolled the same
virtual-clock bookkeeping: the calibrated per-chunk WAN simulator
(``core.simulator``), the fluid-model service testbed (``service.testbed``,
including its fault-scenario outage windows), and — with the fabric — the
multi-hop campaign executor (``fabric.virtual``). Each had its own ``t``
accumulator, its own iteration guard with its own error message, its own
"no progressing stage" deadlock check, and its own inline interval
arithmetic for outage windows. They are now all ports of the two primitives
here:

  * ``VirtualClock`` — a monotonically advancing virtual ``now`` with a
    built-in convergence guard. Each loop iteration calls ``tick(*candidate
    event deltas)``; the clock picks the earliest finite candidate, advances,
    and raises ``ConvergenceError`` when nothing can progress or the loop
    exceeds its step budget (a deterministic stand-in for "this model
    diverged", catchable as RuntimeError by older callers).

  * ``Window`` — a half-open ``[start, start+duration)`` virtual-time
    interval used for outage/degradation schedules: scenario outage windows
    in the testbed, per-endpoint maintenance schedules in ``fabric.topology``,
    and link-outage windows in ``fabric.virtual`` all share its
    ``contains``/``until_end`` arithmetic instead of re-deriving it inline.
"""
from __future__ import annotations

import dataclasses
import math


class ConvergenceError(RuntimeError):
    """An event loop stopped progressing (deadlock) or exceeded its budget."""


@dataclasses.dataclass(frozen=True)
class Window:
    """Half-open virtual-time interval ``[start, start + duration)``."""

    start: float
    duration: float

    def __post_init__(self):
        if self.duration < 0:
            raise ValueError("window duration must be >= 0")

    @property
    def end(self) -> float:
        return self.start + self.duration

    def contains(self, t: float, *, eps: float = 1e-12) -> bool:
        return self.start - eps <= t < self.end - eps

    def until_start(self, t: float) -> float:
        """Virtual seconds until the window opens (inf if already open/past)."""
        return self.start - t if t < self.start else math.inf

    def until_end(self, t: float) -> float:
        """Virtual seconds until the window closes (inf once it has)."""
        return self.end - t if t < self.end else math.inf

    def next_boundary(self, t: float) -> float:
        """Virtual seconds to the nearest upcoming edge (start or end)."""
        return min(self.until_start(t), self.until_end(t))


class VirtualClock:
    """Guarded virtual-time stepper shared by the event-stepped backends.

    ``guard`` bounds the number of ``tick`` calls; event loops size it from
    their workload (e.g. ``20 * n_items + 1000``) so a buggy model fails fast
    and deterministically instead of spinning. ``label`` names the backend in
    error messages.
    """

    def __init__(self, *, guard: int, label: str = "event loop"):
        if guard < 1:
            raise ValueError("guard must be >= 1")
        self.now = 0.0
        self.steps = 0
        self.guard = guard
        self.label = label

    def tick(self, *candidates: float, floor: float = 0.0) -> float:
        """Advance to the earliest of the candidate event deltas.

        Ignores non-finite candidates; if none are finite the model is
        deadlocked (nothing progresses) and ``ConvergenceError`` is raised.
        ``floor`` clamps the step from below (the simulator's numeric eps).
        Returns the delta actually applied.
        """
        self.steps += 1
        if self.steps > self.guard:
            raise ConvergenceError(
                f"{self.label} failed to converge (event-loop guard: "
                f"{self.guard} steps)"
            )
        dt = math.inf
        for c in candidates:
            if math.isfinite(c) and c < dt:
                dt = c
        if not math.isfinite(dt):
            raise ConvergenceError(f"{self.label} deadlock: no progressing stage")
        dt = max(dt, floor)
        self.now += dt
        return dt
