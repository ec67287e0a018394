"""Bottleneck attribution — folding a span log into a time-accounting report.

"Pipelined ran at 1.6x instead of 2.1x" is a number; "61% of the makespan
was checksum-bound, 24% wire, 9% journal" is an explanation. This module
sweeps a task's spans over its makespan and charges every elementary time
segment to exactly ONE phase, so the per-phase shares sum to the makespan
by construction (the acceptance gate checks ~100%).

Classification is by *saturation*, not busy-time, and mirrors the tuner's
fault-excluded accounting (``tune.probe``):

  * ``stall``  — fault recovery was in progress: a corruption re-fetch, an
    outage wait, a retry backoff. Highest priority: injected faults must
    never masquerade as wire or checksum slowness (the same rule that keeps
    them out of the tuner's congestion signal).
  * ``cksum``  — the transfer was checksum-BOUND: either a landed chunk was
    waiting for a free verify worker (``cksum_wait`` span active — the
    verify pool is saturated), or checksum work ran with no concurrent wire
    activity (the drain tail after movers finish, or inline fingerprinting
    on the mover path). Checksum work fully hidden behind concurrent wire
    time is NOT charged here — hiding it is precisely what the pipelined
    data plane is for, and attribution must give it credit.
  * ``wire``   — a mover was moving bytes (fault-excluded attempt time).
  * ``journal``— custody record appends.
  * ``dedup``  — content-plane negotiation: index probes, hit
    re-verification, local-copy satisfaction (time the transfer spent
    skipping wire moves instead of making them).
  * ``queue``  — chunks waited for a mover with nothing else happening.
  * ``idle``   — no span active (scheduler gaps, thread wakeup latency).

Priority when several are active: stall > cksum_wait > wire > cksum >
journal > dedup > queue. The report also slices per lane-group (relay hops) via
span args, so a routed transfer shows which hop's wire or checksum pool is
the bottleneck.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from .trace import Span

#: classification priority, highest first (idle = nothing active)
PRIORITY = ("failover", "stall", "cksum_wait", "wire", "cksum", "journal",
            "dedup", "queue")
#: report buckets: cksum_wait folds into cksum ("checksum-bound" either way)
_FOLD = {"cksum_wait": "cksum"}
PHASES = ("failover", "stall", "cksum", "wire", "journal", "dedup", "queue",
          "idle")


@dataclasses.dataclass(frozen=True)
class Attribution:
    """Per-phase time accounting over one window. Shares sum to makespan."""

    t0: float
    t1: float
    seconds: Dict[str, float]    # phase -> seconds (keys = PHASES)

    @property
    def makespan_s(self) -> float:
        return self.t1 - self.t0

    def share(self, phase: str) -> float:
        mk = self.makespan_s
        return self.seconds.get(phase, 0.0) / mk if mk > 0 else 0.0

    def shares(self) -> Dict[str, float]:
        return {p: self.share(p) for p in PHASES}

    def dominant(self) -> str:
        """The phase with the largest share (ties break by PHASES order)."""
        return max(PHASES, key=lambda p: (self.seconds.get(p, 0.0),
                                          -PHASES.index(p)))

    def to_json(self) -> dict:
        return {
            "makespan_s": round(self.makespan_s, 9),
            "seconds": {p: round(self.seconds.get(p, 0.0), 9)
                        for p in PHASES},
            "shares": {p: round(self.share(p), 6) for p in PHASES},
            "dominant": self.dominant(),
        }

    def format(self, label: str = "") -> str:
        """A small fixed-width table for terminals and EXPERIMENTS.md."""
        lines = [f"attribution{' ' + label if label else ''}: "
                 f"makespan {self.makespan_s:.3f}s"]
        for p in PHASES:
            secs = self.seconds.get(p, 0.0)
            bar = "#" * int(round(self.share(p) * 40))
            lines.append(f"  {p:<8} {secs:>9.3f}s  {self.share(p):>6.1%}  {bar}")
        return "\n".join(lines)


def attribute(spans: Iterable[Span], *, t0: Optional[float] = None,
              t1: Optional[float] = None) -> Attribution:
    """Sweep the spans and charge every segment of [t0, t1] to one phase.

    The window defaults to the extent of ALL given spans (including
    ``task``-category root spans, which carry the makespan but are never
    charged). Runs in O(n log n) via an event sweep.
    """
    spans = list(spans)
    if t0 is None:
        t0 = min((s.t0 for s in spans), default=0.0)
    if t1 is None:
        t1 = max((s.t1 for s in spans), default=t0)
    seconds = {p: 0.0 for p in PHASES}
    if t1 <= t0:
        return Attribution(t0, t1, seconds)

    # event sweep: +1/-1 per classified span edge, clipped to the window
    events: List[tuple] = []
    for s in spans:
        if s.cat not in PRIORITY:
            continue
        a, b = max(s.t0, t0), min(s.t1, t1)
        if b <= a:
            continue
        events.append((a, 1, s.cat))
        events.append((b, -1, s.cat))
    events.sort(key=lambda e: (e[0], -e[1]))

    active = {c: 0 for c in PRIORITY}
    cursor = t0
    i, n = 0, len(events)
    while i < n:
        t = events[i][0]
        if t > cursor:
            phase = "idle"
            for c in PRIORITY:
                if active[c] > 0:
                    phase = _FOLD.get(c, c)
                    break
            seconds[phase] += t - cursor
            cursor = t
        while i < n and events[i][0] == t:
            active[events[i][2]] += events[i][1]
            i += 1
    if t1 > cursor:
        phase = "idle"
        for c in PRIORITY:
            if active[c] > 0:
                phase = _FOLD.get(c, c)
                break
        seconds[phase] += t1 - cursor
    return Attribution(t0, t1, seconds)


def by_group(spans: Iterable[Span], key: str = "hop") -> Dict[str, Attribution]:
    """Slice the attribution per span-arg group (e.g. per relay hop).

    Spans without the arg are ignored; each group is attributed within its
    own window, so a hop's report covers that hop's active period.
    """
    groups: Dict[str, List[Span]] = {}
    for s in spans:
        g = s.arg(key)
        if g is not None:
            groups.setdefault(str(g), []).append(s)
    return {g: attribute(ss) for g, ss in sorted(groups.items())}


def report(spans: Iterable[Span], *, group_key: str = "hop") -> dict:
    """JSON-ready bundle: overall attribution plus per-group slices."""
    spans = list(spans)
    overall = attribute(spans)
    groups = by_group(spans, group_key)
    out = {"overall": overall.to_json()}
    if groups:
        out["per_" + group_key] = {g: a.to_json() for g, a in groups.items()}
    return out
