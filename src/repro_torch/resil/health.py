"""Per-endpoint/link health tracking and deterministic circuit breakers.

The engine and relay already classify every failure (corruption, outage,
mover crash, generic I/O) but each transfer consumes that signal alone:
a task retries against a dead endpoint until its own outage budget burns
out, and the next task starts from scratch against the same corpse. The
``HealthTracker`` pools those verdicts per *target* (an endpoint ``"ep:n1"``
or a directed link ``"link:n1->n2"``) and drives a circuit breaker per
target:

    CLOSED -- failures accumulate --> OPEN -- cooldown --> HALF_OPEN
       ^                                                      |
       +--- probe successes ----------------------------------+
       (a probe failure re-OPENs with an escalated cooldown)

Determinism: breakers advance on *operation counts*, never wall clocks.
A target opens after ``fail_threshold`` consecutive failures or when the
EWMA error rate crosses ``ewma_threshold`` (with at least ``min_samples``
observations so one early failure cannot trip it). An OPEN breaker rejects
a seeded-jittered number of operations — ``open_ops`` scaled by the SHA-256
draw for ``(seed, target, reopen_count)``, doubling per consecutive re-open
— then admits ``probe_ops`` half-open probes. Same seed, same op/outcome
sequence => bit-identical transition logs, which the failover benchmark
asserts.
"""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.core.backoff import jitter_u
from repro_torch.obs import metrics as obsmetrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# breaker-state gauge: 0 = closed, 1 = half_open, 2 = open
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}
_M_STATE = obsmetrics.REGISTRY.gauge(
    "resil_breaker_state",
    "Circuit-breaker state per target (0=closed, 1=half_open, 2=open)",
    ("target",),
)
_M_TRANSITIONS = obsmetrics.REGISTRY.counter(
    "resil_breaker_transitions_total",
    "Circuit-breaker state transitions",
    ("target", "to"),
)


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Thresholds for one breaker; shared by a tracker's whole fleet."""

    fail_threshold: int = 5      # consecutive failures that trip CLOSED->OPEN
    ewma_alpha: float = 0.2      # error-rate EWMA smoothing
    ewma_threshold: float = 0.5  # EWMA error rate that trips CLOSED->OPEN
    min_samples: int = 8         # EWMA cannot trip before this many records
    open_ops: int = 16           # base cooldown, in rejected operations
    probe_ops: int = 2           # half-open successes needed to close
    max_reopen_doublings: int = 4
    jitter: float = 0.5          # cooldown scaled into [1 - jitter, 1]

    def __post_init__(self):
        if self.fail_threshold < 1 or self.open_ops < 1 or self.probe_ops < 1:
            raise ValueError("breaker thresholds must be >= 1")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError("ewma_alpha must be in (0, 1]")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError("jitter must be in [0, 1)")


@dataclasses.dataclass(frozen=True)
class Transition:
    """One breaker state change (op-counted, so replayable)."""

    op: int              # total records seen when the transition fired
    frm: str
    to: str
    reason: str


class CircuitBreaker:
    """One target's failure-driven admission state (not thread-safe on its
    own; ``HealthTracker`` serialises access)."""

    def __init__(self, target: str, config: BreakerConfig, seed: int = 0):
        self.target = target
        self.config = config
        self.seed = seed
        self.state = CLOSED
        self.samples = 0            # total records (the op clock)
        self.consecutive_failures = 0
        self.ewma = 0.0             # smoothed error rate in [0, 1]
        self.reopen_count = 0       # consecutive OPEN entries without a close
        self.transitions: list[Transition] = []
        self._cooldown_left = 0     # OPEN: rejections remaining
        self._probes_ok = 0         # HALF_OPEN: successes so far
        _M_STATE.set(_STATE_VALUE[CLOSED], target=target)

    # -- state machine -------------------------------------------------------
    def _goto(self, to: str, reason: str) -> None:
        self.transitions.append(Transition(self.samples, self.state, to, reason))
        self.state = to
        _M_STATE.set(_STATE_VALUE[to], target=self.target)
        _M_TRANSITIONS.inc(1, target=self.target, to=to)

    def _cooldown_ops(self) -> int:
        """Seeded-jittered cooldown, doubling per consecutive re-open."""
        c = self.config
        scale = 2 ** min(self.reopen_count, c.max_reopen_doublings)
        u = jitter_u(self.seed, self.target, "cooldown", self.reopen_count)
        return max(1, round(c.open_ops * scale * (1.0 - c.jitter * u)))

    def _open(self, reason: str) -> None:
        self._cooldown_left = self._cooldown_ops()
        self.reopen_count += 1
        self._goto(OPEN, reason)

    def allow(self) -> bool:
        """Gate one operation. OPEN burns one cooldown tick and rejects;
        when the cooldown is spent the breaker half-opens and admits."""
        if self.state != OPEN:
            return True
        self._cooldown_left -= 1
        if self._cooldown_left <= 0:
            self._probes_ok = 0
            self._goto(HALF_OPEN, "cooldown_elapsed")
            return True
        return False

    def record(self, ok: bool) -> None:
        self.samples += 1
        a = self.config.ewma_alpha
        self.ewma += a * ((0.0 if ok else 1.0) - self.ewma)
        if ok:
            self.consecutive_failures = 0
            if self.state == HALF_OPEN:
                self._probes_ok += 1
                if self._probes_ok >= self.config.probe_ops:
                    self.reopen_count = 0
                    self.ewma = 0.0
                    self._goto(CLOSED, "probes_passed")
            return
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            self._open("probe_failed")
        elif self.state == CLOSED:
            if self.consecutive_failures >= self.config.fail_threshold:
                self._open("consecutive_failures")
            elif (self.samples >= self.config.min_samples
                  and self.ewma >= self.config.ewma_threshold):
                self._open("ewma_error_rate")


class HealthTracker:
    """The fleet of breakers, one per endpoint/link target string.

    Thread-safe: relay movers on many hops feed the same tracker. Targets
    are plain strings so the engine, relay and campaign layers can share a
    tracker without agreeing on a richer type — the conventions are
    ``ep:<node>`` and ``link:<u>-><v>``.
    """

    def __init__(self, *, seed: int = 0, config: BreakerConfig | None = None):
        self.seed = seed
        self.config = config or BreakerConfig()
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    @staticmethod
    def endpoint_target(node: str) -> str:
        return f"ep:{node}"

    @staticmethod
    def link_target(u: str, v: str) -> str:
        return f"link:{u}->{v}"

    def breaker(self, target: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(target)
            if br is None:
                br = CircuitBreaker(target, self.config, seed=self.seed)
                self._breakers[target] = br
            return br

    def record(self, target: str, ok: bool) -> None:
        with self._lock:
            br = self._breakers.get(target)
            if br is None:
                br = CircuitBreaker(target, self.config, seed=self.seed)
                self._breakers[target] = br
            br.record(ok)

    def allow(self, target: str) -> bool:
        with self._lock:
            br = self._breakers.get(target)
            return True if br is None else br.allow()

    def healthy(self, target: str) -> bool:
        """OPEN means sick; CLOSED and HALF_OPEN both admit traffic."""
        with self._lock:
            br = self._breakers.get(target)
            return br is None or br.state != OPEN

    def state(self, target: str) -> str:
        with self._lock:
            br = self._breakers.get(target)
            return CLOSED if br is None else br.state

    def error_rate(self, target: str) -> float:
        with self._lock:
            br = self._breakers.get(target)
            return 0.0 if br is None else br.ewma

    def sick_targets(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(
                t for t, br in self._breakers.items() if br.state == OPEN))

    def snapshot(self) -> dict[str, dict]:
        """Deterministic per-target view (benchmarks diff this across runs)."""
        with self._lock:
            return {
                t: {
                    "state": br.state,
                    "samples": br.samples,
                    "ewma": br.ewma,
                    "consecutive_failures": br.consecutive_failures,
                    "reopen_count": br.reopen_count,
                    "transitions": [dataclasses.astuple(x)
                                    for x in br.transitions],
                }
                for t, br in sorted(self._breakers.items())
            }
