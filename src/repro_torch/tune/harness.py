"""Step-change path harness — reproducible WAN dynamics for the tuner.

The autotuner's whole reason to exist is that WAN conditions change *mid-
flight*: a link degrades, checksum workers starve, a loss spike comes and
goes. This module fabricates those step changes on the REAL threaded engine
by wrapping a transfer's endpoints with a shared phase schedule
(``StepPath``):

  * ``Phase`` — one regime of the path: a fixed per-operation latency (the
    control-channel turnaround that penalises small chunks), a per-byte cost
    (inverse bandwidth), a per-byte loss rate (lossy regimes penalise LARGE
    chunks: a failed attempt costs its full wire time), and checksum-side
    latencies (read-back verification cost);
  * ``StepPath`` — one transfer's realisation: ``wrap_source`` charges wire
    time and loss on the read path (where a retry costs only wire time, not
    a redundant fingerprint), ``wrap_dest`` tracks byte progress and charges
    checksum latency on read-back. The active phase is selected by
    *progress* (successful bytes landed), not wall time, so the step change
    hits the same point of the transfer on every run.

The loss model is DETERMINISTIC: with per-byte loss rate ``q``, an attempt
to move ``n`` bytes succeeds on try ``round(e^(q*n))`` — the geometric
expectation ``1/(1-p)`` of i.i.d. per-byte loss with the run-to-run variance
removed, so benchmark gates measure the economics of chunk sizing, not the
luck of the draw. ``precise_sleep`` keeps modeled costs accurate on
coarse-timer kernels. The same harness drives ``benchmarks/autotune.py``
(static vs tuned sweeps) and the conformance suite (``tests/test_tune.py``).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time

from repro_torch.core.transfer import ByteDest, ByteSource
from repro_torch.obs.clock import mono_s


def precise_sleep(dt: float) -> None:
    """Deadline-based sleep accurate to ~0.1 ms.

    ``time.sleep`` on coarse-timer kernels overshoots sub-millisecond sleeps
    by up to a scheduler tick (several ms), which swamps the harness's
    per-operation costs and makes goodput gates noisy. Sleep most of the
    interval coarsely, then yield-spin to the deadline: elapsed time is
    >= dt and within a hair of it, independent of timer resolution.
    """
    deadline = mono_s() + dt
    while True:
        remaining = deadline - mono_s()
        if remaining <= 0:
            return
        if remaining > 0.001:
            time.sleep(remaining - 0.001)   # coarse phase (overshoot-tolerant)
        else:
            time.sleep(0)                   # yield the GIL, re-check deadline


@dataclasses.dataclass(frozen=True)
class Phase:
    """One path regime, active once progress >= ``start_frac``."""

    start_frac: float = 0.0
    per_op_s: float = 0.0          # fixed latency per read (control channel)
    per_byte_s: float = 0.0        # inverse bandwidth of the wire
    error_per_byte: float = 0.0    # per-byte loss rate (see attempts_needed)
    cksum_per_op_s: float = 0.0    # fixed read-back verification latency
    cksum_per_byte_s: float = 0.0  # per-byte read-back verification cost

    def attempts_needed(self, nbytes: int) -> int:
        """Deterministic loss model: moving n bytes lands on attempt
        ``round(e^(q*n))`` — the geometric expectation of i.i.d. per-byte
        loss (success probability ``(1-q)^n``), variance removed. The
        exponent is capped (attempts <= ~20): past that a real stack's
        window collapse makes the path slow, not infinitely retried."""
        if self.error_per_byte <= 0.0 or nbytes <= 0:
            return 1
        return max(1, int(round(math.exp(min(self.error_per_byte * nbytes, 3.0)))))


@dataclasses.dataclass(frozen=True)
class StepScenario:
    """A named phase schedule (phases sorted by start_frac)."""

    name: str
    phases: tuple[Phase, ...]

    def __post_init__(self):
        if not self.phases:
            raise ValueError("scenario needs at least one phase")
        fracs = [p.start_frac for p in self.phases]
        if fracs != sorted(fracs) or fracs[0] != 0.0:
            raise ValueError("phases must start at 0.0 and be sorted by start_frac")

    def phase_at(self, frac: float) -> Phase:
        cur = self.phases[0]
        for p in self.phases:
            if frac >= p.start_frac:
                cur = p
        return cur


class StepPath:
    """One transfer's realisation of a StepScenario: wraps the source (wire
    time + deterministic loss on reads) and the destination (progress
    tracking + read-back checksum latency), sharing phase state."""

    def __init__(self, scenario: StepScenario, total_bytes: int,
                 *, sleep=precise_sleep):
        self.scenario = scenario
        self.total_bytes = max(1, int(total_bytes))
        self._lock = threading.Lock()
        self._sleep = sleep
        self._attempts: dict[tuple[int, int], int] = {}   # (offset, len) -> fails
        self.progress_bytes = 0        # successfully landed bytes (monotone)
        self.failed_reads = 0
        self.phase_changes: list[float] = []   # progress fracs where it switched
        self.phase_change_walls: list[float] = []   # mono_s() at switch
        self._last_phase: Phase | None = None

    def _phase(self) -> Phase:
        frac = min(1.0, self.progress_bytes / self.total_bytes)
        p = self.scenario.phase_at(frac)
        if p is not self._last_phase:
            if self._last_phase is not None:
                self.phase_changes.append(frac)
                self.phase_change_walls.append(mono_s())
            self._last_phase = p
        return p

    # -- endpoint wrappers --------------------------------------------------
    def wrap_source(self, inner: ByteSource) -> "SteppedSource":
        return SteppedSource(self, inner)

    def wrap_dest(self, inner: ByteDest) -> "SteppedDest":
        return SteppedDest(self, inner)

    # -- op costs (called by the wrappers) ----------------------------------
    def charge_read(self, offset: int, length: int) -> None:
        with self._lock:
            p = self._phase()
            key = (offset, length)
            done = self._attempts.get(key, 0)
            fail = done + 1 < p.attempts_needed(length)
            if fail:
                self._attempts[key] = done + 1
                self.failed_reads += 1
            else:
                self._attempts.pop(key, None)
        # the attempt costs its wire time whether or not it fails — that is
        # exactly why large chunks are expensive in a lossy regime
        self._sleep(p.per_op_s + length * p.per_byte_s)
        if fail:
            raise IOError(
                f"injected wire loss at offset {offset} ({length} bytes)")

    def charge_landed(self, nbytes: int) -> None:
        with self._lock:
            self.progress_bytes += nbytes

    def charge_read_back(self, length: int) -> None:
        with self._lock:
            p = self._phase()
        self._sleep(p.cksum_per_op_s + length * p.cksum_per_byte_s)


class SteppedSource:
    def __init__(self, path: StepPath, inner: ByteSource):
        self._path, self._inner = path, inner
        self.nbytes = inner.nbytes

    def read(self, offset: int, length: int) -> bytes:
        self._path.charge_read(offset, length)
        return self._inner.read(offset, length)


class SteppedDest:
    def __init__(self, path: StepPath, inner: ByteDest):
        self._path, self._inner = path, inner

    def write(self, offset: int, data: bytes) -> None:
        self._inner.write(offset, data)
        self._path.charge_landed(len(data))

    def read_back(self, offset: int, length: int) -> bytes:
        self._path.charge_read_back(length)
        return self._inner.read_back(offset, length)


# ---------------------------------------------------------------------------
# canonical step-change scenarios (benchmarks/autotune.py sweeps these)
# ---------------------------------------------------------------------------
def link_degrade_scenario(*, at_frac: float = 0.5, scale: float = 1.0) -> StepScenario:
    """At ``at_frac`` the WAN hop degrades for good: bandwidth drops and
    loss makes large-chunk attempts fail repeatedly (the Mathis-bound
    collapse of ``fabric.topology`` made concrete). The tuned engine must
    shrink its tail chunks to restore goodput. The clean phase is
    bandwidth-dominated, so the pre-step optimum is a plateau around the
    static plan — the interesting decision is the response to the step."""
    clean = Phase(0.0, per_op_s=6e-3 * scale, per_byte_s=1.2e-8 * scale)
    degraded = Phase(
        at_frac, per_op_s=6e-3 * scale, per_byte_s=4e-8 * scale,
        error_per_byte=7e-6,
    )
    return StepScenario("link_degrade_50pct", (clean, degraded))


def cksum_starvation_scenario(*, at_frac: float = 0.5, scale: float = 1.0) -> StepScenario:
    """At ``at_frac`` the destination's checksum workers starve: every
    read-back verification pays a large fixed latency. Fewer, larger chunks
    amortise it — the tuned engine should grow its tail chunks."""
    clean = Phase(0.0, per_op_s=3e-3 * scale, per_byte_s=1.2e-8 * scale)
    starved = Phase(
        at_frac, per_op_s=3e-3 * scale, per_byte_s=1.2e-8 * scale,
        cksum_per_op_s=12e-3 * scale,
    )
    return StepScenario("cksum_starvation", (clean, starved))


def loss_spike_scenario(*, at_frac: float = 0.45, until_frac: float = 0.75,
                        scale: float = 1.0) -> StepScenario:
    """A transient loss spike between two progress fractions; the path then
    heals. The tuned engine should shrink into the spike and climb back out
    (time-to-reconverge is the interesting metric)."""
    clean = Phase(0.0, per_op_s=6e-3 * scale, per_byte_s=1.2e-8 * scale)
    spike = Phase(at_frac, per_op_s=6e-3 * scale, per_byte_s=4e-8 * scale,
                  error_per_byte=7e-6)
    healed = Phase(until_frac, per_op_s=6e-3 * scale, per_byte_s=1.2e-8 * scale)
    return StepScenario("loss_spike", (clean, spike, healed))


STEP_SCENARIOS = {
    "link_degrade_50pct": link_degrade_scenario,
    "cksum_starvation": cksum_starvation_scenario,
    "loss_spike": loss_spike_scenario,
}
