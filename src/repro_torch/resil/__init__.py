"""Resilience plane of the port: endpoint/link health, circuit breakers,
scrub/repair.

The port's copy of ``repro.resil``. ``health`` turns the engine/relay retry
taxonomy into per-target state a planner can act on *before* a transfer
burns its whole outage budget against a dead endpoint; ``scrub`` extends
integrity past the landing — the paper's lesson that verification must
cover data at rest, not just data in flight. The scrubber digests on a
device (``Scrubber(device="cuda")``, the default).
"""
from repro_torch.resil.health import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerConfig,
    CircuitBreaker,
    HealthTracker,
)
from repro_torch.resil.scrub import Scrubber, ScrubReport, ScrubTarget

__all__ = [
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
    "BreakerConfig",
    "CircuitBreaker",
    "HealthTracker",
    "Scrubber",
    "ScrubReport",
    "ScrubTarget",
]
