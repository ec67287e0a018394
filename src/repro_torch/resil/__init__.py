"""Resilience plane of the port: the scrub/repair daemon.

``scrub`` extends integrity past the landing — the paper's lesson that
verification must cover data at rest, not just data in flight. It is the
port's copy of ``repro.resil.scrub``; the endpoint health trackers and
circuit breakers (``repro.resil.health``) wait for the slice that ports the
fabric they guard.
"""
from repro_torch.resil.scrub import Scrubber, ScrubReport, ScrubTarget

__all__ = ["Scrubber", "ScrubReport", "ScrubTarget"]
