"""Observability for the port: tracer, metrics registry, flight recorder.

Copies of ``repro.obs.clock``, ``repro.obs.metrics``, ``repro.obs.trace``
and ``repro.obs.recorder`` — what the transfer engine, the integrity engine
and the transfer service need. The registry is the port's own: counters of
the reference package never appear in it. Attribution (``obs.attr``) waits
for a later slice.
"""
from .clock import Clock, mono_s, wall_s
from .metrics import REGISTRY, Counter, Gauge, Histogram, Registry, delta
from .recorder import FlightRecorder, journal_tail_summary
from .trace import CATEGORIES, NULL, NullTracer, Span, Tracer

__all__ = [
    "Clock", "mono_s", "wall_s",
    "REGISTRY", "Counter", "Gauge", "Histogram", "Registry", "delta",
    "FlightRecorder", "journal_tail_summary",
    "CATEGORIES", "NULL", "NullTracer", "Span", "Tracer",
]
