"""Observability for the port: tracer, metrics registry, flight recorder,
attribution.

Copies of ``repro.obs`` (clock, metrics, trace, recorder, attr). The
registry is the port's own: counters of the reference package never appear
in it.
"""
from .attr import Attribution, attribute, by_group, report
from .clock import Clock, mono_s, wall_s
from .metrics import REGISTRY, Counter, Gauge, Histogram, Registry, delta
from .recorder import FlightRecorder, journal_tail_summary
from .trace import CATEGORIES, NULL, NullTracer, Span, Tracer

__all__ = [
    "Attribution", "attribute", "by_group", "report",
    "Clock", "mono_s", "wall_s",
    "REGISTRY", "Counter", "Gauge", "Histogram", "Registry", "delta",
    "FlightRecorder", "journal_tail_summary",
    "CATEGORIES", "NULL", "NullTracer", "Span", "Tracer",
]
