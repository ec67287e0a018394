"""Observability for the port: the span tracer and the metrics registry.

Copies of ``repro.obs.clock``, ``repro.obs.metrics`` and ``repro.obs.trace``
— what the transfer engine and the integrity engine need. Attribution, the
flight recorder and the exporters wait for the slices that port the service.
"""
from .clock import Clock, mono_s, wall_s
from .metrics import REGISTRY, Counter, Gauge, Histogram, Registry, delta
from .trace import CATEGORIES, NULL, NullTracer, Span, Tracer

__all__ = [
    "Clock", "mono_s", "wall_s",
    "REGISTRY", "Counter", "Gauge", "Histogram", "Registry", "delta",
    "CATEGORIES", "NULL", "NullTracer", "Span", "Tracer",
]
