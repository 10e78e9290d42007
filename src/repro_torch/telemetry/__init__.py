"""Cluster observability of the port: metrics, tracing, flight recorder.

Byte-identical copies of the JAX package's telemetry modules; the
Manager and Worker register their counters and spans here.
"""

from .export import export_chrome_trace, to_chrome_events
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .recorder import FlightRecorder
from .tracing import (
    SpanContext,
    Tracer,
    TracingBus,
    current_context,
    set_context,
    use_context,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "FlightRecorder",
    "SpanContext",
    "Tracer",
    "TracingBus",
    "current_context",
    "set_context",
    "use_context",
    "export_chrome_trace",
    "to_chrome_events",
]
