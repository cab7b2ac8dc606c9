"""Telemetry of the port: the metrics registry and its exposition, the
tracer and the health monitor."""
from .health import HealthMonitor, get_monitor, set_monitor
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       get_registry)
from .trace import Span, Tracer, enable_tracing, get_tracer, set_tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "Tracer", "Span", "get_tracer", "set_tracer",
           "enable_tracing", "HealthMonitor", "get_monitor", "set_monitor"]
