"""Telemetry of the port: the metrics registry and its exposition."""
from .registry import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
