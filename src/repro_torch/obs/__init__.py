"""Observability: the metrics registry (tracing is not ported yet)."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
