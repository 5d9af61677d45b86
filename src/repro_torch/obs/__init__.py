"""Observability: the metrics registry and the structured tracer."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .trace import Tracer  # noqa: F401
