"""Metrics registry: Counter / Gauge / Histogram with exposition.

A copy of ``repro/obs/metrics.py`` (pure Python, no JAX): the serving
engine and the executor keep their counters in typed instruments:

  * ``Counter`` — monotone float (tokens emitted, requests admitted).
  * ``Gauge`` — settable level (queue depth, free slots).
  * ``Histogram`` — fixed log-spaced buckets with streaming count/sum
    and min/max, so TTFT / latency percentiles are computed over *every*
    observation ever made, not just the FIFO-retained records.

A ``MetricsRegistry`` is a get-or-create namespace of instruments with
three exposition surfaces: ``to_prometheus()`` (text format 0.0.4,
scrapeable), ``snapshot()`` (plain-JSON dict for ``--metrics-json``),
and ``render()`` (compact human-readable lines for the serving CLI).

Everything is host-side pure-Python: no locks (the engine is a single
host loop), no background threads, no deps.
"""

from __future__ import annotations

import bisect
import math
from typing import Optional


def log_buckets(lo: float = 1e-4, hi: float = 1e2, per_decade: int = 4) -> tuple:
    """Fixed log-spaced bucket upper bounds covering [lo, hi].

    Defaults span 100 µs .. 100 s at 4 buckets/decade — wide enough for
    TTFT on a laptop CPU and on an accelerator pod with the same
    instrument, coarse enough that exposition stays small (25 buckets).
    """
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * (10 ** (i / per_decade)) for i in range(n + 1))


DEFAULT_BUCKETS = log_buckets()


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n


class Gauge:
    """A level that can go up and down (or be set directly)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Streaming histogram over fixed bucket upper bounds.

    ``observe`` is O(log n_buckets); ``quantile`` interpolates within
    the winning bucket and clamps to the observed [min, max] so small
    sample counts still give sane percentiles (p50 of three 0.125 s
    observations is 0.125 s, not a bucket edge).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets: tuple = DEFAULT_BUCKETS):
        if list(buckets) != sorted(buckets) or len(buckets) < 1:
            raise ValueError(f"histogram {name}: buckets must be sorted, non-empty")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        self._min = v if self._min is None else min(self._min, v)
        self._max = v if self._max is None else max(self._max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0..1) by in-bucket interpolation."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else self._max
                frac = (rank - seen) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self._min), self._max)
            seen += c
        return self._max

    def cumulative(self) -> list:
        """(upper_bound, cumulative_count) pairs ending with +Inf."""
        out, acc = [], 0
        for ub, c in zip(self.buckets, self.counts):
            acc += c
            out.append((ub, acc))
        out.append((math.inf, self.count))
        return out


class MetricsRegistry:
    """Get-or-create namespace of instruments with exposition."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: tuple = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def items(self):
        return self._metrics.items()

    # -- exposition --------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for ub, acc in m.cumulative():
                    le = "+Inf" if math.isinf(ub) else _fmt(ub)
                    lines.append(f'{name}_bucket{{le="{le}"}} {acc}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Plain-JSON dict of every instrument (for ``--metrics-json``)."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = {
                    "kind": m.kind,
                    "count": m.count,
                    "sum": m.sum,
                    "mean": m.mean,
                    "min": m._min,
                    "max": m._max,
                    "p50": m.quantile(0.5),
                    "p90": m.quantile(0.9),
                    "p99": m.quantile(0.99),
                    "buckets": [
                        [None if math.isinf(ub) else ub, acc]
                        for ub, acc in m.cumulative()
                    ],
                }
            else:
                out[name] = {"kind": m.kind, "value": m.value}
        return out

    def render(self, prefix: str = "") -> str:
        """Compact human-readable lines (the serving CLI stats print)."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            if prefix and not name.startswith(prefix):
                continue
            if isinstance(m, Histogram):
                if m.count:
                    lines.append(
                        f"  {name}: n={m.count} mean={m.mean:.4g} "
                        f"p50={m.quantile(0.5):.4g} p99={m.quantile(0.99):.4g}"
                    )
                else:
                    lines.append(f"  {name}: n=0")
            else:
                v = m.value
                sv = f"{int(v)}" if float(v).is_integer() else f"{v:.4g}"
                lines.append(f"  {name}: {sv}")
        return "\n".join(lines)


def _fmt(v: float) -> str:
    """Prometheus-friendly number formatting (no trailing .0 noise)."""
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
