"""MetricsRegistry — counters, gauges, and log-bucket histograms.

Zero-dependency serving metrics (DESIGN.md §7).  Three instrument kinds:

  * ``Counter`` — monotonically accumulating flow (dollars, bytes, evals);
  * ``Gauge``   — a level, last-write-wins (resident bytes, queue depth);
  * ``Histogram`` — streaming distribution over fixed *log* buckets:
    bucket ``i`` covers ``[BASE**i, BASE**(i+1))`` with ``BASE = 2**0.25``
    (≈19% wide, 16 buckets per decade), so any quantile estimate is within
    one bucket — a bounded ~±10% relative error at O(1) memory, which is
    the right trade for p50/p99 serving-latency gates (an exact quantile
    would need the full sample; a fixed-range linear histogram would need
    the range known up front).  Values ≤ 0 land in a dedicated underflow
    bucket that reports 0.0.

``CostLedger`` (core.costs) optionally *binds* a registry: every charge
and counter mutation then feeds the equivalent metric as it happens, and
``core.costs.ledger_from_metrics`` reconstructs a ledger from a registry —
the invariant (tested) that keeps the two views from ever disagreeing.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

BASE = 2.0 ** 0.25                     # log-bucket width (16 per decade)
_LOG_BASE = math.log(BASE)
_UNDERFLOW = -(10 ** 9)                # bucket index for values <= 0


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    __slots__ = ("name", "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.buckets: dict = {}        # bucket index -> count
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        idx = (_UNDERFLOW if v <= 0.0
               else int(math.floor(math.log(v) / _LOG_BASE)))
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1): geometric midpoint of the
        bucket holding the q-th observation, clamped to the observed
        [min, max] so tiny samples don't report beyond their extremes."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= rank:
                if idx == _UNDERFLOW:
                    return 0.0
                mid = BASE ** (idx + 0.5)
                return min(max(mid, self.min), self.max)
        return self.max

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


# Serving-layer metric names that do NOT derive from the CostLedger
# (those live in core.costs.FIELD_METRICS / GAUGE_METRICS and round-trip
# through ledger_from_metrics).  The JAX package's analysis pass
# (its checkers, rule "metric-name") requires every literal name passed to
# inc/observe/set_gauge to appear either here or in the ledger maps, so
# a typo'd or undeclared metric fails CI instead of silently creating a
# dangling instrument nothing reads.
DECLARED_METRICS = {
    "serve.plan_hits": "JoinService plan-cache hits",
    "serve.plan_misses": "JoinService plan-cache misses",
    "serve.query_wall_s": "per-query wall seconds (service-side)",
    "fleet.submitted": "queries accepted by JoinFleet.submit",
    "fleet.admitted": "queries admitted by the round-robin worker",
    "fleet.completed": "queries finished without error",
    "fleet.failed": "queries that raised",
    "fleet.queue_wait_s": "submit-to-admission wait seconds",
    "fleet.query_wall_s": "per-query wall seconds (fleet-side)",
    "fleet.band_steps": "band-step dispatches through BandScheduler",
    "fleet.interleaves": "band steps that switched the running query",
    "refine.batches": "oracle refinement batches pulled off the queue",
    "refine.pairs": "candidate pairs refined",
    "refine.queue_depth": "RefinementPump queue depth (gauge)",
}


class MetricsRegistry:
    """Get-or-create instrument registry.  One lock guards instrument
    creation; mutation of an instrument is a float add under the GIL, so
    the hot path (counter feeds from the band loop) takes no lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def _get(self, table: dict, name: str, cls):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, cls(name))
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    # convenience mutators (the CostLedger binding uses these)
    def inc(self, name: str, v: float = 1.0) -> None:
        self.counter(name).inc(v)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def value(self, name: str, default: float = 0.0) -> float:
        """Current value of a counter or gauge (0.0 when never touched)."""
        c = self._counters.get(name)
        if c is not None:
            return c.value
        g = self._gauges.get(name)
        if g is not None:
            return g.value
        return default

    def has(self, name: str) -> bool:
        return (name in self._counters or name in self._gauges
                or name in self._histograms)

    def quantile(self, name: str, q: float) -> Optional[float]:
        h = self._histograms.get(name)
        return h.quantile(q) if h is not None else None

    def as_dict(self) -> dict:
        """Flat ``{metric_name: value}`` dict — counters and gauges by
        value, histograms expanded to ``name.count/.sum/.p50/.p90/.p99``.
        This is the block merged into benchmark rows and trace metadata."""
        out = {}
        for name, c in sorted(self._counters.items()):
            out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            out[name] = g.value
        for name, h in sorted(self._histograms.items()):
            for k, v in h.summary().items():
                out[f"{name}.{k}"] = v
        return out
