"""Observability spine: structured tracing + metrics (copies of the JAX
package's ``obs`` modules).

  * ``trace``   — ``Tracer`` span trees with a falsy allocation-free
    ``NULL_TRACER`` for the disabled path, plumbed ambiently via
    ``use_tracer`` / ``current_tracer``;
  * ``metrics`` — ``MetricsRegistry`` counters / gauges / log-bucket
    quantile histograms; ``CostLedger`` binds one so ledger and metrics
    can never disagree (core.costs.ledger_from_metrics);
  * ``export``  — Chrome/Perfetto trace-event JSON (``write_trace``) and
    its schema check (``validate_trace``), rendered/verified by
    ``launch/trace_report.py``.
"""

from repro_torch.obs.export import to_trace_events, validate_trace, write_trace
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, NullTracer, Span,
                                   SpanEvent, Tracer, current_tracer,
                                   use_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_SPAN", "NULL_TRACER", "NullTracer", "Span", "SpanEvent", "Tracer",
    "current_tracer", "use_tracer",
    "to_trace_events", "validate_trace", "write_trace",
]
