"""Tracing spine (a copy of the JAX package's ``obs.trace``)."""

from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, NullTracer, Span,
                                   SpanEvent, Tracer, current_tracer,
                                   use_tracer)

__all__ = ["NULL_SPAN", "NULL_TRACER", "NullTracer", "Span", "SpanEvent",
           "Tracer", "current_tracer", "use_tracer"]
