"""Tracer — per-query span trees with monotonic timestamps (DESIGN.md §7).

A ``Span`` is a named ``[t0, t1)`` interval (``time.perf_counter`` seconds)
with structured attributes, point-in-time events, and a parent link — the
span *tree* of one query is what the Perfetto exporter (obs.export) and
the text reporter (launch.trace_report) render.  Spans are created two
ways:

  * ``tracer.span(name, ...)`` — a context manager; nesting follows a
    per-thread stack, so synchronous code gets its tree for free;
  * ``tracer.record_span(name, t0, t1, ...)`` — retroactive: hot loops
    (the sharded band ring, the refinement pump) measure their own
    timestamps anyway, so they record finished intervals instead of
    holding spans open across generator yields, where context-manager
    stack discipline would misattribute consumer work to the producer.

Cross-thread trees are explicit: a worker thread passes ``parent=`` (the
span captured on the spawning thread) rather than inheriting a stack it
does not share.  ``track`` names a rendering lane — slices on one track
must nest, so concurrent band steps go on per-ring-slot tracks and the
pump's batches on the worker-thread track (obs.export maps tracks to
Perfetto tids).

The disabled path is ``NULL_TRACER``: falsy (hot loops guard with a plain
``if tracer:`` — one truthiness check, zero allocations) and inert (every
method returns a shared singleton), so untraced runs pay nothing and
traced/untraced candidate sets are trivially identical.  The ambient
tracer travels by contextvar (``use_tracer`` / ``current_tracer``), not by
threading it through every engine signature; threads started inside a
traced region must capture it (and a parent span) explicitly —
``contextvars`` do not cross ``threading.Thread``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Optional


@dataclasses.dataclass
class SpanEvent:
    """A point-in-time marker on a span (overflow, retry, theta_swap...)."""
    name: str
    ts: float                          # perf_counter seconds
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    t0: float                          # perf_counter seconds
    t1: Optional[float] = None         # None while still open
    track: Optional[str] = None        # rendering lane (export tid)
    thread: str = ""                   # thread name it was recorded on
    attrs: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, ts: Optional[float] = None, **attrs) -> None:
        self.events.append(SpanEvent(name, time.perf_counter()
                                     if ts is None else ts, attrs))


class Tracer:
    """Collects one trace: a flat span list linked into trees by parent id.

    Thread-safe for concurrent recording (one lock around the span list;
    the per-thread open-span stacks are thread-local by construction)."""

    def __init__(self):
        self.epoch = time.perf_counter()       # export time zero
        self.wall_epoch = time.time()  # wallclock-ok: metadata, not span math
        self._spans: list = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()

    def __bool__(self) -> bool:
        return True

    # -- recording ----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def _new_span(self, name, t0, t1, parent, track, attrs) -> Span:
        pid = parent.span_id if isinstance(parent, Span) else parent
        if pid is None:
            cur = self.current_span()
            pid = cur.span_id if cur is not None else None
        sp = Span(name=name, span_id=next(self._ids), parent_id=pid,
                  t0=t0, t1=t1, track=track,
                  thread=threading.current_thread().name,
                  attrs=dict(attrs) if attrs else {})
        with self._lock:
            self._spans.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, *, parent=None, track: Optional[str] = None,
             **attrs):
        """Open a span for the duration of the ``with`` block.  Nests under
        this thread's innermost open span unless ``parent`` is given."""
        sp = self._new_span(name, time.perf_counter(), None, parent, track,
                            attrs)
        st = self._stack()
        st.append(sp)
        try:
            yield sp
        finally:
            sp.t1 = time.perf_counter()
            # tolerate out-of-order exits rather than corrupting the stack
            if st and st[-1] is sp:
                st.pop()
            elif sp in st:
                st.remove(sp)

    def record_span(self, name: str, t0: float, t1: float, *, parent=None,
                    track: Optional[str] = None, attrs: Optional[dict] = None,
                    events: Optional[list] = None) -> Span:
        """Record an already-finished ``[t0, t1)`` interval.  ``parent``
        may be a Span or a span id; defaults to this thread's innermost
        open span.  ``events`` is a list of ``SpanEvent`` or ``(name, ts,
        attrs)`` tuples."""
        sp = self._new_span(name, t0, t1, parent, track, attrs)
        for ev in events or ():
            if isinstance(ev, SpanEvent):
                sp.events.append(ev)
            else:
                nm, ts, at = ev
                sp.events.append(SpanEvent(nm, ts, dict(at) if at else {}))
        return sp

    def event(self, name: str, ts: Optional[float] = None, **attrs) -> None:
        """Mark an instant on this thread's innermost open span (dropped
        when no span is open — events always belong to a span)."""
        cur = self.current_span()
        if cur is not None:
            cur.event(name, ts=ts, **attrs)

    # -- reading ------------------------------------------------------------

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def close_open_spans(self) -> None:
        """Clamp any still-open span to now (export of an abandoned or
        mid-stream trace must not emit None durations)."""
        now = time.perf_counter()
        with self._lock:
            for sp in self._spans:
                if sp.t1 is None:
                    sp.t1 = now


class _NullSpan:
    """Inert singleton standing in for Span on the disabled path."""
    __slots__ = ()
    span_id = 0
    parent_id = None
    name = ""
    t0 = 0.0
    t1 = 0.0
    track = None
    attrs: dict = {}
    events: list = []
    duration_s = 0.0

    def set(self, **attrs):
        return self

    def event(self, name, ts=None, **attrs):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """The guaranteed-cheap disabled tracer: falsy, allocation-free.

    ``bool(NULL_TRACER)`` is False so hot loops skip instrumentation with
    one branch; every method returns the shared ``NULL_SPAN`` (which is
    its own context manager), so accidental unguarded calls still cost no
    allocations (tests/test_obs.py pins this with tracemalloc)."""
    __slots__ = ()
    epoch = 0.0
    wall_epoch = 0.0

    def __bool__(self) -> bool:
        return False

    def span(self, name, *, parent=None, track=None, **attrs):
        return NULL_SPAN

    def record_span(self, name, t0, t1, *, parent=None, track=None,
                    attrs=None, events=None):
        return NULL_SPAN

    def event(self, name, ts=None, **attrs):
        return None

    def current_span(self):
        return None

    def spans(self) -> list:
        return []

    def close_open_spans(self) -> None:
        return None


NULL_TRACER = NullTracer()

# ambient tracer: set once at the query/CLI root, read at instrumentation
# sites (contextvars don't cross threads — workers get explicit handles)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "fdj_tracer", default=None)


def current_tracer():
    """The ambient tracer (NULL_TRACER when tracing is off)."""
    return _CURRENT.get() or NULL_TRACER


@contextlib.contextmanager
def use_tracer(tracer):
    """Install ``tracer`` as the ambient tracer for the block (None ⇒
    leave tracing off — callers can pass their optional tracer through)."""
    token = _CURRENT.set(tracer)
    try:
        yield tracer if tracer is not None else NULL_TRACER
    finally:
        _CURRENT.reset(token)
