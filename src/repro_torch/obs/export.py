"""Perfetto / Chrome trace-event export (DESIGN.md §7).

Serializes a ``Tracer``'s span tree to the trace-event JSON object format
(``{"traceEvents": [...]}``) that Perfetto, ``chrome://tracing`` and
``ui.perfetto.dev`` load directly:

  * every Span becomes one complete slice (``"ph": "X"``) with
    microsecond ``ts``/``dur`` relative to the tracer epoch and its
    attributes (plus ``span_id``/``parent_id``, so the tree survives the
    flat format) under ``args``;
  * every SpanEvent becomes a thread-scoped instant (``"ph": "i"``);
  * tracks map to synthetic tids: a span renders on its own ``track``
    when set, else its nearest ancestor's, else its recording thread.
    Slices sharing a tid must nest — that is why concurrent band steps
    carry per-ring-slot tracks (engine/sharded.py) — and overlap across
    tids is exactly what makes prefetch-ring concurrency *visible*
    instead of a summed ``overlap_s`` scalar.

Extra context (CostLedger wall summary, metrics snapshot) rides in a
top-level ``"fdj"`` block — ignored by viewers, consumed by
``launch/trace_report.py`` to reconcile span sums against the ledger.
``validate_trace`` is the schema check behind ``trace_report --check``.
"""

from __future__ import annotations

import json
from typing import Optional

PROCESS_NAME = "fdj"
_PID = 1


def _resolve_tracks(spans) -> dict:
    """span_id -> track name (own track, else nearest ancestor's, else the
    recording thread)."""
    by_id = {sp.span_id: sp for sp in spans}
    out: dict = {}

    def resolve(sp) -> str:
        cached = out.get(sp.span_id)
        if cached is not None:
            return cached
        if sp.track:
            track = sp.track
        elif sp.parent_id is not None and sp.parent_id in by_id:
            track = resolve(by_id[sp.parent_id])
        else:
            track = f"thread:{sp.thread or 'main'}"
        out[sp.span_id] = track
        return track

    for sp in spans:
        resolve(sp)
    return out


def to_trace_events(tracer, metadata: Optional[dict] = None) -> dict:
    """Render ``tracer`` as a trace-event JSON object (see module doc)."""
    tracer.close_open_spans()
    spans = tracer.spans()
    tracks = _resolve_tracks(spans)
    # stable tid order: first appearance in span order
    tids: dict = {}
    for sp in spans:
        tids.setdefault(tracks[sp.span_id], len(tids) + 1)

    def us(t: float) -> float:
        return round((t - tracer.epoch) * 1e6, 3)

    events = [{"ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
               "args": {"name": PROCESS_NAME}}]
    for track, tid in tids.items():
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name", "args": {"name": track}})
    for sp in spans:
        tid = tids[tracks[sp.span_id]]
        args = dict(sp.attrs)
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        # dur from the *rounded* endpoints, so slices that share a raw
        # boundary stay exactly adjacent after rounding (validate_trace
        # checks ts+dur nesting)
        ts0, ts1 = us(sp.t0), us(sp.t1)
        events.append({
            "ph": "X", "pid": _PID, "tid": tid, "name": sp.name,
            "cat": sp.name.split("[", 1)[0],
            "ts": ts0, "dur": round(max(ts1 - ts0, 0.0), 3),
            "args": args,
        })
        for ev in sp.events:
            events.append({
                "ph": "i", "pid": _PID, "tid": tid, "name": ev.name,
                "s": "t", "ts": us(ev.ts),
                "args": dict(ev.attrs, span_id=sp.span_id),
            })
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if metadata:
        out["fdj"] = metadata
    return out


def write_trace(tracer, path: str, metadata: Optional[dict] = None) -> dict:
    obj = to_trace_events(tracer, metadata=metadata)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return obj


_REQUIRED = {"ph", "pid", "tid", "name"}


def validate_trace(obj) -> list:
    """Schema check for an exported trace object; returns a list of error
    strings (empty = valid).  Checks exactly what a viewer and
    trace_report rely on: the traceEvents envelope, required keys per
    phase, numeric non-negative ts/dur on slices, and same-track slice
    nesting (overlapping non-nested slices on one tid render garbage)."""
    errs = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    slices_by_tid: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event[{i}]: not an object")
            continue
        missing = _REQUIRED - set(ev)
        if missing:
            errs.append(f"event[{i}]: missing keys {sorted(missing)}")
            continue
        ph = ev["ph"]
        if ph not in ("X", "i", "M", "B", "E", "C"):
            errs.append(f"event[{i}]: unknown phase {ph!r}")
            continue
        if not isinstance(ev["name"], str) or not ev["name"]:
            errs.append(f"event[{i}]: name must be a nonempty string")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errs.append(f"event[{i}] {ev['name']!r}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event[{i}] {ev['name']!r}: bad dur {dur!r}")
            else:
                slices_by_tid.setdefault(ev["tid"], []).append(
                    (ev["ts"], ev["ts"] + dur, ev["name"]))
    for tid, slices in slices_by_tid.items():
        # enclosing slice first when starts tie, so a parent sharing its
        # child's t0 is on the stack before the child is checked
        slices.sort(key=lambda s: (s[0], -s[1]))
        open_stack: list = []
        for t0, t1, name in slices:
            while open_stack and open_stack[-1][0] <= t0 + 1e-6:
                open_stack.pop()
            if open_stack and t1 > open_stack[-1][0] + 1e-6:
                errs.append(
                    f"tid {tid}: slice {name!r} [{t0}, {t1}] overlaps "
                    f"{open_stack[-1][1]!r} without nesting")
                continue
            open_stack.append((t1, name))
    return errs
