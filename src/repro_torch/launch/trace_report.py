"""Trace report — text rendering + schema check for exported FDJ traces.

  PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json
  PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json --check

Consumes the Perfetto/Chrome trace-event JSON written by
``launch/join.py --trace-out`` / ``launch/serve_join.py --trace-out``
(obs.export) and prints what a viewer would show, for terminals and CI:

  * per-category slice totals (``band_step[7]`` aggregates as
    ``band_step``);
  * an ASCII timeline, one row per track (tid), so prefetch-ring overlap
    — ``band_step[k+1]``'s in-flight dispatch window riding over
    ``band_step[k]``'s pull — is visible without a browser;
  * the measured cross-track dispatch∩pull overlap seconds (exactly the
    thing ``prefetch_depth >= 2`` buys and depth 1 must score 0 on);
  * the critical path: the chain of longest children from the longest
    root span (the tree is reconstructed from span_id/parent_id in
    ``args`` — the flat trace-event format carries it through);
  * reconciliation of span sums against the CostLedger wall summary the
    exporter embedded under the top-level ``"fdj"`` key: Σ pull slices
    vs ``step2_pull_wall``, Σ dispatch ``enqueue_s`` vs
    ``step2_dispatch_wall`` — the spans and the ledger measure the same
    perf_counter reads, so they must agree within ``RECONCILE_TOL``.

``--check`` validates instead of rendering: obs.export.validate_trace
(envelope, phases, same-track nesting) plus the reconciliation bound,
exit 1 on any failure.  Imports neither jax nor the JAX package, so it
checks a trace on a machine that has only the port's dependencies.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.export import validate_trace

RECONCILE_TOL = 0.05                   # ledger-vs-span agreement bound
_TIMELINE_COLS = 60


def _slices(obj) -> list:
    """[{name, cat, tid, t0, t1, args}] for every complete slice."""
    out = []
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        t0 = float(ev["ts"])
        out.append({"name": ev["name"],
                    "cat": ev.get("cat") or ev["name"].split("[", 1)[0],
                    "tid": ev["tid"], "t0": t0,
                    "t1": t0 + float(ev.get("dur", 0.0)),
                    "args": ev.get("args", {})})
    return out


def _track_names(obj) -> dict:
    return {ev["tid"]: ev["args"].get("name", f"tid{ev['tid']}")
            for ev in obj.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "thread_name"}


def _categories(slices) -> list:
    agg: dict = {}
    for s in slices:
        a = agg.setdefault(s["cat"], [0, 0.0, 0.0])
        dur = s["t1"] - s["t0"]
        a[0] += 1
        a[1] += dur
        a[2] = max(a[2], dur)
    return sorted(agg.items(), key=lambda kv: -kv[1][1])


def _timeline(slices, tracks) -> list:
    if not slices:
        return []
    lo = min(s["t0"] for s in slices)
    hi = max(s["t1"] for s in slices)
    span = max(hi - lo, 1e-9)
    width = max(len(n) for n in tracks.values()) if tracks else 8
    lines = []
    for tid in sorted({s["tid"] for s in slices}):
        cells = [" "] * _TIMELINE_COLS
        for s in (x for x in slices if x["tid"] == tid):
            c0 = int((s["t0"] - lo) / span * (_TIMELINE_COLS - 1))
            c1 = int((s["t1"] - lo) / span * (_TIMELINE_COLS - 1))
            for c in range(c0, c1 + 1):
                cells[c] = "#"
        name = tracks.get(tid, f"tid{tid}")
        lines.append(f"  {name:<{width}} |{''.join(cells)}|")
    return lines


def ring_overlap_s(slices) -> float:
    """Seconds during which one band step's in-flight dispatch window and
    a *different* band step's pull window coincide — the prefetch ring's
    achieved concurrency (0 by construction at depth 1)."""
    disp = [s for s in slices if s["name"] == "dispatch"]
    pull = [s for s in slices if s["name"] == "pull"]
    tot = 0.0
    for d in disp:
        for p in pull:
            if d["args"].get("parent_id") == p["args"].get("parent_id"):
                continue               # same band step: serial by definition
            tot += max(0.0, min(d["t1"], p["t1"]) - max(d["t0"], p["t0"]))
    return tot / 1e6


def critical_path(slices) -> list:
    """Longest root, then its longest child, recursively."""
    by_id = {s["args"]["span_id"]: s for s in slices
             if "span_id" in s["args"]}
    kids: dict = {}
    for s in by_id.values():
        pid = s["args"].get("parent_id")
        if pid in by_id:
            kids.setdefault(pid, []).append(s)
    roots = [s for s in by_id.values()
             if s["args"].get("parent_id") not in by_id]
    path = []
    cur = max(roots, key=lambda s: s["t1"] - s["t0"], default=None)
    while cur is not None:
        path.append(cur)
        cur = max(kids.get(cur["args"]["span_id"], []),
                  key=lambda s: s["t1"] - s["t0"], default=None)
    return path


def reconcile(obj, slices) -> list:
    """[(label, span_sum_s, ledger_s, rel_err, ok)] for every wall the
    trace can cross-check against the embedded ledger summary."""
    walls = (obj.get("fdj") or {}).get("wall_summary") or {}
    checks = []

    def add(label, span_sum, key):
        ledger = walls.get(key)
        if ledger is None:
            return
        rel = abs(span_sum - ledger) / max(abs(ledger), 1e-9)
        # sub-millisecond walls reconcile on absolute error: relative
        # error on a 50µs wall is pure scheduler noise
        ok = rel <= RECONCILE_TOL or abs(span_sum - ledger) < 1e-3
        checks.append((label, span_sum, ledger, rel, ok))

    add("Σ pull slices vs step2_pull_wall",
        sum(s["t1"] - s["t0"] for s in slices if s["name"] == "pull") / 1e6,
        "step2_pull_wall")
    add("Σ dispatch enqueue_s vs step2_dispatch_wall",
        sum(s["args"].get("enqueue_s", 0.0)
            for s in slices if s["name"] == "dispatch"),
        "step2_dispatch_wall")
    add("Σ refine_batch slices vs refine_wall",
        sum(s["t1"] - s["t0"]
            for s in slices if s["cat"] in ("refine_batch", "refine_final"))
        / 1e6,
        "refine_wall")
    return checks


def report(obj) -> str:
    slices = _slices(obj)
    tracks = _track_names(obj)
    lines = []
    if slices:
        span = (max(s["t1"] for s in slices)
                - min(s["t0"] for s in slices)) / 1e6
        lines.append(f"trace: {len(slices)} slices, "
                     f"{len({s['tid'] for s in slices})} tracks, "
                     f"{span:.3f} s")
    else:
        lines.append("trace: empty")
    lines.append("")
    lines.append(f"  {'category':<16} {'count':>5} {'total_s':>9} "
                 f"{'max_ms':>9}")
    for cat, (n, tot, mx) in _categories(slices):
        lines.append(f"  {cat:<16} {n:>5} {tot / 1e6:>9.4f} "
                     f"{mx / 1e3:>9.2f}")
    lines.append("")
    lines.extend(_timeline(slices, tracks))
    lines.append("")
    lines.append(f"ring overlap (dispatch-in-flight ∩ other steps' pulls): "
                 f"{ring_overlap_s(slices):.4f} s")
    path = critical_path(slices)
    if path:
        lines.append("critical path: " + " > ".join(
            f"{s['name']} ({(s['t1'] - s['t0']) / 1e6:.3f}s)" for s in path))
    checks = reconcile(obj, slices)
    if checks:
        lines.append("")
        lines.append("reconciliation vs ledger wall summary:")
        for label, span_s, ledger_s, rel, ok in checks:
            lines.append(f"  {label}: {span_s:.4f}s vs {ledger_s:.4f}s "
                         f"({rel * 100:.1f}%) {'OK' if ok else 'FAIL'}")
    return "\n".join(lines)


def check(obj) -> list:
    """Schema + reconciliation errors (empty = trace passes the CI gate)."""
    errs = list(validate_trace(obj))
    for label, span_s, ledger_s, rel, ok in reconcile(obj, _slices(obj)):
        if not ok:
            errs.append(f"reconciliation: {label}: span sum {span_s:.4f}s "
                        f"vs ledger {ledger_s:.4f}s "
                        f"({rel * 100:.1f}% > {RECONCILE_TOL * 100:.0f}%)")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("trace", help="trace-event JSON file (--trace-out)")
    ap.add_argument("--check", action="store_true",
                    help="validate schema + ledger reconciliation instead "
                         "of rendering; exit 1 on any failure")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        obj = json.load(f)
    if args.check:
        errs = check(obj)
        for e in errs:
            print(f"FAIL: {e}")
        n = len(_slices(obj))
        if not errs:
            print(f"OK: {args.trace}: {n} slices, schema valid, "
                  f"ledger reconciled")
        return 1 if errs else 0
    print(report(obj))
    return 0


if __name__ == "__main__":
    sys.exit(main())
