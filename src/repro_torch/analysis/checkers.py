"""Repo-specific AST lint rules ruff cannot express (DESIGN.md §9), over
the port's tree (the JAX package's ``analysis/checkers.py`` with the
port's paths).

Four rules, each guarding an invariant the reference introduced and the
port keeps:

``tracer-guard``
    Every ``tracer.record_span / .event / .current_span`` call on a
    *possibly-null* tracer must sit under an ``if tracer:`` truthiness
    guard (or ternary).  The no-op path's guarantee (tracing off
    costs one falsy check) dies the day someone calls ``record_span``
    unguarded — NullTracer would need real methods and the hot loop a
    real call.  ``with tracer.span(...)`` is exempt: ``span`` exists on
    NullTracer precisely so with-statements stay unconditional.  A
    parameter annotated non-Optional ``Tracer`` is treated as guarded:
    the annotation states the caller's contract (guard before calling).

``legacy-kwargs``
    ``QueryOptions.from_legacy`` and legacy query kwargs
    (``engine=``/``recall_target=``/... on ``.query``/``.append_right``)
    are a deprecation shim for *external* callers.  Internal call
    sites must construct ``QueryOptions`` directly — otherwise the shim
    can never be deleted and every internal call pays a
    DeprecationWarning.  Only the shim's own module may reference it.

``metric-name``
    Every literal metric name passed to ``inc/observe/set_gauge`` must
    be declared: ledger-derived names in ``core.costs.FIELD_METRICS`` /
    ``GAUGE_METRICS`` (the ledger↔metrics round-trip invariant),
    serving-layer names in ``obs.metrics.DECLARED_METRICS``.  A typo'd
    name otherwise creates a dangling instrument that dashboards and
    ``ledger_from_metrics`` silently never see.

``wallclock``
    ``time.time()`` is banned in span-path packages (obs, core, engine,
    serving, kernels, distributed): span math must use
    ``time.perf_counter()`` — wall clock steps under NTP and breaks
    duration/overlap accounting.  Deliberate wall-clock metadata reads
    carry a ``# wallclock-ok:`` comment on the same line.
"""

from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.findings import Finding, iter_py_sources

# --------------------------------------------------------------------------
# tracer-guard
# --------------------------------------------------------------------------

# methods that only exist on a real Tracer (NullTracer has span/__bool__)
_TRACER_ONLY = ("record_span", "event", "current_span")
# files allowed to touch tracer internals unguarded
_TRACER_EXEMPT = ("src/repro_torch/obs/trace.py",)


def _looks_like_tracer(e) -> Optional[str]:
    """Variable name if ``e`` plausibly evaluates to a maybe-null tracer."""
    if isinstance(e, ast.Name) and "tracer" in e.id.lower():
        return e.id
    if isinstance(e, ast.Attribute) and "tracer" in e.attr.lower():
        return ast.unparse(e)
    return None


class _TracerGuardVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list = []
        self._guarded: list = []       # stack of guarded tracer exprs

    @staticmethod
    def _truthy_names(test) -> list:
        """Tracer-ish expressions asserted truthy by an ``if`` test."""
        out = []
        t = _looks_like_tracer(test)
        if t:
            out.append(t)
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for v in test.values:
                out.extend(_TracerGuardVisitor._truthy_names(v))
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], ast.IsNot):
            out.extend(filter(None, [_looks_like_tracer(test.left)]))
        return out

    def _visit_func(self, node):
        # a param annotated `Tracer` (not Optional[Tracer]) is non-null
        # by signature: the caller guards, per the annotation contract
        names = []
        for a in (list(node.args.posonlyargs) + list(node.args.args)
                  + list(node.args.kwonlyargs)):
            ann = a.annotation
            if isinstance(ann, ast.Name) and ann.id == "Tracer":
                names.append(a.arg)
            elif isinstance(ann, ast.Attribute) and ann.attr == "Tracer":
                names.append(a.arg)
        self._guarded.extend(names)
        self.generic_visit(node)
        del self._guarded[len(self._guarded) - len(names):]

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_If(self, node):
        names = self._truthy_names(node.test)
        self._guarded.extend(names)
        for st in node.body:
            self.visit(st)
        del self._guarded[len(self._guarded) - len(names):]
        for st in node.orelse:
            self.visit(st)

    def visit_IfExp(self, node):
        names = self._truthy_names(node.test)
        self._guarded.extend(names)
        self.visit(node.body)
        del self._guarded[len(self._guarded) - len(names):]
        self.visit(node.test)
        self.visit(node.orelse)

    def visit_BoolOp(self, node):
        # ``tracer and tracer.event(...)`` guards the right-hand side
        if isinstance(node.op, ast.And) and len(node.values) >= 2:
            names = []
            for v in node.values[:-1]:
                names.extend(self._truthy_names(v))
                self.visit(v)
            self._guarded.extend(names)
            self.visit(node.values[-1])
            del self._guarded[len(self._guarded) - len(names):]
            return
        self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _TRACER_ONLY:
            recv = _looks_like_tracer(f.value)
            if recv is not None and recv not in self._guarded:
                self.findings.append(Finding(
                    "tracer-guard", self.path, node.lineno,
                    f"unguarded tracer call {recv}.{f.attr}(...): wrap "
                    f"in `if {recv}:` so the no-op path stays one falsy "
                    f"check (NullTracer has no {f.attr})"))
        self.generic_visit(node)


def check_tracer_guards(sources: list) -> list:
    out = []
    for path, src in sources:
        if path in _TRACER_EXEMPT:
            continue
        v = _TracerGuardVisitor(path)
        v.visit(ast.parse(src, filename=path))
        out.extend(v.findings)
    return out


# --------------------------------------------------------------------------
# legacy-kwargs
# --------------------------------------------------------------------------

# the one module allowed to mention the shim: where it is defined/used
# to coerce *external* kwargs
_LEGACY_EXEMPT = ("src/repro_torch/core/join.py",
                  "src/repro_torch/serving/join_service.py")
# legacy kwarg names on .query/.append_right that the shim absorbs
_LEGACY_KWARGS = frozenset({
    "engine", "stream", "recall_target", "precision_target", "delta",
})
_LEGACY_METHODS = ("query", "append_right")


def check_legacy_kwargs(sources: list) -> list:
    out = []
    for path, src in sources:
        if path in _LEGACY_EXEMPT:
            continue
        tree = ast.parse(src, filename=path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "from_legacy":
                out.append(Finding(
                    "legacy-kwargs", path, node.lineno,
                    "internal call to QueryOptions.from_legacy: construct "
                    "QueryOptions(...) directly — the shim exists only to "
                    "absorb external legacy kwargs and must stay deletable"))
            elif isinstance(f, ast.Attribute) \
                    and f.attr in _LEGACY_METHODS:
                bad = sorted(kw.arg for kw in node.keywords
                             if kw.arg in _LEGACY_KWARGS)
                if bad:
                    out.append(Finding(
                        "legacy-kwargs", path, node.lineno,
                        f".{f.attr}({', '.join(bad)}=...) uses deprecated "
                        f"legacy kwargs: pass "
                        f"options=QueryOptions(...) instead"))
    return out


# --------------------------------------------------------------------------
# metric-name
# --------------------------------------------------------------------------

_METRIC_METHODS = ("inc", "observe", "set_gauge")
# registry internals + the ledger binding construct names dynamically
_METRIC_EXEMPT = ("src/repro_torch/obs/metrics.py",
                  "src/repro_torch/core/costs.py")


def _declared_metric_names() -> set:
    from repro_torch.core.costs import FIELD_METRICS, GAUGE_METRICS
    from repro_torch.obs.metrics import DECLARED_METRICS
    return (set(FIELD_METRICS.values()) | set(GAUGE_METRICS.values())
            | set(DECLARED_METRICS))


def check_metric_names(sources: list,
                       declared: Optional[set] = None) -> list:
    if declared is None:
        declared = _declared_metric_names()
    out = []
    for path, src in sources:
        if path in _METRIC_EXEMPT:
            continue
        tree = ast.parse(src, filename=path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in _METRIC_METHODS and node.args):
                continue
            recv = f.value
            recv_txt = ast.unparse(recv)
            if "metric" not in recv_txt.lower():
                continue               # counter.inc(), histogram.observe()
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue               # dynamic names audited at runtime
            if arg.value not in declared:
                out.append(Finding(
                    "metric-name", path, node.lineno,
                    f"metric {arg.value!r} is not declared: add it to "
                    f"obs.metrics.DECLARED_METRICS (serving-layer) or "
                    f"derive it from the ledger maps in core.costs"))
    return out


# --------------------------------------------------------------------------
# wallclock
# --------------------------------------------------------------------------

# packages on the span path: durations here must be monotonic
_SPAN_PATH_PREFIXES = (
    "src/repro_torch/obs/", "src/repro_torch/core/",
    "src/repro_torch/engine/", "src/repro_torch/serving/",
    "src/repro_torch/kernels/", "src/repro_torch/distributed/",
)
_WALLCLOCK_OK = "# wallclock-ok:"


def check_wallclock(sources: list) -> list:
    out = []
    for path, src in sources:
        if not path.startswith(_SPAN_PATH_PREFIXES):
            continue
        lines = src.splitlines()
        tree = ast.parse(src, filename=path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "time"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "time"):
                continue
            line_txt = lines[node.lineno - 1] \
                if node.lineno <= len(lines) else ""
            if _WALLCLOCK_OK in line_txt:
                continue
            out.append(Finding(
                "wallclock", path, node.lineno,
                "time.time() on the span path: use time.perf_counter() "
                "for durations (wall clock steps under NTP); if this is "
                "deliberate wall-clock metadata, annotate the line with "
                "`# wallclock-ok: <reason>`"))
    return out


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def run_checkers(sources: Optional[list] = None) -> list:
    """All four rules over ``(path, source)`` pairs (default:
    src/repro_torch, and the port's one caller outside it,
    ``chip_smoke.py``, for the legacy-kwargs rule)."""
    if sources is None:
        sources = iter_py_sources("src/repro_torch")
        extra = iter_py_sources("chip_smoke.py")
    else:
        extra = []
    findings = []
    findings += check_tracer_guards(sources)
    findings += check_legacy_kwargs(sources + extra)
    findings += check_metric_names(sources)
    findings += check_wallclock(sources)
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings
