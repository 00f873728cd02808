"""repro_torch's metrics, trace export and trace report.

  * ``ledger_from_metrics(svc.metrics)`` equals ``svc.ledger`` for the
    port's JoinService after queries and appends (the service binds every
    per-query ledger to its registry): int fields exactly, float fields
    up to float association order (the registry adds per-charge deltas,
    the lifetime ledger per-query sums — the reference's own test allows
    the same), and the port's ledgers equal the reference service's;
  * a trace written by the port's launchers with ``--trace-out`` passes
    both the reference's and the port's ``trace_report --check``, and the
    port's report imports neither jax nor the JAX package;
  * the port's ``MetricsRegistry`` (a copy of the reference's) behaves as
    the reference's tests/test_obs.py pins it.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.core.join import FDJConfig as JCfg
from repro.data import synth as j_synth
from repro.launch import trace_report as j_report
from repro.serving.join_service import (JoinService as JService,
                                        hold_out_right as j_hold_out)
from repro_torch.core.costs import CostLedger, ledger_from_metrics
from repro_torch.core.join import FDJConfig
from repro_torch.data import synth
from repro_torch.launch import trace_report
from repro_torch.launch.join import run_join
from repro_torch.launch.serve_join import run_serve
from repro_torch.obs import MetricsRegistry, Tracer, to_trace_events
from repro_torch.serving.join_service import JoinService, hold_out_right

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _movies(mod):
    return mod.movies_pages(n_movies=20, cast_size=4, filler_sentences=1,
                            seed=3)


def _ledgers_close(a, b):
    import dataclasses
    import math
    for f in dataclasses.fields(CostLedger):
        if not f.compare:
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, int) and isinstance(vb, int):
            ok = va == vb
        else:
            ok = math.isclose(va, vb, rel_tol=1e-9, abs_tol=1e-12)
        if not ok:
            return False, (f.name, va, vb)
    return True, None


def _stream(svc, delta):
    svc.query()
    svc.query()
    svc.append_right(delta)
    svc.query()


@pytest.mark.parametrize("engine", ["numpy", "cuda"])
def test_join_service_metrics_derive_lifetime_ledger(engine):
    base, delta = hold_out_right(_movies(synth), n_delta=4)
    opts = {"numpy": dict(block=64), "cuda": dict(tl=32, tr=64)}[engine]
    svc = JoinService(base, FDJConfig(engine=engine, device="cpu",
                                      engine_opts=opts, seed=0,
                                      mc_trials=4000))
    svc.query()
    ok, why = _ledgers_close(ledger_from_metrics(svc.metrics), svc.ledger)
    assert ok, why
    svc.query()
    svc.append_right(delta)
    svc.query()
    ok, why = _ledgers_close(ledger_from_metrics(svc.metrics), svc.ledger)
    assert ok, why
    assert svc.metrics.value("serve.plan_hits") >= 1.0
    assert svc.metrics.histogram("serve.query_wall_s").count == 3
    # the same stream on the reference service: the same dollars and
    # plane / recalibration counters (walls differ: they are clocks)
    jbase, jdelta = j_hold_out(_movies(j_synth), n_delta=4)
    ref = JService(jbase, JCfg(engine="numpy", engine_opts=dict(block=64),
                               seed=0, mc_trials=4000))
    _stream(ref, jdelta)
    assert svc.ledger.breakdown() == ref.ledger.breakdown()
    assert svc.ledger.serving_summary() == ref.ledger.serving_summary()
    for name in ("serve.plan_hits", "serve.plan_misses"):
        assert svc.metrics.value(name) == ref.metrics.value(name)


def _check_both(path):
    with open(path) as f:
        obj = json.load(f)
    assert trace_report.check(obj) == []
    assert j_report.check(obj) == []
    assert trace_report.main([path, "--check"]) == 0
    assert "fdj_join" in trace_report.report(obj) or \
        "query" in trace_report.report(obj)
    return obj


@pytest.mark.parametrize("stream", [False, True], ids=["barrier", "stream"])
def test_join_trace_out_passes_both_checks(tmp_path, stream):
    path = str(tmp_path / "join.json")
    out = run_join("products", size=0.3, engine="cuda", device="cpu",
                   stream=stream, trace_out=path)
    obj = _check_both(path)
    names = {ev["name"] for ev in obj["traceEvents"] if ev.get("ph") == "X"}
    assert {"fdj_join", "plan", "extract", "kernel", "mask_pull"} <= names
    assert obj["fdj"]["engine"] == "cuda" and obj["fdj"]["device"] == "cpu"
    assert out["candidates"] > 0


def test_serve_trace_out_passes_both_checks(tmp_path):
    path = str(tmp_path / "serve.json")
    run_serve("products", engine="cuda", size=0.2, holdout=10,
              script="query,query,append=5,query", trace_out=path,
              device="cpu")
    obj = _check_both(path)
    queries = [ev for ev in obj["traceEvents"]
               if ev.get("ph") == "X" and ev["name"] == "query"]
    assert len(queries) == 3
    assert obj["fdj"]["metrics"]["serve.plan_hits"] == 2


def test_trace_report_check_rejects_a_broken_trace(tmp_path):
    path = str(tmp_path / "t.json")
    run_join("products", size=0.3, engine="numpy", device="cpu",
             trace_out=path)
    with open(path) as f:
        obj = json.load(f)
    x = next(ev for ev in obj["traceEvents"] if ev.get("ph") == "X")
    obj["traceEvents"].append(dict(x, name="bad", dur=-1.0))
    assert trace_report.check(obj) and j_report.check(obj)


_REPORT_ONLY = """
import json, sys
from repro_torch.launch import trace_report
rc = trace_report.main([sys.argv[1], "--check"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"rc": rc, "bad": bad}))
"""


def test_port_trace_report_imports_no_jax(tmp_path):
    path = str(tmp_path / "t.json")
    run_join("products", size=0.3, engine="cuda", device="cpu",
             trace_out=path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _REPORT_ONLY, path],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "bad": []}


# --- metrics registry (copies of the reference's tests) ----------------------

def test_histogram_quantiles_within_log_bucket_error():
    reg = MetricsRegistry()
    vals = [0.001 * (i + 1) for i in range(1000)]
    for v in vals:
        reg.observe("lat", v)
    h = reg.histogram("lat")
    s = h.summary()
    assert s["count"] == 1000 and abs(s["sum"] - sum(vals)) < 1e-9
    assert s["min"] == vals[0] and s["max"] == vals[-1]
    for q, true in [(0.50, 0.5005), (0.90, 0.9005), (0.99, 0.9905)]:
        est = h.quantile(q)
        assert abs(est - true) / true < 0.15, (q, est, true)
    assert s["p50"] <= s["p90"] <= s["p99"] <= s["max"]


def test_registry_as_dict_flattens_histograms():
    reg = MetricsRegistry()
    reg.inc("c", 2)
    reg.set_gauge("g", 7)
    reg.observe("h", 1.0)
    reg.observe("z", 0.0)
    d = reg.as_dict()
    assert d["c"] == 2 and d["g"] == 7.0
    assert d["h.count"] == 1 and d["h.p50"] == 1.0
    assert reg.histogram("z").quantile(0.5) == 0.0


def test_ledger_from_metrics_round_trip():
    led = CostLedger()
    led.charge_label(1000, 10)
    led.charge_extraction(800, 80)
    led.record_walls(1.5, 0.5, 0.25)
    led.record_plane_traffic(hits=3, misses=1, evicted_bytes=128,
                             resident_bytes=4096, bytes_h2d=2048)
    led.record_recalibration(swapped=True, drift=0.02, dollars=0.003)
    reg = MetricsRegistry()
    led.bind_metrics(reg)
    assert ledger_from_metrics(reg) == led
    led.charge_refine(100, 1)
    led.record_plane_traffic(hits=1, resident_bytes=5000)
    assert ledger_from_metrics(reg) == led
    assert isinstance(ledger_from_metrics(reg).plane_hits, int)


def test_export_matches_reference_schema():
    """The port's exporter writes what the reference's validator reads."""
    from repro.obs.export import validate_trace as j_validate
    tr = Tracer()
    with tr.span("outer", k=1):
        with tr.span("inner", track="worker"):
            pass
    obj = to_trace_events(tr, metadata={"x": 1})
    assert j_validate(obj) == [] and trace_report.check(obj) == []
    assert obj["fdj"] == {"x": 1}
