"""repro_torch's JoinService against the JAX reference JoinService.

Ports of tests/test_join_service.py: every scenario runs on the reference
service (its ``numpy`` engine, barrier mode; one ``pallas`` case in
interpret mode) and on the port's service with the ``numpy`` and ``cuda``
engines on ``device="cpu"``, barrier and stream.  Each query's pairs,
theta, candidates, plan hit, delta rows, ledger dollars, plane counters
(hits, misses, dedup hits, bytes to the device) and recalibration
counters must equal the reference's exactly; the reference tests'
invariants (a free warm path, append ≡ cold concat, the rescale fallback,
the degenerate delta, the precision fallback, recalibration swap /
no-swap / gated off) are asserted on the port's results too.
"""

import numpy as np
import pytest

from repro.core import scaffold as j_scaffold_lib
from repro.core.join import (FDJConfig as JCfg, QueryOptions as JOpts)
from repro.data import synth as j_synth
from repro.serving.join_service import (JoinService as JService,
                                        hold_out_right as j_hold_out,
                                        perturb_rows as j_perturb)
from repro.serving.planes import FeaturePlaneStore as JStore
from repro_torch.core import scaffold as scaffold_lib
from repro_torch.core.join import (FDJConfig, QueryOptions, execute_join,
                                   fdj_join)
from repro_torch.core.scaffold import Scaffold
from repro_torch.data import synth
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.serving.join_service import (JoinService, hold_out_right,
                                              perturb_rows)
from repro_torch.serving.planes import FeaturePlaneStore

_OPTS = {"numpy": dict(block=64), "cuda": dict(tl=32, tr=64)}
_J_OPTS = {"numpy": dict(block=64), "pallas": dict(tl=32, tr=64)}
# (engine, stream) variants of the port held against one reference run
VARIANTS = [("numpy", False), ("numpy", True), ("cuda", False),
            ("cuda", True)]
_IDS = ["numpy", "numpy-stream", "cuda", "cuda-stream"]


def _police(mod, seed=3, n=15):
    return mod.police_records(n_incidents=n, reports_per_incident=2,
                              seed=seed)


def _movies(mod, seed=3, n=25):
    # embed-only planes: appends keep the incremental delta path
    return mod.movies_pages(n_movies=n, cast_size=4, filler_sentences=1,
                            seed=seed)


def _cfg(engine, stream=False, **kw):
    kw.setdefault("mc_trials", 4000)
    return FDJConfig(engine=engine, device="cpu", engine_opts=_OPTS[engine],
                     stream_refinement=stream, seed=0, **kw)


def _jcfg(engine="numpy", **kw):
    kw.setdefault("mc_trials", 4000)
    return JCfg(engine=engine, engine_opts=_J_OPTS[engine], seed=0, **kw)


def _summary(r) -> dict:
    """Everything of one ServeResult the port must reproduce exactly."""
    c = r.cost
    return {
        "pairs": sorted(r.pairs), "theta": np.asarray(r.join.theta).tolist(),
        "t_prime": r.join.t_prime, "candidate_count": r.join.candidate_count,
        "candidates": r.join.candidates, "plan_hit": r.plan_hit,
        "delta_rows": r.delta_rows, "recall": r.join.recall,
        "precision": r.join.precision, "met_target": r.join.met_target,
        "breakdown": c.breakdown(), "total": c.total,
        "store": {k: r.store[k] for k in ("hits", "misses", "dedup_hits",
                                          "bytes_to_device", "evictions",
                                          "superseded", "resident_bytes")},
        "bytes_h2d": c.bytes_h2d,
        "recal": (c.recalibrations, c.theta_swaps, c.theta_drift,
                  c.reservoir_cost),
    }


def _append_summary(info) -> dict:
    return {"rows": info["rows"], "total": info["ledger"].total,
            "inference": info["ledger"].inference,
            "store": {k: info["store"][k] for k in (
                "hits", "misses", "bytes_to_device", "superseded", "puts",
                "resident_bytes")}}


_REF: dict = {}


def _reference(name, fn):
    """Run a reference scenario once per test session."""
    if name not in _REF:
        _REF[name] = fn()
    return _REF[name]


def _assert_same(got: list, want: list):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert g[k] == w[k], (i, k, g[k], w[k])


# --- warm path --------------------------------------------------------------

def _warm_ref(engine):
    ds = _police(j_synth)
    svc = JService(ds, _jcfg(engine))
    return [_summary(svc.query()), _summary(svc.query())]


@pytest.mark.parametrize("engine,stream", VARIANTS, ids=_IDS)
def test_warm_repeat_is_free_and_identical(engine, stream):
    want = _reference("warm-numpy", lambda: _warm_ref("numpy"))
    ds = _police(synth)
    cfg = _cfg(engine, stream)
    one_shot = fdj_join(ds, ds.make_oracle(), SimulatedProposer(ds),
                        SimulatedExtractor(ds, seed=0), cfg)
    svc = JoinService(ds, cfg)
    cold = svc.query()
    warm = svc.query()
    _assert_same([_summary(cold), _summary(warm)], want)
    assert not cold.plan_hit and cold.pairs == one_shot.pairs
    assert warm.plan_hit and warm.pairs == one_shot.pairs
    assert warm.cost.inference == 0.0 and warm.cost.bytes_h2d == 0
    assert warm.store["misses"] == 0 and warm.store["hits"] > 0
    es = warm.join.engine_stats
    if es is not None:
        assert es.bytes_h2d == 0


def test_warm_repeat_matches_reference_pallas():
    """The cuda engine's warm path against the reference's Pallas kernel
    (interpret mode) on the same service scenario."""
    want = _reference("warm-pallas", lambda: _warm_ref("pallas"))
    svc = JoinService(_police(synth), _cfg("cuda"))
    _assert_same([_summary(svc.query()), _summary(svc.query())], want)
    assert want == _reference("warm-numpy", lambda: _warm_ref("numpy"))


def test_plan_and_planes_shared_across_engines():
    def ref():
        svc = JService(_police(j_synth),
                       JCfg(engine="numpy", engine_opts=_J_OPTS, seed=0,
                            mc_trials=4000))
        return [_summary(svc.query()),
                _summary(svc.query(JOpts(engine="pallas")))]
    want = _reference("shared-engines", ref)
    svc = JoinService(_police(synth),
                      FDJConfig(engine="numpy", device="cpu",
                                engine_opts=_OPTS, seed=0, mc_trials=4000))
    a = svc.query()
    b = svc.query(QueryOptions(engine="cuda"))
    _assert_same([_summary(a), _summary(b)], want)
    assert b.plan_hit and b.pairs == a.pairs
    assert b.cost.inference == 0.0 and b.cost.bytes_h2d == 0


@pytest.mark.parametrize("engine,stream", VARIANTS, ids=_IDS)
def test_warm_path_precision_extension(engine, stream):
    def ref():
        svc = JService(_police(j_synth), _jcfg(precision_target=0.9))
        return [_summary(svc.query()), _summary(svc.query())]
    want = _reference("warm-precision", ref)
    svc = JoinService(_police(synth), _cfg(engine, stream,
                                           precision_target=0.9))
    cold, warm = svc.query(), svc.query()
    _assert_same([_summary(cold), _summary(warm)], want)
    assert warm.pairs == cold.pairs and warm.cost.inference == 0.0


def test_queries_use_fresh_ledgers_and_accumulate():
    svc = JoinService(_police(synth), _cfg("cuda"))
    c = svc.query()
    w = svc.query()
    assert c.cost is not w.cost
    assert c.cost.inference > 0 and w.cost.inference == 0.0
    assert svc.ledger.total == pytest.approx(c.cost.total + w.cost.total)
    assert svc.ledger.plane_hits == c.cost.plane_hits + w.cost.plane_hits
    ref = JService(_police(j_synth), _jcfg())
    ref.query()
    ref.query()
    assert svc.ledger.breakdown() == ref.ledger.breakdown()
    assert svc.ledger.serving_summary() == ref.ledger.serving_summary()


# --- delta append -----------------------------------------------------------

def _append_scenario(mod, svc_cls, hold, cfg, n_delta, *, perturb=None,
                     seed=3):
    """query, append, query -> (summaries, append summary, service)."""
    base, rows = hold(_movies(mod, seed=seed), n_delta)
    if perturb is not None:
        rows = perturb(rows, seed=1)
    svc = svc_cls(base, cfg)
    first = svc.query()
    info = svc.append_right(rows)
    dq = svc.query()
    return [_summary(first), _summary(dq)], _append_summary(info), svc


def _cold_same_plan(svc, cfg):
    return execute_join(svc.dataset, svc.dataset.make_oracle(),
                        SimulatedExtractor(svc.dataset, seed=0), cfg,
                        svc._plans[svc._plan_key(cfg)], keep_candidates=True)


@pytest.mark.parametrize("engine,stream", VARIANTS, ids=_IDS)
def test_append_then_query_equals_cold_concat(engine, stream):
    want, want_app, _ = _reference("append", lambda: _append_scenario(
        j_synth, JService, j_hold_out, _jcfg(), 10))
    cfg = _cfg(engine, stream)
    got, got_app, svc = _append_scenario(synth, JoinService, hold_out_right,
                                         cfg, 10)
    _assert_same(got, want)
    assert got_app == want_app
    assert 0 < got_app["inference"] < 0.5 * got[0]["breakdown"]["inference"]
    dq = got[1]
    assert dq["plan_hit"] and dq["delta_rows"] == 10
    ref = _cold_same_plan(svc, cfg)
    assert dq["pairs"] == sorted(ref.pairs)
    assert dq["candidates"] == ref.candidates
    assert dq["recall"] == ref.recall


def test_scalar_rescale_falls_back_to_full_eval():
    fell_back = 0
    for n, seed in ((40, 0), (40, 2), (60, 1)):
        def run(mod, svc_cls, hold, cfg):
            full = mod.police_records(n_incidents=n, reports_per_incident=2,
                                      seed=seed)
            base, rows = hold(full, full.n_r // 5)
            svc = svc_cls(base, cfg)
            first = svc.query()
            svc.append_right(rows)
            return [_summary(first), _summary(svc.query())], svc
        want, _ = run(j_synth, JService, j_hold_out, _jcfg())
        cfg = _cfg("cuda")
        got, svc = run(synth, JoinService, hold_out_right, cfg)
        _assert_same(got, want)
        ref = _cold_same_plan(svc, cfg)
        assert got[1]["pairs"] == sorted(ref.pairs)
        assert got[1]["candidates"] == ref.candidates
        fell_back += int(got[1]["delta_rows"] == 0)
    assert fell_back > 0, "fixture never shifted the scale"


def test_delta_and_replan_paths_both_meet_guarantee():
    def run(mod, svc_cls, hold, cfg, opts):
        base, rows = hold(_movies(mod, seed=7), 8)
        svc = svc_cls(base, cfg)
        first = svc.query()
        svc.append_right(rows)
        dq = svc.query()
        replan = svc.query(opts(refresh_plan=True))
        return [_summary(first), _summary(dq), _summary(replan)], svc
    want, _ = _reference("replan", lambda: run(j_synth, JService, j_hold_out,
                                                _jcfg(), JOpts))
    cfg = _cfg("cuda")
    got, svc = run(synth, JoinService, hold_out_right, cfg, QueryOptions)
    _assert_same(got, want)
    first, dq, replan = got
    assert first["met_target"] and dq["delta_rows"] == 8
    assert dq["recall"] >= cfg.recall_target
    assert replan["delta_rows"] == 0 and not replan["plan_hit"]
    assert replan["recall"] >= cfg.recall_target
    cold = fdj_join(svc.dataset, svc.dataset.make_oracle(),
                    SimulatedProposer(svc.dataset),
                    SimulatedExtractor(svc.dataset, seed=0), cfg)
    assert replan["pairs"] == sorted(cold.pairs)


def test_append_extends_planes_without_rebuild():
    got, got_app, svc = _append_scenario(synth, JoinService, hold_out_right,
                                         _cfg("cuda"), 6)
    _, want_app, _ = _reference("append-6", lambda: _append_scenario(
        j_synth, JService, j_hold_out, _jcfg(), 6))
    assert got_app == want_app
    cold_upload = got[0]["store"]["bytes_to_device"]
    assert 0 < got_app["store"]["bytes_to_device"] < cold_upload
    assert got[1]["breakdown"]["inference"] == 0.0


def test_tiny_byte_budget_still_correct():
    def run(mod, svc_cls, store):
        svc = svc_cls(_police(mod), cfg_of[mod], store=store)
        return [_summary(svc.query()), _summary(svc.query())], svc.store
    cfg_of = {j_synth: _jcfg(), synth: _cfg("cuda")}
    want, jstore = run(j_synth, JService, JStore(byte_budget=64))
    got, store = run(synth, JoinService,
                     FeaturePlaneStore(byte_budget=64, device="cpu"))
    _assert_same(got, want)
    assert store.evictions == jstore.evictions > 0
    assert got[0]["pairs"] == got[1]["pairs"]


def test_degenerate_plan_delta_refines_only_new_columns(monkeypatch):
    monkeypatch.setattr(j_scaffold_lib, "get_logical_scaffold",
                        lambda *a, **k: j_scaffold_lib.Scaffold(clauses=[]))
    monkeypatch.setattr(scaffold_lib, "get_logical_scaffold",
                        lambda *a, **k: Scaffold(clauses=[]))
    want, _, _ = _append_scenario(j_synth, JService, j_hold_out, _jcfg(), 10)
    got, _, svc = _append_scenario(synth, JoinService, hold_out_right,
                                   _cfg("cuda"), 10)
    _assert_same(got, want)
    first, dq = got
    assert first["candidates"] is None
    assert dq["delta_rows"] == 10
    assert dq["candidate_count"] == svc.dataset.n_l * svc.dataset.n_r
    assert dq["pairs"] == sorted(svc.dataset.truth_set)
    assert 0 < dq["breakdown"]["refinement"]
    assert dq["total"] < 0.5 * first["total"]


@pytest.mark.parametrize("engine,stream", VARIANTS, ids=_IDS)
def test_precision_path_falls_back_to_full_eval_on_delta(engine, stream):
    want, _, _ = _reference("precision-delta", lambda: _append_scenario(
        j_synth, JService, j_hold_out, _jcfg(precision_target=0.9), 6))
    cfg = _cfg(engine, stream, precision_target=0.9)
    got, _, svc = _append_scenario(synth, JoinService, hold_out_right, cfg,
                                   6)
    _assert_same(got, want)
    assert got[1]["delta_rows"] == 0
    assert got[1]["pairs"] == sorted(_cold_same_plan(svc, cfg).pairs)


# --- online recalibration ---------------------------------------------------

@pytest.mark.parametrize("engine,stream", VARIANTS, ids=_IDS)
def test_recalibration_restores_recall_after_shifted_append(engine, stream):
    """A distribution-shifting append breaks the carried-forward theta:
    the port's reservoir check must swap theta exactly as the reference
    does (same reservoir, same sweep, same new theta) and restore
    recall >= T; gated off, both keep the broken theta."""
    def run(mod, svc_cls, hold, perturb, cfg):
        got, _, svc = _append_scenario(mod, svc_cls, hold, cfg, 10,
                                       perturb=perturb)
        return got + [_summary(svc.query())]
    want = _reference("recal-swap", lambda: run(
        j_synth, JService, j_hold_out, j_perturb, _jcfg()))
    want_ctl = _reference("recal-off", lambda: run(
        j_synth, JService, j_hold_out, j_perturb, _jcfg(recalibrate=False)))
    cfg = _cfg(engine, stream)
    got = run(synth, JoinService, hold_out_right, perturb_rows, cfg)
    ctl = run(synth, JoinService, hold_out_right, perturb_rows,
              _cfg(engine, stream, recalibrate=False))
    _assert_same(got, want)
    _assert_same(ctl, want_ctl)
    assert ctl[1]["recal"][0] == 0
    assert ctl[1]["recall"] < cfg.recall_target
    cold, post, again = got
    recalibrations, swaps, drift, dollars = post["recal"]
    assert recalibrations == 1 and swaps == 1 and drift > 0 and dollars > 0
    assert post["recall"] >= cfg.recall_target - 1e-12 and post["met_target"]
    assert post["delta_rows"] == 0 and post["theta"] != cold["theta"]
    assert again["recal"][0] == 0 and again["pairs"] == post["pairs"]


def test_recalibration_keeps_delta_path_on_stable_append():
    want, _, _ = _reference("append", lambda: _append_scenario(
        j_synth, JService, j_hold_out, _jcfg(), 10))
    got, _, svc = _append_scenario(synth, JoinService, hold_out_right,
                                   _cfg("cuda"), 10)
    _assert_same(got, want)
    recalibrations, swaps, drift, _ = got[1]["recal"]
    assert recalibrations == 1 and swaps == 0 and drift == 0.0
    assert got[1]["delta_rows"] == 10
    assert got[1]["recall"] >= svc.cfg.recall_target - 1e-12


def test_recalibration_skipped_for_degenerate_and_gated_off():
    def run(mod, svc_cls, hold, cfg):
        base, rows = hold(_police(mod, n=8), 3)
        svc = svc_cls(base, cfg)
        first = svc.query()
        svc.append_right(rows)
        return [_summary(first), _summary(svc.query())]
    kw = dict(thresh_positives=1, gen_positives=1, max_iter=1, gamma=2.0)
    want = run(j_synth, JService, j_hold_out, _jcfg(**kw))
    got = run(synth, JoinService, hold_out_right, _cfg("cuda", **kw))
    _assert_same(got, want)
    if not got[0]["theta"]:                  # degenerate as intended
        assert got[1]["recal"][0] == 0


# --- state carried across ----------------------------------------------------

def test_warm_query_from_reference_store_state():
    """The reference's warm store and plan, handed over as plain values
    (``convert.store_from_state`` / ``plan_from_state``), serve a warm port
    query: the reference's pairs, $0 extraction, no plane uploaded."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.serving.join_service import PlanLibrary

    jsvc = JService(_police(j_synth), _jcfg())
    jsvc.query()
    want = _summary(jsvc.query())
    entries = [{"spec": dataclasses.asdict(e.spec), "side": e.side,
                "fingerprint": e.key[4], "values": list(e.values),
                "host": np.asarray(e.host), "kind": e.kind,
                "scale": e.scale}
               for side, fp in (("l", jsvc._fp_l), ("r", jsvc._fp_r))
               for e in jsvc.store.entries_for(side, fp)]
    plan = jsvc._plans[jsvc._plan_key(jsvc.cfg)]
    state = {"specs": [dataclasses.asdict(s) for s in plan.specs],
             "clauses": plan.scaffold.clauses, "theta": plan.theta,
             "t_prime": plan.t_prime, "feasible": plan.feasible,
             "conjunct_order": plan.conjunct_order,
             "calib_pairs": plan.calib_pairs,
             "calib_labels": plan.calib_labels}

    store = convert.store_from_state(entries, device="cpu")
    assert store.snapshot()["entries"] == len(entries)
    assert store.bytes_to_device == sum(e["host"].nbytes for e in entries)
    for e in entries:
        pinned = store.peek(convert.spec_from_state(e["spec"]), e["side"],
                            e["fingerprint"])
        np.testing.assert_array_equal(pinned.device.numpy(), e["host"])
    cfg = _cfg("cuda")
    lib = PlanLibrary()
    svc = JoinService(_police(synth), cfg, store=store, plan_library=lib)
    lib.put((svc._fp_l, svc._fp_r, svc._plan_key(cfg)),
            convert.plan_from_state(state))
    got = svc.query()
    _assert_same([_summary(got)], [want])
    assert got.plan_hit and got.cost.inference == 0.0
    assert got.store["misses"] == 0 and got.cost.bytes_h2d == 0


def test_serving_entry_points_default_to_cuda():
    """The store, the service and the fleet run on ``cuda`` unless asked
    for ``cpu``; without a GPU they raise instead of carrying on on the
    CPU."""
    import torch
    from repro_torch.launch.serve_join import run_serve
    from repro_torch.serving.fleet import JoinFleet
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda defaults would run")
    assert FDJConfig().device == "cuda"
    for make in (lambda: FeaturePlaneStore(),
                 lambda: JoinService(_police(synth)),
                 lambda: JoinFleet(),
                 lambda: run_serve("products", size=0.2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
