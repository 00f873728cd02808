"""The port's QueryOptions surface: one typed request shared by
``JoinService.query``, ``append_right`` and ``JoinFleet.submit``; the
historical kwarg surface survives only as a deprecation shim routed
through ``QueryOptions.from_legacy``.

Ports the 7 tests of tests/test_query_options.py, on ``device="cpu"``:
the shim's mapping and its warnings, both forms byte-identical (and equal
to the reference service's numbers on the same corpus), both forms
together raising, and ``append_right`` validating its options.
"""

import pytest

from repro_torch.core.join import FDJConfig, QueryOptions
from repro_torch.data import synth
from repro_torch.serving.join_service import JoinService, hold_out_right


def _ds(seed=3, n=12):
    return synth.police_records(n_incidents=n, reports_per_incident=2,
                                seed=seed)


def _cfg(**kw):
    kw.setdefault("mc_trials", 4000)
    return FDJConfig(engine="numpy", engine_opts=dict(block=64), seed=0,
                     device="cpu", **kw)


# --- the adapter itself -----------------------------------------------------

def test_from_legacy_maps_named_kwargs_and_overrides():
    opts = QueryOptions.from_legacy(engine="numpy", stream=True,
                                    recall_target=0.8, mc_trials=3000)
    assert opts == QueryOptions(engine="numpy", stream=True,
                                recall_target=0.8,
                                overrides={"mc_trials": 3000})


def test_resolve_applies_named_fields_over_overrides():
    base = _cfg()
    cfg = QueryOptions(recall_target=0.8, stream=True,
                       overrides={"mc_trials": 2000}).resolve(base)
    assert cfg.recall_target == 0.8
    assert cfg.stream_refinement is True
    assert cfg.mc_trials == 2000
    assert base.recall_target != 0.8            # base untouched
    assert QueryOptions().resolve(base) is base  # no-op request: same cfg


def test_unknown_override_raises_at_resolve_time():
    with pytest.raises(TypeError):
        QueryOptions(overrides={"no_such_knob": 1}).resolve(_cfg())


# --- the service surface ----------------------------------------------------

def test_legacy_kwargs_warn_and_match_options_byte_identically():
    from repro.core.join import FDJConfig as JCfg, QueryOptions as JOptions
    from repro.data import synth as j_synth
    from repro.serving.join_service import JoinService as JService
    ds = _ds()
    new = JoinService(ds, _cfg())
    old = JoinService(ds, _cfg())
    r_new = new.query(QueryOptions(recall_target=0.85, stream=True,
                                   overrides={"mc_trials": 3000}))
    with pytest.warns(DeprecationWarning):
        r_old = old.query(recall_target=0.85, stream=True, mc_trials=3000)
    assert r_old.pairs == r_new.pairs
    assert r_old.join.t_prime == r_new.join.t_prime
    assert r_old.join.recall == r_new.join.recall
    assert r_old.join.candidate_count == r_new.join.candidate_count
    assert r_old.cost.total == r_new.cost.total
    ref = JService(j_synth.police_records(n_incidents=12,
                                          reports_per_incident=2, seed=3),
                   JCfg(engine="numpy", engine_opts=dict(block=64), seed=0,
                        mc_trials=4000))
    want = ref.query(JOptions(recall_target=0.85, stream=True,
                              overrides={"mc_trials": 3000}))
    assert r_new.pairs == want.pairs
    assert (r_new.join.t_prime, r_new.join.candidate_count,
            r_new.cost.total) == (want.join.t_prime,
                                  want.join.candidate_count, want.cost.total)


def test_refresh_plan_kwarg_is_also_shimmed():
    ds = _ds()
    svc = JoinService(ds, _cfg())
    svc.query()                                  # no legacy kwargs: no warn
    with pytest.warns(DeprecationWarning):
        r = svc.query(refresh_plan=True)
    assert r.plan_hit is False
    r = svc.query(QueryOptions(refresh_plan=True))   # typed form: silent
    assert r.plan_hit is False


def test_both_forms_together_raise():
    svc = JoinService(_ds(), _cfg())
    with pytest.raises(TypeError, match="not both"):
        svc.query(QueryOptions(), recall_target=0.9)


def test_append_right_validates_options():
    ds, pool = hold_out_right(_ds(n=14), 4)
    svc = JoinService(ds, _cfg())
    svc.query()
    with pytest.raises(TypeError):
        svc.append_right(pool, QueryOptions(overrides={"bogus": 1}))
    info = svc.append_right(pool, QueryOptions())    # valid shape accepted
    assert info["rows"] == len(pool.texts)
