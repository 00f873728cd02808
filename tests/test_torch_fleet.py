"""repro_torch's JoinFleet against the JAX reference fleet.

Ports of tests/test_fleet.py's scheduler, plan-library and end-to-end
fleet tests (the store-tenancy tests are in tests/test_torch_planes.py).
The fleet runs tenants on the port's ``numpy`` and ``cuda`` engines on
``device="cpu"``; its queries must give the reference fleet's pairs,
dollars and plane counters (dedup hits included), and concurrent runs
must equal serial ones byte for byte.  ``_gated_cfg`` leaves a tenant's
config unchanged: no engine of the port takes the band scheduler yet.
"""

import threading
import time

import pytest

from repro.core.join import FDJConfig as JCfg
from repro.data import synth as j_synth
from repro.serving.fleet import JoinFleet as JFleet
from repro_torch.core.join import FDJConfig, QueryOptions
from repro_torch.data import synth
from repro_torch.serving.fleet import BandScheduler, JoinFleet
from repro_torch.serving.join_service import PlanLibrary

_OPTS = {"numpy": dict(block=64), "cuda": dict(tl=32, tr=64)}


def _ds(mod, seed=3, n=12):
    return mod.police_records(n_incidents=n, reports_per_incident=2,
                              seed=seed)


def _cfg(engine="numpy", **kw):
    kw.setdefault("mc_trials", 4000)
    return FDJConfig(engine=engine, device="cpu", engine_opts=_OPTS[engine],
                     seed=0, **kw)


def _jcfg(**kw):
    kw.setdefault("mc_trials", 4000)
    return JCfg(engine="numpy", engine_opts=dict(block=64), seed=0, **kw)


def _row(r) -> dict:
    c = r.cost
    return {"pairs": sorted(r.pairs), "plan_hit": r.plan_hit,
            "breakdown": c.breakdown(), "bytes_h2d": c.bytes_h2d,
            "dedup_hits": c.plane_dedup_hits, "hits": c.plane_hits,
            "misses": c.plane_misses,
            "candidates": r.join.candidate_count}


# --- BandScheduler ----------------------------------------------------------

def test_band_scheduler_counts_steps_and_interleaves():
    sched = BandScheduler()
    order = []

    def work(tag):
        for _ in range(5):
            with sched.step():
                order.append(tag)
            time.sleep(0.001)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert sched.band_steps == 15
    assert sched.interleaves == sum(
        1 for x, y in zip(order, order[1:]) if x != y)
    assert sched.interleaves > 0


def test_band_scheduler_grants_fifo():
    sched = BandScheduler()
    order = []
    started = threading.Barrier(2)

    def late():
        started.wait()
        time.sleep(0.02)
        with sched.step():
            order.append("late")

    t = threading.Thread(target=late)
    t.start()
    started.wait()
    with sched.step():
        time.sleep(0.06)
        order.append("early")
    t.join(timeout=30)
    assert not t.is_alive()
    assert order == ["early", "late"]


# --- PlanLibrary ------------------------------------------------------------

class _FakePlan:
    def __init__(self):
        self.thetas = [0.4]


def test_plan_library_loans_are_isolated_copies():
    lib = PlanLibrary()
    plan = _FakePlan()
    lib.put(("fp", "fp", "k"), plan)
    plan.thetas[0] = 99.0
    loan1 = lib.get(("fp", "fp", "k"))
    loan1.thetas[0] = -1.0
    loan2 = lib.get(("fp", "fp", "k"))
    assert loan2.thetas == [0.4]
    assert lib.hits == 2 and lib.misses == 0


def test_plan_library_lru_cap_and_miss_counting():
    lib = PlanLibrary()
    for i in range(PlanLibrary._MAX + 1):
        lib.put(("fp", "fp", i), _FakePlan())
    assert lib.get(("fp", "fp", 0)) is None
    assert lib.get(("fp", "fp", PlanLibrary._MAX)) is not None
    assert lib.misses == 1 and lib.hits == 1


def test_plan_library_lease_serializes_racing_builders():
    lib = PlanLibrary()
    key = ("fp", "fp", "k")
    builds = []

    def cold_query():
        with lib.lease(key):
            if lib.get(key) is None:
                time.sleep(0.02)
                builds.append(1)
                lib.put(key, _FakePlan())

    threads = [threading.Thread(target=cold_query) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1


# --- fleet end-to-end -------------------------------------------------------

_REF: dict = {}


def _reference_two_tenants():
    if "two" not in _REF:
        with JFleet(max_concurrent=2) as fleet:
            fleet.add_tenant("a", _ds(j_synth), _jcfg())
            fleet.add_tenant("b", _ds(j_synth), _jcfg())
            _REF["two"] = ([_row(fleet.query("a")), _row(fleet.query("b"))],
                           fleet.store.snapshot())
    return _REF["two"]


@pytest.mark.parametrize("engine", ["numpy", "cuda"])
def test_fleet_second_tenant_cold_query_is_free(engine):
    want, want_store = _reference_two_tenants()
    with JoinFleet(device="cpu", max_concurrent=2) as fleet:
        fleet.add_tenant("a", _ds(synth), _cfg(engine))
        fleet.add_tenant("b", _ds(synth), _cfg(engine))
        first = fleet.query("a")
        second = fleet.query("b")
        assert [_row(first), _row(second)] == want
        assert fleet.store.snapshot() == want_store
        assert first.cost.inference > 0
        assert second.cost.inference == 0.0
        assert second.cost.labeling == 0.0
        assert second.cost.construction == 0.0
        assert second.cost.bytes_h2d == 0
        assert second.cost.plane_dedup_hits > 0
        assert second.pairs == first.pairs
        assert fleet.plan_library.misses == 1
        assert fleet.plan_library.hits >= 1


@pytest.mark.parametrize("engine", ["numpy", "cuda"])
def test_fleet_concurrent_mixed_cold_warm_matches_serial(engine):
    names = ("a", "b", "c")
    with JoinFleet(device="cpu", max_concurrent=1) as ref:
        for name in names:
            ref.add_tenant(name, _ds(synth), _cfg(engine))
        want = {name: [ref.query(name).pairs for _ in range(2)]
                for name in names}
    with JoinFleet(device="cpu", max_concurrent=3) as fleet:
        for name in names:
            fleet.add_tenant(name, _ds(synth), _cfg(engine))
        futures = [(name, fleet.submit(name))
                   for _ in range(2) for name in names]
        got = {}
        for name, fut in futures:
            got.setdefault(name, []).append(fut.result(timeout=120).pairs)
        summary = fleet.drain()
    assert got == want
    assert summary["submitted"] == summary["completed"] == 6
    assert summary["failed"] == 0
    assert fleet.plan_library.misses == 1
    assert fleet.store.snapshot()["puts"] == ref.store.snapshot()["puts"]
    # and the same pairs as the reference fleet's tenants
    want_ref, _ = _reference_two_tenants()
    assert [sorted(p) for p in got["a"]] == [want_ref[0]["pairs"]] * 2


def test_fleet_query_options_and_errors():
    with JoinFleet(device="cpu", max_concurrent=2) as fleet:
        fleet.add_tenant("a", _ds(synth), _cfg("cuda"))
        r = fleet.query("a", QueryOptions(recall_target=0.8))
        assert r.join.recall >= 0.8
        with pytest.raises(KeyError):
            fleet.submit("nobody")
        bad = fleet.submit("a", QueryOptions(overrides={"no_such_knob": 1}))
        with pytest.raises(TypeError):
            bad.result(timeout=30)
        assert fleet.drain()["failed"] == 1


def test_fleet_appends_through_the_admission_loop():
    """``submit_append`` is ordered with the tenant's queries: the query
    after it joins L × ΔR as the service's own delta path does."""
    from repro_torch.serving.join_service import hold_out_right
    base, rows = hold_out_right(
        synth.movies_pages(n_movies=25, cast_size=4, filler_sentences=1,
                           seed=3), 10)
    with JoinFleet(device="cpu", max_concurrent=2) as fleet:
        fleet.add_tenant("a", base, _cfg("cuda"))
        first = fleet.submit("a")
        appended = fleet.submit_append("a", rows)
        after = fleet.submit("a")
        assert first.result(timeout=120).delta_rows == 0
        assert appended.result(timeout=120)["rows"] == 10
        assert after.result(timeout=120).delta_rows == 10


@pytest.mark.parametrize("engine", ["numpy", "cuda"])
def test_gated_cfg_leaves_port_config_unchanged(engine):
    fleet = JoinFleet(device="cpu", max_concurrent=1)
    try:
        for opts in (_OPTS[engine], _OPTS, {}):
            cfg = FDJConfig(engine=engine, device="cpu", engine_opts=opts)
            assert fleet._gated_cfg(cfg) == cfg
        svc = fleet.add_tenant("a", _ds(synth), _cfg(engine))
        assert svc.cfg == _cfg(engine)
    finally:
        fleet.close()
