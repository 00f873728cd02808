"""The port's JoinFleet over a world of ranks against the reference's
JoinFleet over a mesh of devices, on the CPU.

The reference runs its fleet in a subprocess on four XLA host devices
(``--xla_force_host_platform_device_count=4``, as
tests/test_torch_multipod.py runs its sharded engine), on its default
host mesh and on ``make_join_mesh(2, 2, 1)``.  The port runs the same
submissions on every rank of gloo worlds of 2 and 4 spawned processes
(``launch.ep_world.run_world``): on the host mesh of the world, and on an
explicit ``make_join_mesh(2, 2, 1)`` at 4.  Rank 0, the mesh's
coordinator, must return the reference's pairs, theta, candidate count
and ledger dollars, exactly.

Ports of tests/test_fleet.py's four end-to-end tests to those worlds
(three tenants on police_records, the file's fixtures: ``_ds`` at seed 3,
``mc_trials`` 4000, seed 0; the concurrent case at 40 incidents, so each
query takes three band steps), plus an append between queries (on
movies_pages, whose embed-only planes keep the next query on the delta
path, as tests/test_torch_fleet.py's append test does): the
second tenant's cold query is free; concurrent mixed cold / warm queries
equal a serial run byte for byte, with one plan built and the store's
puts equal (which tenant plans and extracts first is a race, so the
concurrent run's dollars are held to the reference's as per-component
sums over every query, ``math.fsum``: exact, whatever the order); query
options and errors (a bad override fails on every rank and the fleet
carries on); the scheduler scoped to the sharded engine (on a world, the
fleet's mesh rides with it).  On every world every rank's admission and
grant sequences, band steps, interleaves and collective calls by group,
in order, are identical (``JoinFleet.world_report``).

A stress world sleeps each rank's workers for seeded random times that
differ between ranks, before admission and before every ordered call:
the results stay the same.  A fault world (group timeout 15 s) raises
inside a query on rank 1 only: every pending future raises on every rank
within the timeout, and ``close`` returns.

The jobs are this module's functions (the spawned ranks import it); the
module imports nothing of JAX.
"""

import json
import math
import os
import random
import subprocess
import sys
import time

import pytest

from repro_torch.launch.dryrun_client import REPO_ROOT
from repro_torch.launch.ep_world import run_world

_OPTS = dict(tl=8, tr=32, r_chunk=32)
_NAMES = ("a", "b", "c")
# the port's worlds: (ranks, mesh)
WORLDS = [(2, "host"), (4, "host"), (4, "221")]


# ---------------------------------------------------------------------------
# the scenarios, written once for both packages
# ---------------------------------------------------------------------------

def _ds(m, seed=3, n=12):
    return m.synth.police_records(n_incidents=n, reports_per_incident=2,
                                  seed=seed)


def _cfg(m, **kw):
    kw.setdefault("mc_trials", 4000)
    return m.FDJConfig(engine="sharded", engine_opts=dict(m.opts), seed=0,
                       **m.cfg_kw, **kw)


def _row(r) -> dict:
    c = r.cost
    return {"pairs": sorted(map(list, r.pairs)), "plan_hit": r.plan_hit,
            "theta": [float(t) for t in r.join.theta],
            "breakdown": c.breakdown(), "bytes_h2d": c.bytes_h2d,
            "dedup_hits": c.plane_dedup_hits,
            "candidates": r.join.candidate_count,
            "delta_rows": r.delta_rows}


def _fleet(m, workers):
    return m.JoinFleet(max_concurrent=workers, mesh=m.mesh(), **m.fleet_kw)


def _close(m, fleet, out: dict) -> None:
    fleet.close()
    rep = getattr(fleet, "world_report", None)
    if rep is not None:
        out.setdefault("reports", []).append(rep)


def scenarios(m) -> dict:
    """Every scenario on the modules ``m`` (the reference's or the
    port's); every rank of a port world runs it alike."""
    out: dict = {}
    # 1. the second tenant's cold query is free
    f = _fleet(m, 2)
    f.add_tenant("a", _ds(m), _cfg(m))
    f.add_tenant("b", _ds(m), _cfg(m))
    first, second = f.query("a"), f.query("b")
    out["cold_free"] = {"rows": [_row(first), _row(second)],
                        "misses": f.plan_library.misses,
                        "hits": f.plan_library.hits,
                        "store": f.store.snapshot()}
    _close(m, f, out)
    # 2. concurrent mixed cold / warm against serial
    runs = {}
    for workers in (1, 3):
        f = _fleet(m, workers)
        for name in _NAMES:
            f.add_tenant(name, _ds(m, n=40), _cfg(m))
        if workers == 1:
            res = [(name, f.query(name)) for name in _NAMES
                   for _ in range(2)]
        else:
            futs = [(name, f.submit(name)) for _ in range(2)
                    for name in _NAMES]
            res = [(name, fut.result(timeout=300)) for name, fut in futs]
        summary = f.drain()
        rows = {}
        for name, r in res:
            rows.setdefault(name, []).append(_row(r))
        parts = [row["breakdown"] for rs in rows.values() for row in rs]
        # each tenant's cold plans (queries not served from the plan
        # library): read only where a comparison fails
        out.setdefault("concurrent_misses", {})[workers] = {
            n: sum(not r["plan_hit"] for r in rs) for n, rs in rows.items()}
        runs[workers] = {
            "pairs": {n: [r["pairs"] for r in rs] for n, rs in rows.items()},
            "theta": {n: [r["theta"] for r in rs] for n, rs in rows.items()},
            "candidates": {n: [r["candidates"] for r in rs]
                           for n, rs in rows.items()},
            "dollars": {k: math.fsum(p[k] for p in parts)
                        for k in parts[0]},
            "misses": f.plan_library.misses,
            "puts": f.store.snapshot()["puts"],
            "completed": summary["completed"], "failed": summary["failed"],
            "band_steps": summary["band_steps"]}
        _close(m, f, out)
    out["concurrent"] = runs
    # 3. query options and errors; the fleet carries on after the error
    f = _fleet(m, 2)
    f.add_tenant("a", _ds(m), _cfg(m))
    got = {"options": _row(f.query("a", m.QueryOptions(recall_target=0.8)))}
    try:
        f.submit("nobody")
    except KeyError:
        got["unknown_tenant"] = "KeyError"
    bad = f.submit("a", m.QueryOptions(overrides={"no_such_knob": 1}))
    try:
        bad.result(timeout=60)
    except TypeError:
        got["bad_override"] = "TypeError"
    got["after"] = _row(f.query("a", m.QueryOptions(recall_target=0.8)))
    got["failed"] = f.drain()["failed"]
    out["errors"] = got
    _close(m, f, out)
    # 4. an append between two queries (movies: embed-only planes keep
    # the query after it on the delta path, L x dR through the ring)
    base, rows = m.hold_out_right(m.synth.movies_pages(
        n_movies=25, cast_size=4, filler_sentences=1, seed=3), 10)
    f = _fleet(m, 2)
    f.add_tenant("a", base, _cfg(m))
    before = f.submit("a")
    appended = f.submit_append("a", rows)
    after = f.submit("a")
    out["append"] = {"before": _row(before.result(timeout=120)),
                     "rows": appended.result(timeout=120)["rows"],
                     "after": _row(after.result(timeout=120))}
    _close(m, f, out)
    return out


class _Port:
    """The port's modules for ``scenarios``."""

    def __init__(self, mesh_kind: str, device: str = "cpu"):
        from repro_torch.core.join import FDJConfig, QueryOptions
        from repro_torch.data import synth
        from repro_torch.distributed.mesh import make_join_mesh
        from repro_torch.serving.fleet import JoinFleet
        from repro_torch.serving.join_service import hold_out_right
        self.FDJConfig, self.QueryOptions = FDJConfig, QueryOptions
        self.synth, self.JoinFleet = synth, JoinFleet
        self.hold_out_right = hold_out_right
        self.opts = _OPTS
        self.cfg_kw = {"device": device}
        self.fleet_kw = {"device": device}
        self.mesh = (lambda: make_join_mesh(2, 2, 1)) if mesh_kind == "221" \
            else (lambda: None)


_REFERENCE = r"""
import json, sys
sys.path.insert(0, TESTS)
import test_torch_fleet_world as t
from repro.core.join import FDJConfig, QueryOptions
from repro.data import synth
from repro.distributed.mesh import make_join_mesh
from repro.serving.fleet import JoinFleet
from repro.serving.join_service import hold_out_right


class Ref:
    def __init__(self, mesh_kind):
        self.FDJConfig, self.QueryOptions = FDJConfig, QueryOptions
        self.synth, self.JoinFleet = synth, JoinFleet
        self.hold_out_right = hold_out_right
        self.opts = dict(t._OPTS, use_kernel=False)
        self.cfg_kw, self.fleet_kw = {}, {}
        self.mesh = (lambda: make_join_mesh(2, 2, 1)) if mesh_kind == "221" \
            else (lambda: None)


out = {kind: t.scenarios(Ref(kind)) for kind in ("host", "221")}
print("REFERENCE " + json.dumps(out))
"""


def _start_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    code = f"TESTS = {os.path.join(REPO_ROOT, 'tests')!r}\n" + _REFERENCE
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO_ROOT)


# ---------------------------------------------------------------------------
# the port's world jobs (module-level: the spawned ranks import them)
# ---------------------------------------------------------------------------

def _stress(seed: int, rank: int):
    """Sleep each worker for seeded random times, different on each rank,
    before admission and before every ordered call."""
    from repro_torch.serving import fleet as fleet_mod
    rng = random.Random(seed * 1000 + rank)

    def nap():
        time.sleep(rng.uniform(0.0, 0.004))

    def wrap(fn):
        def call(*a, **kw):
            nap()
            return fn(*a, **kw)
        return call

    for cls, name in ((fleet_mod.JoinFleet, "_next_request"),
                      (fleet_mod.JoinFleet, "_followed_request"),
                      (fleet_mod._WorldOrder, "turn")):
        setattr(cls, name, wrap(getattr(cls, name)))


def world_job(mesh, device, payload: dict) -> dict:
    """One rank of a port world: every scenario, on the world's host mesh
    or a (2, 2, 1) join mesh, optionally under ``_stress``."""
    import torch.distributed as dist
    if payload.get("stress") is not None:
        _stress(payload["stress"], dist.get_rank())
    m = _Port(payload["mesh"], str(device))
    out = scenarios(m)
    # the scheduler scoped to the sharded engine, on this world
    f = _fleet(m, 1)
    cfg = f._gated_cfg(m.FDJConfig(engine="numpy",
                                   engine_opts=dict(block=64)))
    out["scoped"] = {
        "numpy": cfg.engine_opts["numpy"] == dict(block=64),
        "scheduler": cfg.engine_opts["sharded"]["scheduler"] is f.scheduler,
        "mesh": cfg.engine_opts["sharded"]["mesh"] is f.mesh,
        "mesh_size": f.mesh.size,
        "host_mesh": payload["mesh"] != "host" or f.mesh.axis_names == (
            "data", "model")}
    _close(m, f, out)
    return out


def fault_job(mesh, device, payload: dict) -> dict:
    """One rank of the fault world: rank 1's first band step raises inside
    a query; every future is collected with the time it took to fail."""
    import torch.distributed as dist
    from repro_torch.engine.sharded import ShardedEngine
    rank = dist.get_rank()
    if rank == 1:
        def broken(self, *a, **kw):
            raise RuntimeError("injected fault on rank 1")
        ShardedEngine._band_mask = broken
    m = _Port("host", str(device))
    f = _fleet(m, 3)
    for name in _NAMES:
        f.add_tenant(name, _ds(m, n=40), _cfg(m))
    t0 = time.perf_counter()
    futs = [f.submit(name) for _ in range(2) for name in _NAMES]
    outcomes = []
    for fut in futs:
        try:
            fut.result(timeout=payload["wait_s"])
            outcomes.append("ok")
        except TimeoutError:
            outcomes.append("hung")
        except Exception as e:       # the outcome under test
            outcomes.append(type(e).__name__)
    failed_s = time.perf_counter() - t0
    f.close()
    return {"outcomes": outcomes, "failed_s": failed_s,
            "closed_s": time.perf_counter() - t0,
            "report": f.world_report}


# ---------------------------------------------------------------------------
# fixtures: the reference in a subprocess while the port's worlds run
# ---------------------------------------------------------------------------

_CACHE: dict = {}


@pytest.fixture(scope="module")
def runs():
    ref = _start_reference()
    try:
        port = {}
        for n, kind in WORLDS:
            port[(n, kind)] = run_world((n, 1), world_job, {"mesh": kind},
                                        timeout=300)
        port["stress"] = run_world((2, 1), world_job,
                                   {"mesh": "host", "stress": 7},
                                   timeout=300)
        out, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("REFERENCE ")][-1]
    return {"ref": json.loads(line[len("REFERENCE "):]), "port": port}


def _case(runs, world):
    n, kind = world
    return runs["ref"][kind], runs["port"][world]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_world_second_tenant_cold_query_is_free(runs, world):
    ref, ranks = _case(runs, world)
    got = ranks[0]["cold_free"]
    want = ref["cold_free"]
    assert got["rows"] == want["rows"]
    assert got["misses"] == want["misses"] == 1 and got["hits"] >= 1
    first, second = got["rows"]
    assert first["breakdown"]["inference"] > 0
    assert second["breakdown"]["inference"] == 0.0
    assert second["breakdown"]["labeling"] == 0.0
    assert second["breakdown"]["construction"] == 0.0
    assert second["bytes_h2d"] == 0 and second["dedup_hits"] > 0
    assert second["pairs"] == first["pairs"]
    for r in ranks[1:]:
        # a follower plans as rank 0 does, and its shard's pairs went to
        # rank 0
        rows = r["cold_free"]["rows"]
        assert [x["theta"] for x in rows] == [x["theta"] for x in
                                              want["rows"]]
        assert all(x["pairs"] == [] for x in rows)
        assert r["cold_free"]["misses"] == 1


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_world_concurrent_mixed_cold_warm_matches_serial(runs, world):
    """Rank 0's concurrent run (3 workers) against its serial run and the
    reference's serial run.  A failure reports each tenant's cold plans
    (serial, concurrent) and the concurrent fleet's admission and grant
    order (``JoinFleet.world_report``)."""
    ref, ranks = _case(runs, world)
    serial, conc = ranks[0]["concurrent"][1], ranks[0]["concurrent"][3]
    want = ref["concurrent"]["1"]
    order = ranks[0]["reports"][2]["order"]
    seen = {"tenant_misses": ranks[0]["concurrent_misses"],
            "admission_order": order["admission_order"],
            "grant_order": order["grant_order"]}
    for key in ("pairs", "theta", "candidates", "dollars", "misses",
                "puts"):
        assert serial[key] == want[key], key
        assert conc[key] == serial[key], (key, seen)
    assert conc["misses"] == 1, seen
    assert conc["completed"] == 6 and conc["failed"] == 0
    assert conc["band_steps"] == serial["band_steps"] == 18
    for r in ranks[1:]:
        assert r["concurrent"][3]["misses"] == 1
        assert r["concurrent"][3]["theta"] == want["theta"]


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_world_query_options_and_errors(runs, world):
    ref, ranks = _case(runs, world)
    want = ref["errors"]
    for rank, r in enumerate(ranks):
        got = r["errors"]
        assert got["unknown_tenant"] == "KeyError"
        assert got["bad_override"] == "TypeError"
        assert got["failed"] == want["failed"] == 1
        if rank == 0:
            assert got["options"] == want["options"]
            assert got["after"] == want["after"]
            assert got["options"]["pairs"] == got["after"]["pairs"]


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_world_scopes_scheduler_to_sharded_engine(runs, world):
    _ref, ranks = _case(runs, world)
    for r in ranks:
        s = r["scoped"]
        assert s["numpy"] and s["scheduler"] and s["mesh"] and s["host_mesh"]
        assert s["mesh_size"] == world[0]


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_world_append_between_queries(runs, world):
    ref, ranks = _case(runs, world)
    got, want = ranks[0]["append"], ref["append"]
    assert got == want
    assert got["rows"] == 10 and got["after"]["delta_rows"] == 10
    assert got["before"]["delta_rows"] == 0


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_world_ranks_agree(runs, world):
    """Every fleet of the world: every rank's admission and grant
    sequences, band steps, interleaves and collective calls by group, in
    order, equal; gathers over the pull group in every fleet that ran
    the ring."""
    _ref, ranks = _case(runs, world)
    reports = [r["reports"] for r in ranks]
    assert all(len(rs) == len(reports[0]) == 6 for rs in reports)
    for fleet_reports in zip(*reports):
        for rep in fleet_reports:
            assert rep["ranks_agree"], rep
        digests = [rep["ranks"] for rep in fleet_reports]
        assert all(d == digests[0] for d in digests)
    busy = reports[0][2]["ranks"][0]       # the concurrent fleet
    assert busy["n_grants"] > 0 and busy["collectives"]["pull"]["calls"] > 0
    assert busy["band_steps"] == 18


def test_world_stress_random_delays_same_results(runs):
    """Workers sleeping for random times that differ between ranks,
    before admission and before every ordered call: rank 0's results are
    those of the undisturbed world, and the ranks still agree."""
    calm, stressed = runs["port"][(2, "host")], runs["port"]["stress"]
    for key in ("cold_free", "concurrent", "errors", "append"):
        assert stressed[0][key] == calm[0][key], key
    for rank_reports in (r["reports"] for r in stressed):
        assert all(rep["ranks_agree"] for rep in rank_reports)


def test_world_fault_fails_every_rank_within_timeout():
    """A query raises on rank 1 only: rank 1 sees rank 0 grant a call of
    a query it has ended and breaks; rank 0's gather waits for rank 1
    until the group timeout (15 s) and breaks.  Every future raises on
    both ranks, none hangs, and ``close`` returns."""
    ranks = run_world((2, 1), fault_job, {"wait_s": 90}, timeout=200,
                      group_timeout=15)
    for rank, r in enumerate(ranks):
        assert "ok" not in r["outcomes"] and "hung" not in r["outcomes"], r
        assert r["failed_s"] < 15 + 45 and r["closed_s"] < 15 + 60, r
        assert not r["report"]["ranks_agree"]
    assert "RuntimeError" in ranks[1]["outcomes"]
    assert "FleetWorldError" in ranks[0]["outcomes"]
