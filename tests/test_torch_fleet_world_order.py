"""The world fleet's concurrent dollars in a forced order, on the CPU.

tests/test_torch_fleet_world.py's concurrent scenario (three tenants on
one police_records corpus of 40 incidents, 3 workers, submissions a, b,
c, a, b, c) on a 4-rank gloo world over the world's host mesh, with the
order forced instead of left to the threads:

  * admission: rank 0's worker slots admit (slot, submission) in
    ``ORDER``, the order a free run once logged when its dollars broke;
  * the race after the cold plan: slot 1 (which runs submission 0, of
    tenant a) takes the plan lease first, so tenant a plans; the thread
    that put the plan into the ``PlanLibrary`` enters the store's
    ``provide`` only after another tenant's ``provide`` has returned, or
    after ``WAIT_S``.  The tenant that planned has already charged its
    planning's first-touch extractions to its own extractor, so if a
    tenant that loaned the plan builds the planes first, with its fresh
    extractor, those records are paid twice.

A fleet that holds its promise ("two tenants racing the same cold corpus
serialize into one extraction") pays, component by component, what a
serial run pays.  The port's rank 0 is held to its serial run and to the
reference's serial run, exactly.  The reference's ``JoinFleet`` runs the
same forcing in a subprocess on four XLA host devices: it pays the
planning's extractions twice (``ROADMAP.md`` queue 3 records it as a
reference fault), which also shows that the forcing reaches the race.

The jobs are this module's functions (the spawned ranks import it); the
module imports nothing of JAX.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import threading

import pytest

import test_torch_fleet_world as fw
from repro_torch.launch.dryrun_client import REPO_ROOT
from repro_torch.launch.ep_world import run_world

# (worker slot, submission number), rank 0's admissions in a failed free run
ORDER = [(1, 0), (0, 1), (2, 2), (2, 5), (0, 4), (1, 3)]
WAIT_S = 3.0
_KEYS = ("pairs", "theta", "candidates", "dollars", "misses", "puts")


def force_order(fleet, names) -> list:
    """Make ``fleet``'s workers admit in ``ORDER`` (where a fleet decides
    its own admissions: the reference's, or rank 0 of a port world).
    Submission ``q`` is tenant ``names[q % 3]``'s next request.  Returns
    the log of forced admissions."""
    log: list = []
    cls_next = type(fleet)._next_request

    def forced(self):
        k = len(log)
        if k >= len(ORDER):
            return cls_next(self)
        slot, q = ORDER[k]
        tenant = names[q % len(names)]
        if (threading.current_thread().name != f"fleet-worker-{slot}"
                or tenant in self._running or not self._queues[tenant]):
            return None
        self._rr_next = self._rr.index(tenant)
        req = cls_next(self)
        log.append([slot, q])
        self._cond.notify_all()      # the next slot in ORDER may now admit
        return req

    fleet._next_request = forced.__get__(fleet)
    return log


@contextlib.contextmanager
def forced_race(library_cls, store_cls):
    """While open: the worker that runs the first submission (slot
    ``ORDER[0][0]``, on every rank) takes the plan lease first, so its
    tenant plans; the thread that puts a plan into the library enters its
    next ``provide`` only once another thread's ``provide`` has returned,
    or after ``WAIT_S``.  Yields the log of (who, tenant) by ``provide``,
    in order."""
    first = f"fleet-worker-{ORDER[0][0]}"
    leased, provided = threading.Event(), threading.Event()
    builders: set = set()
    log: list = []
    lease0, put0 = library_cls.lease, library_cls.put
    provide0 = store_cls.provide

    @contextlib.contextmanager
    def lease(self, key):
        me = threading.current_thread().name
        if me != first:
            leased.wait(WAIT_S)
        with lease0(self, key):
            if me == first:
                leased.set()
            yield

    def put(self, key, plan):
        builders.add(threading.current_thread())
        return put0(self, key, plan)

    def provide(self, *a, **kw):
        me = threading.current_thread()
        if me in builders:
            builders.discard(me)
            provided.wait(WAIT_S)
            log.append(("planner", kw.get("tenant")))
            return provide0(self, *a, **kw)
        out = provide0(self, *a, **kw)
        log.append(("other", kw.get("tenant")))
        provided.set()
        return out

    library_cls.lease, library_cls.put = lease, put
    store_cls.provide = provide
    try:
        yield log
    finally:
        library_cls.lease, library_cls.put = lease0, put0
        store_cls.provide = provide0


def runs(m, library_cls, store_cls) -> dict:
    """The serial run (1 worker) and the forced concurrent run (3 workers)
    of the concurrent scenario, on the modules ``m``."""
    out = {}
    for workers in (1, 3):
        f = fw._fleet(m, workers)
        for name in fw._NAMES:
            f.add_tenant(name, fw._ds(m, n=40), fw._cfg(m))
        if workers == 1:
            res = [(name, f.query(name)) for name in fw._NAMES
                   for _ in range(2)]
            admitted, provides = None, None
        else:
            admitted = force_order(f, fw._NAMES)
            with forced_race(library_cls, store_cls) as provides:
                futs = [(name, f.submit(name)) for _ in range(2)
                        for name in fw._NAMES]
                res = [(name, fut.result(timeout=300)) for name, fut in futs]
        summary = f.drain()
        rows: dict = {}
        for name, r in res:
            rows.setdefault(name, []).append(fw._row(r))
        parts = [row["breakdown"] for rs in rows.values() for row in rs]
        out[str(workers)] = {
            "pairs": {n: [r["pairs"] for r in rs] for n, rs in rows.items()},
            "theta": {n: [r["theta"] for r in rs] for n, rs in rows.items()},
            "candidates": {n: [r["candidates"] for r in rs]
                           for n, rs in rows.items()},
            "dollars": {k: math.fsum(p[k] for p in parts)
                        for k in parts[0]},
            "misses": f.plan_library.misses,
            "puts": f.store.snapshot()["puts"],
            "tenant_misses": {n: sum(not r["plan_hit"] for r in rs)
                              for n, rs in rows.items()},
            "completed": summary["completed"], "failed": summary["failed"],
            "admitted": admitted, "provides": provides}
        f.close()
        rep = getattr(f, "world_report", None)
        if rep is not None:
            out[str(workers)]["world_order"] = rep["order"]["admission_order"]
            out[str(workers)]["ranks_agree"] = rep["ranks_agree"]
    return out


def order_job(mesh, device, payload: dict) -> dict:
    """One rank of the port's 4-rank world: ``runs`` on the world's host
    mesh."""
    from repro_torch.serving.join_service import PlanLibrary
    from repro_torch.serving.planes import FeaturePlaneStore
    return runs(fw._Port("host", str(device)), PlanLibrary,
                FeaturePlaneStore)


_REFERENCE = r"""
import json, sys
sys.path.insert(0, TESTS)
import test_torch_fleet_world_order as t
from repro.core.join import FDJConfig, QueryOptions
from repro.data import synth
from repro.serving.fleet import JoinFleet
from repro.serving.join_service import PlanLibrary, hold_out_right
from repro.serving.planes import FeaturePlaneStore


class Ref:
    FDJConfig, QueryOptions, synth, JoinFleet = (FDJConfig, QueryOptions,
                                                 synth, JoinFleet)
    hold_out_right = staticmethod(hold_out_right)
    opts = dict(t.fw._OPTS, use_kernel=False)
    cfg_kw, fleet_kw = {}, {}
    mesh = staticmethod(lambda: None)


print("REFERENCE " + json.dumps(t.runs(Ref(), PlanLibrary,
                                       FeaturePlaneStore)))
"""


@pytest.fixture(scope="module")
def forced():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    code = f"TESTS = {os.path.join(REPO_ROOT, 'tests')!r}\n" + _REFERENCE
    ref = subprocess.Popen([sys.executable, "-c", code], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, cwd=REPO_ROOT)
    try:
        port = run_world((4, 1), order_job, {}, timeout=300)
        out, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("REFERENCE ")][-1]
    return {"ref": json.loads(line[len("REFERENCE "):]), "port": port}


def test_forced_order_is_the_logged_one(forced):
    """Rank 0 admitted in ``ORDER`` (its own log and the world's), one
    tenant planned, and every rank agrees on the order."""
    for workers_out in (forced["port"][0]["3"], forced["ref"]["3"]):
        assert workers_out["admitted"] == [list(x) for x in ORDER]
    for workers_out in [r["3"] for r in forced["port"]] + [forced["ref"]["3"]]:
        assert workers_out["tenant_misses"] == {"a": 1, "b": 0, "c": 0}
        assert workers_out["completed"] == 6 and workers_out["failed"] == 0
    world = forced["port"][0]["3"]
    assert [list(x) for x in world["world_order"]] == [list(x)
                                                        for x in ORDER]
    assert all(r["3"]["ranks_agree"] for r in forced["port"])


@pytest.mark.parametrize("key", _KEYS)
def test_forced_concurrent_dollars_match_serial(forced, key):
    """Rank 0's forced concurrent run against its serial run and the
    reference's serial run: every ledger component summed over the six
    queries (``math.fsum``), pairs, theta, candidates, plan misses and
    store puts, exactly."""
    port, ref = forced["port"][0], forced["ref"]
    seen = {"provides": port["3"]["provides"],
            "port": port["3"]["dollars"], "serial": port["1"]["dollars"]}
    assert port["1"][key] == ref["1"][key], key
    assert port["3"][key] == port["1"][key], (key, seen)


def test_forced_planner_provides_first(forced):
    """In the port the tenant that planned builds the planes: the tenants
    that loaned its plan provide only after it, whatever the threads
    would do."""
    for r in forced["port"]:
        provides = r["3"]["provides"]
        assert tuple(provides[0]) == ("planner", "a"), provides
        assert sorted(t for _, t in provides[1:]) == ["a", "b", "b", "c",
                                                      "c"], provides


def test_reference_pays_planning_extractions_twice(forced):
    """The reference fault the forced order exposes: a tenant that loaned
    the plan provides before the tenant that planned, with a fresh
    extractor, and pays the planning's first-touch extractions again --
    inference only; the pairs, theta and every other component equal the
    serial run's."""
    serial, conc = forced["ref"]["1"], forced["ref"]["3"]
    assert conc["provides"][0][0] == "other", conc["provides"]
    assert conc["dollars"]["inference"] > serial["dollars"]["inference"]
    for k, v in serial["dollars"].items():
        if k not in ("inference", "total"):
            assert conc["dollars"][k] == v, k
    for key in ("pairs", "theta", "candidates", "misses", "puts"):
        assert conc[key] == serial[key], key
