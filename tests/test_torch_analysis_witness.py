"""The port's runtime lock witness (repro_torch.analysis.witness): unit
semantics + the threaded fleet stress test cross-validating the static
lock graph of ``src/repro_torch``.

Ports the 7 tests of tests/test_analysis_witness.py, and adds the
regression test of the one port fault the fleet under the witness found
(two workers writing one curve cache file).  The blocking
guard wraps the port's pulls in place of ``jax.device_get``:
``torch.cuda.synchronize``, ``torch.cuda.Event.synchronize``,
``torch.cuda.Stream.synchronize`` and the ring's two pull points,
``engine.sharded._Transfers.wait`` and ``_Transfers.pairs``, which run on
the CPU too.  The 3-tenant fleet stress test runs on engine ``numpy`` (as
the reference runs it) and on engine ``sharded``, whose band steps go
through the fleet's scheduler and whose every pull passes the armed
guard.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.lockgraph import build_lock_graph
from repro_torch.analysis.witness import lock_witness
from repro_torch.engine import sharded

REPO = Path(__file__).resolve().parents[1]
TESTS = (str(REPO / "tests"),)


# ---------------------------------------------------------------------------
# unit semantics (locks created in THIS file via include_paths=tests/)
# ---------------------------------------------------------------------------

def test_locks_outside_include_paths_stay_raw():
    with lock_witness(
            include_paths=(str(REPO / "src" / "repro_torch"),)) as w:
        lk = threading.Lock()          # created in tests/, not src/repro_torch
        with lk:
            pass
    assert w.sites == set() and w.edges == {}
    assert type(lk) is not object and not hasattr(lk, "_site")


def test_consistent_order_records_edges_without_cycles():
    with lock_witness(include_paths=TESTS) as w:
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass
    assert len(w.sites) == 2
    assert len(w.edges) == 1           # a-site -> b-site only
    ((held, acq),) = list(w.edges)
    assert held.line < acq.line        # a constructed first
    assert w.order_cycles() == []


def test_inverted_order_across_threads_is_a_cycle():
    with lock_witness(include_paths=TESTS) as w:
        a = threading.Lock()
        b = threading.Lock()

        with a:
            with b:
                pass

        def inverted():
            with b:
                with a:                # inversion: b held while taking a
                    pass

        t = threading.Thread(target=inverted)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    cycles = w.order_cycles()
    assert len(cycles) == 1 and len(cycles[0]) == 2


def test_plain_lock_self_reacquire_raises_instead_of_hanging():
    with lock_witness(include_paths=TESTS):
        lk = threading.Lock()
        with lk:
            with pytest.raises(RuntimeError, match="self-deadlock"):
                lk.acquire()


def test_rlock_reentry_and_condition_compat():
    with lock_witness(include_paths=TESTS) as w:
        rl = threading.RLock()
        with rl:
            with rl:                   # reentry: legal, no self-edge
                pass
        cond = threading.Condition()   # backed by an instrumented RLock
        hits = []

        def waiter():
            with cond:
                while not hits:
                    cond.wait(timeout=5)
                hits.append("woke")

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            hits.append("signal")
            cond.notify()
        t.join(timeout=5)
        assert hits == ["signal", "woke"]
    assert all(h != a for (h, a) in w.edges), "reentry produced a self-edge"


def test_blocking_guard_fires_under_held_lock():
    """The ring's pulls pass through unheld and raise under a held lock;
    the CUDA syncs raise under it before touching a device; uninstall
    restores every original."""
    originals = (torch.cuda.synchronize,
                 torch.cuda.Event.__dict__["synchronize"],
                 torch.cuda.Stream.__dict__["synchronize"],
                 sharded._Transfers.__dict__["wait"],
                 sharded._Transfers.__dict__["pairs"])
    tr = sharded._Transfers(torch.device("cpu"))
    buf = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    step = tr.post(0, 4, buf, torch.tensor([3, 1], dtype=torch.int32))
    with lock_witness(include_paths=TESTS, guard_blocking=True) as w:
        lk = threading.Lock()
        assert sharded._Transfers.wait(step).tolist() == [3, 1]
        assert tr.pairs(step, 3).tolist() == [[0, 1], [2, 3], [4, 5]]
        with lk:
            with pytest.raises(AssertionError, match="_Transfers.wait"):
                sharded._Transfers.wait(step)
            with pytest.raises(AssertionError, match="_Transfers.pairs"):
                tr.pairs(step, 3)
            with pytest.raises(AssertionError,
                               match="torch.cuda.synchronize"):
                torch.cuda.synchronize()
            with pytest.raises(AssertionError,
                               match="torch.cuda.Event.synchronize"):
                torch.cuda.Event.synchronize(object())
            with pytest.raises(AssertionError,
                               match="torch.cuda.Stream.synchronize"):
                torch.cuda.Stream.synchronize(object())
        assert len(w.blocking_violations) == 5
    # guard uninstalled on exit
    assert (torch.cuda.synchronize,
            torch.cuda.Event.__dict__["synchronize"],
            torch.cuda.Stream.__dict__["synchronize"],
            sharded._Transfers.__dict__["wait"],
            sharded._Transfers.__dict__["pairs"]) == originals
    with threading.Lock():
        assert tr.pairs(step, 2).tolist() == [[0, 1], [2, 3]]


# ---------------------------------------------------------------------------
# fleet stress test under the witness
# ---------------------------------------------------------------------------

_OPTS = {"numpy": dict(block=64), "sharded": dict(tl=32, tr=32, r_chunk=64)}


def _police(seed):
    from repro_torch.data import synth
    return synth.police_records(n_incidents=12, reports_per_incident=2,
                                seed=seed)


def test_concurrent_cold_planning_writes_one_curve(tmp_path, monkeypatch):
    """Two fleet workers planning at once on a cold curve cache compute
    the same Monte-Carlo curve and both write it: each must write its own
    temporary file, or one renames the other's away and fails its query
    (found by the fleet under the witness on the card)."""
    from repro_torch.core import adj_target as at

    monkeypatch.setenv("REPRO_TORCH_ADJ_CACHE", str(tmp_path))
    both_open = threading.Barrier(2, timeout=30)
    real_save = at.np.save

    def save(f, arr):
        both_open.wait()               # both temporaries exist before either
        real_save(f, arr)              # is written and renamed

    monkeypatch.setattr(at.np, "save", save)
    out, errors = [], []

    def plan():
        try:
            out.append(at.failure_curve(5, 2, 40, 0.9, 200))
        except Exception as e:         # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=plan) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(out) == 2
    np.testing.assert_array_equal(out[0], out[1])
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".npy", files


@pytest.mark.parametrize("engine", ["numpy", "sharded"])
def test_fleet_stress_under_witness_validates_static_graph(engine,
                                                          monkeypatch,
                                                          tmp_path):
    """3 tenants (two sharing a corpus), 2 rounds of racing cold/warm
    queries: every lock the serving stack takes is instrumented.  The
    run must finish with no observed order cycle, no order that breaks
    the static graph's acyclicity when merged in, and no blocking pull
    under a held lock (the pull guard is armed throughout; on
    ``sharded`` every band step's counters and pairs pass it)."""
    from repro_torch.core.join import FDJConfig

    static = build_lock_graph()
    assert not static.findings
    # plan cold, as a fresh checkout does: the tenants' workers compute
    # their Monte-Carlo curves concurrently
    monkeypatch.setenv("REPRO_TORCH_ADJ_CACHE", str(tmp_path))

    pulls = []
    if engine == "sharded":
        wait = sharded._Transfers.__dict__["wait"].__func__
        monkeypatch.setattr(sharded._Transfers, "wait", staticmethod(
            lambda step: pulls.append(step.k) or wait(step)))

    with lock_witness(guard_blocking=True) as w:
        from repro_torch.serving.fleet import JoinFleet

        cfg = FDJConfig(engine=engine, device="cpu",
                        engine_opts=_OPTS[engine], seed=0, mc_trials=4000)
        with JoinFleet(max_concurrent=3, device="cpu") as fleet:
            fleet.add_tenant("a", _police(3), cfg)
            fleet.add_tenant("b", _police(3), cfg)   # dedups against a
            fleet.add_tenant("c", _police(7), cfg)
            futures = [(name, fleet.submit(name))
                       for _ in range(2) for name in ("a", "b", "c")]
            pairs = {}
            for name, fut in futures:
                pairs.setdefault(name, []).append(fut.result(timeout=300)
                                                  .pairs)
            summary = fleet.drain()

    assert summary["completed"] == 6 and summary["failed"] == 0
    assert pairs["a"][0] == pairs["a"][1] == pairs["b"][0]  # shared corpus
    assert pairs["c"][0] == pairs["c"][1]
    if engine == "sharded":
        # the ring ran, and its pulls went through the guard
        assert pulls, "no band step was pulled"

    # the witness actually saw the serving stack's locks...
    assert w.sites, "no instrumented lock was ever created"
    by_site = {(n.file, n.line) for n in static.nodes.values()}
    mapped = [s for s in w.sites if (s.file, s.line) in by_site]
    assert mapped, (
        f"no observed creation site mapped onto a static lock node; "
        f"sites={sorted(str(s) for s in w.sites)}")

    # ...and both the observed orders alone and their union with the
    # static graph are cycle-free
    assert w.order_cycles() == [], w.order_cycles()
    assert w.check_against(static) == []
    assert w.blocking_violations == []
