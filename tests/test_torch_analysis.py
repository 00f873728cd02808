"""The port's static analysis (repro_torch.analysis): clean-tree verdicts
on ``src/repro_torch`` + seeded violations.

Ports the 28 tests of tests/test_analysis.py that do not read XLA HLO
(its HLO-contract and manifest tests have no counterpart: the port
compiles no HLO, and its collective byte ledger is checked by the
multipod dry-run).  Each analyzer is tested from both sides: the port's
tree must come back clean, and a synthetic module seeded with each
violation class must be caught.  Beyond the reference's cases, every
blocking kind of the port's surface is seeded under a held lock: its
host syncs (``torch.cuda.synchronize``, an event's or a stream's
``synchronize``, ``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()``)
and the blocking ``torch.distributed`` calls.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from repro_torch.analysis.checkers import (check_legacy_kwargs,
                                           check_metric_names,
                                           check_tracer_guards,
                                           check_wallclock, run_checkers)
from repro_torch.analysis.lockgraph import (BLOCKING_WAIVERS, _DIST_BLOCKING,
                                            build_lock_graph, render_text,
                                            to_dot)

REPO = Path(__file__).resolve().parents[1]

# the port's 16 lock sites
_NODES = (
    "obs.trace.Tracer._lock",
    "obs.metrics.MetricsRegistry._lock",
    "serving.planes.FeaturePlaneStore._lock",
    "serving.fleet.JoinFleet._cond",
    "serving.fleet.JoinFleet._mlock",
    "serving.fleet.BandScheduler._cond",
    "serving.fleet._WorldOrder._cond",
    "serving.join_service.PlanLibrary._lock",
    "serving.join_service.PlanLibrary.lease.lk",
    "engine.sharded._HOST_MESH_LOCK",
    "distributed.collectives.CollectiveLedger._lock",
    "distributed.collectives.AxisLedger._lock",
    "kernels._build._LOCK",
    "kernels.extract.kernel._LOCK",
    "kernels.fused_cnf_join.kernel._COUNT_LOCK",
    "kernels.threshold_sweep.kernel._COUNT_LOCK",
)


# ---------------------------------------------------------------------------
# lock graph: clean tree
# ---------------------------------------------------------------------------

class TestLockGraphTree:
    def setup_method(self):
        self.g = build_lock_graph()

    def test_tree_has_no_findings(self):
        assert not self.g.findings, "\n".join(str(f) for f in self.g.findings)

    def test_known_nodes_discovered(self):
        names = set(self.g.nodes)
        for expected in _NODES:
            assert expected in names, f"lock node {expected} not discovered"
        assert len(names) == len(_NODES), sorted(names - set(_NODES))

    def test_known_order_edges_present(self):
        edges = self.g.edge_set()
        # the reference's cross-lock orders, which the port keeps, and the
        # host mesh's: the witness cross-validates them in the fleet
        # stress test
        for e in (
            ("serving.fleet.JoinFleet._cond",
             "serving.planes.FeaturePlaneStore._lock"),
            ("serving.fleet.JoinFleet._mlock",
             "obs.metrics.MetricsRegistry._lock"),
            ("serving.fleet.JoinFleet._mlock",
             "serving.planes.FeaturePlaneStore._lock"),
            ("serving.planes.FeaturePlaneStore._lock",
             "obs.metrics.MetricsRegistry._lock"),
            ("serving.join_service.PlanLibrary.lease.lk",
             "serving.join_service.PlanLibrary._lock"),
            ("engine.sharded._HOST_MESH_LOCK",
             "distributed.collectives.CollectiveLedger._lock"),
            # planning under the lease may build the sweep kernel
            # (kernels.threshold_sweep.kernel -> _build.load)
            ("serving.join_service.PlanLibrary.lease.lk",
             "kernels._build._LOCK"),
        ):
            assert e in edges, f"expected order edge missing: {e}"

    def test_store_rlock_self_loop_allowed(self):
        # FeaturePlaneStore._lock is an RLock re-entered by design
        # (_provide -> _evict_to_budget): a self-loop edge, not a finding
        n = "serving.planes.FeaturePlaneStore._lock"
        assert self.g.nodes[n].kind == "RLock"
        assert (n, n) in self.g.edge_set()

    def test_lease_blocking_hold_is_waived_and_visible(self):
        # label_pairs IS held under the planning lease by design — the
        # waiver must be reported, never silently dropped; so are the
        # threshold sweep's host pulls reached through plan_join
        for kind in ("oracle.label_pairs", "tensor.numpy", "tensor.cpu",
                     "tensor.tolist"):
            assert any(kind in w and "lease" in w for w in self.g.waived), \
                (kind, self.g.waived)
        assert BLOCKING_WAIVERS[0][0] == \
            "serving.join_service.PlanLibrary.lease.*"

    def test_renderers(self):
        txt = render_text(self.g)
        assert "order edges" in txt and "no lock-order" in txt
        dot = to_dot(self.g)
        assert dot.startswith("digraph lock_order")
        assert "JoinFleet._mlock" in dot

    def test_host_mesh_new_group_hold_is_waived_with_its_reason(self):
        """The host mesh's creation issues dist.new_group under
        _HOST_MESH_LOCK: waived (every rank must create each group the
        same number of times), and printed with that reason."""
        hits = [w for w in self.g.waived
                if "dist.new_group under engine.sharded._HOST_MESH_LOCK" in w]
        assert hits and "waived: the host mesh is created once" in hits[0]
        assert "dist.new_group" in render_text(self.g)

    def test_host_mesh_waiver_says_no_fleet_worker_reaches_it(self):
        """The one waived new_group hold stays one, and its reason now says
        why a fleet on a world > 1 never reaches it: the fleet resolves its
        mesh in __init__ and hands it to every tenant's engine."""
        mesh_waivers = [w for w in BLOCKING_WAIVERS if "new_group" in w[1]]
        assert len(mesh_waivers) == 1 and len(BLOCKING_WAIVERS) == 2
        assert "No fleet worker reaches it" in mesh_waivers[0][2]
        assert "JoinFleet.__init__" in mesh_waivers[0][2]

    def test_world_order_blocks_under_no_lock(self):
        """The fleet's control thread receives (and rank 0's sends) rank
        0's order with a blocking ``dist.broadcast`` and the ranks compare
        digests with ``dist.all_gather_object``: under no lock, so nothing
        is found or waived there; the same receive moved under the order's
        Condition is found."""
        node = self.g.nodes["serving.fleet._WorldOrder._cond"]
        assert node.kind == "Condition"
        assert not any("_WorldOrder" in w or "broadcast" in w
                       for w in self.g.waived)
        src = (REPO / "src" / "repro_torch" / "serving" / "fleet.py"
               ).read_text()
        recv = "                dist.broadcast(buf, src=0, group=self._group)"
        assert src.count(recv) == 2
        seeded = src.replace(
            "            try:\n" + recv,
            "            try:\n                with self._cond:\n    " + recv,
            1)
        assert seeded != src
        g = build_lock_graph([("src/repro_torch/serving/fleet.py", seeded)])
        bad = [f for f in g.findings if f.rule == "lock-blocking"]
        assert len(bad) == 1 and "dist.broadcast" in str(bad[0]), \
            [str(f) for f in g.findings]

    def test_np_save_does_not_resolve_to_checkpoint_save(self):
        """``np.save`` in core/adj_target.py must not resolve by unique
        name to checkpoint.checkpoint.save (a call on ``np``, ``numpy`` or
        ``torch`` resolves to nothing)."""
        assert not any("checkpoint" in site
                       for sites in self.g.edges.values() for site in sites)
        assert not any("checkpoint" in w for w in self.g.waived)
        g = build_lock_graph([_mod("sv", """
import threading
import numpy as np
import torch

class Saver:
    def save(self, path):
        with self._lock:
            pass

    def __init__(self):
        self._lock = threading.Lock()

class User:
    def __init__(self):
        self._lock = threading.Lock()

    def dump(self, path, x):
        with self._lock:
            np.save(path, x)
            torch.save(x, path)
""")])
        assert ("sv.User._lock", "sv.Saver._lock") not in g.edge_set()


# ---------------------------------------------------------------------------
# lock graph: seeded violations
# ---------------------------------------------------------------------------

def _mod(name, body):
    return (f"src/repro_torch/{name}.py", body)


class TestLockGraphSeeded:
    def test_cycle_detected(self):
        g = build_lock_graph([_mod("aa", """
import threading

class A:
    def __init__(self):
        self._la = threading.Lock()
        self._lb = threading.Lock()

    def fwd(self):
        with self._la:
            with self._lb:
                pass

    def bwd(self):
        with self._lb:
            with self._la:
                pass
""")])
        assert any(f.rule == "lock-cycle" for f in g.findings), \
            [str(f) for f in g.findings]

    def test_cross_class_cycle_through_calls(self):
        g = build_lock_graph([_mod("bb", """
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()
        self.m = M()

    def work(self):
        with self._lock:
            self.m.bump()

class M:
    def __init__(self):
        self._lock = threading.Lock()
        self.s: S = None

    def bump(self):
        with self._lock:
            pass

    def report(self):
        with self._lock:
            self.s.work()
""")])
        assert any(f.rule == "lock-cycle" for f in g.findings)

    def test_plain_lock_self_reacquire(self):
        g = build_lock_graph([_mod("cc", """
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        with self._lock:
            pass
""")])
        assert any(f.rule == "lock-self-deadlock" for f in g.findings)

    def test_rlock_self_reacquire_allowed(self):
        g = build_lock_graph([_mod("dd", """
import threading

class D:
    def __init__(self):
        self._lock = threading.RLock()

    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        with self._lock:
            pass
""")])
        assert not g.findings, [str(f) for f in g.findings]

    def test_blocking_under_lock(self):
        g = build_lock_graph([_mod("ee", """
import threading
import torch

class E:
    def __init__(self):
        self._lock = threading.Lock()

    def pull(self, x):
        with self._lock:
            return x.cpu()
""")])
        assert any(f.rule == "lock-blocking"
                   and "tensor.cpu" in f.msg for f in g.findings)

    def test_transitive_blocking_under_lock(self):
        g = build_lock_graph([_mod("ff", """
import threading
from concurrent.futures import Future

class F:
    def __init__(self):
        self._lock = threading.Lock()
        self.fut: Future = None

    def outer(self):
        with self._lock:
            self.helper()

    def helper(self):
        return self.fut.result()
""")])
        assert any(f.rule == "lock-blocking"
                   and "Future.result" in f.msg for f in g.findings)

    def test_acquire_release_pairs_tracked(self):
        # explicit .acquire()/.release() between the pair is "held"
        g = build_lock_graph([_mod("gg", """
import threading
import time

class G:
    def __init__(self):
        self._lock = threading.Lock()

    def bad(self):
        self._lock.acquire()
        time.sleep(0.1)
        self._lock.release()

    def fine(self):
        self._lock.acquire()
        self._lock.release()
        time.sleep(0.1)
""")])
        bad = [f for f in g.findings if f.rule == "lock-blocking"]
        assert len(bad) == 1 and "time.sleep" in bad[0].msg

    def test_contextmanager_yield_holds_propagate(self):
        # a cm holding a lock at yield makes callers' with-bodies held
        g = build_lock_graph([_mod("hh", """
import contextlib
import threading
import time

class H:
    def __init__(self):
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def guard(self):
        with self._lock:
            yield

    def caller(self):
        with self.guard():
            time.sleep(0.1)
""")])
        assert any(f.rule == "lock-blocking" for f in g.findings)

    def test_untyped_dict_get_does_not_fabricate_edges(self):
        # name-based resolution must not bind dict .get to a repo method
        g = build_lock_graph([_mod("ii", """
import threading

class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._d = {}

    def get(self, k):
        with self._lock:
            return self._d.get(k)

class User:
    def __init__(self):
        self._lock = threading.Lock()
        self.cache = {}

    def lookup(self, k):
        with self._lock:
            return self.cache.get(k)
""")])
        # User._lock -> Store._lock would be fabricated by naive matching
        assert ("ii.User._lock", "ii.Store._lock") not in g.edge_set()
        assert not g.findings


# every blocking kind of the surface: (statement under the lock, kind)
_BLOCKING_CASES = [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("self.done.synchronize()", "Event.synchronize"),
    ("event.synchronize()", "Event.synchronize"),
    ("self.copy_stream.synchronize()", "Stream.synchronize"),
    ("torch.cuda.current_stream().synchronize()", "Stream.synchronize"),
    ("x.cpu()", "tensor.cpu"),
    ("x.numpy()", "tensor.numpy"),
    ("x.item()", "tensor.item"),
    ("x.tolist()", "tensor.tolist"),
    ("oracle.label_pairs([(0, 0)], kind='refinement')",
     "oracle.label_pairs"),
    ("self.fut.result()", "Future.result"),
    ("self.q.put(x)", "queue.put"),
    ("self.q.get()", "queue.get"),
    ("time.sleep(0.1)", "time.sleep"),
    ("self.worker.join()", "Thread.join"),
    ("self.other.wait()", "Condition.wait"),
] + [(f"dist.{n}(x)", f"dist.{n}") for n in sorted(_DIST_BLOCKING)] + [
    ("torch.distributed.all_reduce(x)", "dist.all_reduce"),
]


class TestBlockingSurface:
    @pytest.mark.parametrize("stmt,kind", _BLOCKING_CASES,
                             ids=[c[1] + ":" + c[0].split("(")[0]
                                  for c in _BLOCKING_CASES])
    def test_seeded_blocking_call_under_lock_is_flagged(self, stmt, kind):
        g = build_lock_graph([_mod("bk", f"""
import queue
import threading
import time
from concurrent.futures import Future

import torch
import torch.distributed as dist

class B:
    def __init__(self):
        self._lock = threading.Lock()
        self.other = threading.Condition()
        self.q: queue.Queue = queue.Queue()
        self.fut: Future = None

    def hold(self, x, event, oracle):
        with self._lock:
            {stmt}

    def free(self, x, event, oracle):
        {stmt}
""")])
        bad = [f for f in g.findings if f.rule == "lock-blocking"]
        assert len(bad) == 1, [str(f) for f in g.findings]
        assert kind in bad[0].msg and "bk.B._lock" in bad[0].msg

    def test_condition_wait_exempts_its_own_lock(self):
        g = build_lock_graph([_mod("cw", """
import threading

class W:
    def __init__(self):
        self._cond = threading.Condition()

    def park(self):
        with self._cond:
            self._cond.wait()
""")])
        assert not g.findings, [str(f) for f in g.findings]

    def test_torch_gather_is_not_a_collective(self):
        """``torch.gather`` / ``x.scatter`` are local ops: only calls on
        ``dist`` / ``torch.distributed`` count as collectives."""
        g = build_lock_graph([_mod("tg", """
import threading
import torch

class T:
    def __init__(self):
        self._lock = threading.Lock()

    def pick(self, x, i):
        with self._lock:
            y = torch.gather(x, 0, i)
            return y.scatter(0, i, x)
""")])
        assert not g.findings, [str(f) for f in g.findings]

    def test_transitive_collective_under_lock(self):
        """A collective reached through a helper (as new_group is reached
        through make_host_mesh) is flagged at the call under the lock."""
        g = build_lock_graph([_mod("tc", """
import threading

_LOCK = threading.Lock()

def _dist():
    import torch.distributed as dist
    return dist

def make_groups(ranks):
    dist = _dist()
    return dist.new_group(ranks)

def resolve():
    with _LOCK:
        return make_groups([0, 1])
""")])
        bad = [f for f in g.findings if f.rule == "lock-blocking"]
        assert len(bad) == 1 and "dist.new_group" in bad[0].msg
        assert "tc.make_groups" in bad[0].msg


# ---------------------------------------------------------------------------
# checkers: clean tree + seeded violations
# ---------------------------------------------------------------------------

class TestCheckers:
    def test_tree_clean(self):
        fs = run_checkers()
        assert not fs, "\n".join(str(f) for f in fs)

    def test_unguarded_tracer_call(self):
        fs = check_tracer_guards([_mod("t1", """
from repro_torch.obs.trace import current_tracer

def hot(t0, t1):
    tracer = current_tracer()
    tracer.record_span("x", t0, t1)
""")])
        assert len(fs) == 1 and fs[0].rule == "tracer-guard"

    def test_guarded_tracer_call_ok(self):
        fs = check_tracer_guards([_mod("t2", """
from repro_torch.obs.trace import current_tracer, Tracer

def hot(t0, t1):
    tracer = current_tracer()
    if tracer:
        tracer.record_span("x", t0, t1)
    tracer and tracer.event("y")
    with tracer.span("z"):
        pass

def helper(tracer: Tracer, t0, t1):
    # non-Optional annotation states the caller guards
    tracer.record_span("w", t0, t1)
""")])
        assert not fs, [str(f) for f in fs]

    def test_legacy_from_legacy_flagged(self):
        fs = check_legacy_kwargs([_mod("l1", """
from repro_torch.core.join import QueryOptions

def go(svc):
    return svc.query(QueryOptions.from_legacy(engine="numpy"))
""")])
        assert any(f.rule == "legacy-kwargs" and "from_legacy" in f.msg
                   for f in fs)

    def test_legacy_query_kwargs_flagged(self):
        fs = check_legacy_kwargs([_mod("l2", """
def go(svc):
    return svc.query(engine="numpy", recall_target=0.9)
""")])
        assert len(fs) == 1 and "engine" in fs[0].msg

    def test_typed_options_query_ok(self):
        fs = check_legacy_kwargs([_mod("l3", """
from repro_torch.core.join import QueryOptions

def go(svc):
    return svc.query(QueryOptions(engine="numpy", recall_target=0.9))
""")])
        assert not fs

    def test_unmapped_metric_name_flagged(self):
        fs = check_metric_names([_mod("m1", """
def go(metrics):
    metrics.inc("serve.plan_hits")
    metrics.inc("serve.plan_hitz")
""")])
        assert len(fs) == 1 and "serve.plan_hitz" in fs[0].msg

    def test_wallclock_flagged_on_span_path(self):
        fs = check_wallclock([("src/repro_torch/obs/t3.py", """
import time

def span_open():
    return time.time()
""")])
        assert len(fs) == 1 and fs[0].rule == "wallclock"

    def test_wallclock_waiver_comment(self):
        fs = check_wallclock([("src/repro_torch/obs/t4.py", """
import time

def meta():
    return time.time()  # wallclock-ok: export metadata, not span math
""")])
        assert not fs

    def test_wallclock_ignored_off_span_path(self):
        fs = check_wallclock([("src/repro_torch/launch/t5.py", """
import time

def wall():
    return time.time()
""")])
        assert not fs

    def test_exemptions_name_the_ports_files(self):
        """The shim's own modules are exempt under the port's paths, and
        only there: the same source under the JAX package's path, or under
        any other port module, is flagged."""
        src = """
from repro_torch.core.join import QueryOptions

def shim(**kw):
    return QueryOptions.from_legacy(**kw)
"""
        assert not check_legacy_kwargs(
            [("src/repro_torch/serving/join_service.py", src)])
        assert check_legacy_kwargs([("src/repro/serving/join_service.py",
                                     src)])
        assert check_legacy_kwargs([("src/repro_torch/serving/fleet.py",
                                     src)])


# ---------------------------------------------------------------------------
# PlanLibrary lease lifecycle
# ---------------------------------------------------------------------------

class TestPlanLibraryLeases:
    def test_lease_entry_dropped_when_uncontended(self):
        from repro_torch.serving.join_service import PlanLibrary
        lib = PlanLibrary()
        for i in range(100):
            with lib.lease(("fp", "fp", i)):
                pass
        assert lib._leases == {}, (
            f"{len(lib._leases)} lease locks leaked after release")

    def test_contended_lease_serializes_then_drops(self):
        from repro_torch.serving.join_service import PlanLibrary
        lib = PlanLibrary()
        key = ("fp", "fp", 0)
        order = []
        gate = threading.Event()

        def loser():
            gate.wait()
            with lib.lease(key):
                order.append("loser")

        t = threading.Thread(target=loser)
        t.start()
        with lib.lease(key):
            gate.set()          # loser now contends while we hold it
            while lib._leases[key][1] != 2:
                pass            # spin until the waiter has registered
            order.append("winner")
        t.join(timeout=30)
        assert not t.is_alive()
        assert order == ["winner", "loser"]
        assert lib._leases == {}, "contended lease entry leaked"


# ---------------------------------------------------------------------------
# CLI and imports
# ---------------------------------------------------------------------------

def test_cli_check_passes_on_tree(tmp_path):
    dot = tmp_path / "lockgraph.dot"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check",
         "--dot", str(dot)],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analysis: clean" in r.stdout
    # every waiver is printed with its reason
    assert "waived: per-key planning lease" in r.stdout
    assert "waived: the host mesh is created once" in r.stdout
    assert dot.read_text().startswith("digraph lock_order")


_IMPORTS = """
import json, sys
import repro_torch.analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.checkers import run_checkers
from repro_torch.analysis.lockgraph import build_lock_graph
from repro_torch.analysis.witness import lock_witness
n = len(build_lock_graph().nodes) + len(run_checkers())
with lock_witness(guard_blocking=True):
    pass
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad, "n": n}))
"""


def test_analysis_imports_neither_jax_nor_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORTS], cwd=str(REPO), timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "n": len(_NODES)}
