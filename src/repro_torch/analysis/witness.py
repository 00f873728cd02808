"""Runtime lock witness: lockdep for the port's threaded tests (the port
of the JAX package's ``analysis/witness.py``).

The static graph (lockgraph.py) proves what *can* happen; this records
what *does*.  ``lock_witness()`` patches ``threading.Lock``/``RLock`` so
every lock constructed under the repo's source tree while the witness is
active becomes an instrumented wrapper that tracks, per thread, the
stack of held locks keyed by *creation site* (file:line of the
constructing frame).  From that it derives:

  * **observed order edges** — (held site -> acquired site), the runtime
    analogue of the static graph's edges;
  * **order violations** — a cycle among observed edges (A taken under B
    in one thread, B under A in another: a real deadlock candidate even
    if neither run deadlocked);
  * **self-deadlock** — same-thread re-acquisition of a non-reentrant
    ``Lock`` raises immediately instead of hanging the test;
  * **blocking-under-lock** — with ``guard_blocking=True`` the port's
    pulls assert no instrumented lock is held at pull time (the "no
    device pull inside a critical section" invariant): ``torch.cuda.
    synchronize``, ``torch.cuda.Event.synchronize`` and ``torch.cuda.
    Stream.synchronize``, and the ring's two pull points,
    ``engine.sharded._Transfers.wait`` (a step's counters) and
    ``_Transfers.pairs`` (its pairs).  The last two run on the CPU too,
    so a CPU test exercises the guard at the real pull points.

``check_against(static_graph)`` maps creation sites onto static
``LockNode``s by (file, line) — node construction lines are recorded for
exactly this — and validates that observed ∪ static stays acyclic, so a
runtime order the AST pass could not see (e.g. through a callback) still
fails the test.

Locks created *outside* the include paths (stdlib ``queue.Queue``
internals, test scaffolding) get raw locks: the witness never changes
stdlib behavior behind its back.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

from repro_torch.analysis.findings import repo_root
from repro_torch.analysis.lockgraph import LockGraph, _cycles

_LOCAL = threading.local()


def _held_stack() -> list:
    st = getattr(_LOCAL, "held", None)
    if st is None:
        st = _LOCAL.held = []
    return st


@dataclasses.dataclass(frozen=True)
class Site:
    """Creation site of an instrumented lock: the witness's node id."""
    file: str                      # repo-relative
    line: int
    kind: str                      # Lock | RLock

    def __str__(self) -> str:
        return f"{self.file}:{self.line}({self.kind})"


class WitnessedLock:
    """threading.Lock wrapper: order recording + self-deadlock trap."""

    def __init__(self, rec: "LockWitness", site: Site):
        self._rec = rec
        self._site = site
        self._inner = rec._raw_lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held_stack()
        if blocking:
            # a trylock cannot deadlock (Condition._is_owned probes plain
            # locks with acquire(False)) — only blocking acquisition gets
            # the trap and contributes order edges
            if any(w is self for w in held):
                raise RuntimeError(
                    f"self-deadlock: non-reentrant Lock {self._site} "
                    f"re-acquired by the thread already holding it")
            self._rec._record(self._site, held)
        got = self._inner.acquire(blocking, timeout)
        if got:
            held.append(self)
        return got

    def release(self):
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class WitnessedRLock:
    """threading.RLock wrapper.  Exposes the private hooks Condition
    needs (``_is_owned``/``_release_save``/``_acquire_restore``) so a
    ``threading.Condition`` built on an instrumented RLock works."""

    def __init__(self, rec: "LockWitness", site: Site):
        self._rec = rec
        self._site = site
        self._inner = rec._raw_rlock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held_stack()
        if blocking and not any(w is self for w in held):
            self._rec._record(self._site, held)  # reentry adds no edge
        got = self._inner.acquire(blocking, timeout)
        if got:
            held.append(self)
        return got

    def release(self):
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition plumbing ----------------------------------------------------
    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        held = _held_stack()
        n = sum(1 for w in held if w is self)
        _LOCAL.held = [w for w in held if w is not self]
        return (self._inner._release_save(), n)

    def _acquire_restore(self, state):
        inner_state, n = state
        self._inner._acquire_restore(inner_state)
        _held_stack().extend([self] * n)


class LockWitness:
    """Install with ``lock_witness()``; inspect after the workload."""

    def __init__(self, include_paths: tuple, guard_blocking: bool):
        self.include_paths = tuple(os.path.abspath(p)
                                   for p in include_paths)
        self.guard_blocking = guard_blocking
        self.root = repo_root()
        self._raw_lock = None      # originals, captured on install
        self._raw_rlock = None
        self.edges: dict = {}      # (held Site, acquired Site) -> count
        self.sites: set = set()
        self.blocking_violations: list = []
        self._elock = None         # raw lock guarding the edge dict
        self._saved: list = []     # (owner, attr, original) to restore

    # -- recording ----------------------------------------------------------

    def _site_of_caller(self, kind: str) -> Optional[Site]:
        import sys
        f = sys._getframe(2)       # caller of the patched factory
        while f is not None:
            fn = os.path.abspath(f.f_code.co_filename)
            if any(fn.startswith(p + os.sep) or fn == p
                   for p in self.include_paths):
                rel = os.path.relpath(fn, self.root)
                return Site(rel.replace(os.sep, "/"), f.f_lineno, kind)
            f = f.f_back
        return None

    def _record(self, site: Site, held: list) -> None:
        with self._elock:
            self.sites.add(site)
            for w in held:
                k = (w._site, site)
                self.edges[k] = self.edges.get(k, 0) + 1

    def assert_no_held(self, what: str) -> None:
        held = _held_stack()
        if held:
            names = ", ".join(str(w._site) for w in held)
            msg = (f"blocking call {what} while holding "
                   f"instrumented lock(s): {names}")
            with self._elock:
                self.blocking_violations.append(msg)
            raise AssertionError(msg)

    # -- install / uninstall ------------------------------------------------

    def _install(self) -> None:
        if self.guard_blocking:
            # before the factories are patched: importing torch under them
            # would hand its import machinery instrumented locks
            self._guard_pulls()
        self._raw_lock = threading.Lock
        self._raw_rlock = threading.RLock
        self._elock = self._raw_lock()
        wit = self

        def make_lock():
            site = wit._site_of_caller("Lock")
            return WitnessedLock(wit, site) if site else wit._raw_lock()

        def make_rlock():
            site = wit._site_of_caller("RLock")
            return WitnessedRLock(wit, site) if site else wit._raw_rlock()

        threading.Lock = make_lock
        threading.RLock = make_rlock

    def _guard(self, owner, attr: str, what: str, static=False) -> None:
        """Replace ``owner.attr`` by a wrapper that asserts no
        instrumented lock is held, then calls the original."""
        raw = owner.__dict__[attr]
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw
        wit = self

        def guarded(*a, **kw):
            wit.assert_no_held(what)
            return fn(*a, **kw)

        self._saved.append((owner, attr, raw))
        setattr(owner, attr, staticmethod(guarded) if static else guarded)

    def _guard_pulls(self) -> None:
        import torch
        from repro_torch.engine import sharded
        self._guard(torch.cuda, "synchronize", "torch.cuda.synchronize")
        self._guard(torch.cuda.Event, "synchronize",
                    "torch.cuda.Event.synchronize")
        self._guard(torch.cuda.Stream, "synchronize",
                    "torch.cuda.Stream.synchronize")
        self._guard(sharded._Transfers, "wait", "_Transfers.wait",
                    static=True)
        self._guard(sharded._Transfers, "pairs", "_Transfers.pairs")

    def _uninstall(self) -> None:
        threading.Lock = self._raw_lock
        threading.RLock = self._raw_rlock
        for owner, attr, raw in reversed(self._saved):
            setattr(owner, attr, raw)
        self._saved = []

    # -- verdicts -----------------------------------------------------------

    def order_cycles(self) -> list:
        e = {(str(h), str(a)): 1 for (h, a) in self.edges}
        return _cycles(e, {})

    def check_against(self, graph: LockGraph) -> list:
        """Merge observed edges into the static graph (mapping creation
        sites to static nodes by construction file:line) and return any
        cycles in the union.  Empty list = runtime agrees with the
        static model."""
        by_site = {(n.file, n.line): n.name for n in graph.nodes.values()}
        merged = {(h, a): 1 for (h, a) in graph.edges if h != a}
        for (h, a) in self.edges:
            hn = by_site.get((h.file, h.line), str(h))
            an = by_site.get((a.file, a.line), str(a))
            if hn != an:
                merged[(hn, an)] = 1
        return _cycles(merged, {})


class _WitnessCM:
    def __init__(self, include_paths, guard_blocking):
        self.w = LockWitness(include_paths, guard_blocking)

    def __enter__(self) -> LockWitness:
        self.w._install()
        return self.w

    def __exit__(self, *exc):
        self.w._uninstall()
        return False


def lock_witness(include_paths: Optional[tuple] = None,
                 guard_blocking: bool = False) -> _WitnessCM:
    """Context manager installing the witness.  Locks created while
    active by code under ``include_paths`` (default: ``src/repro_torch``)
    are instrumented; everything else gets raw locks."""
    if include_paths is None:
        include_paths = (os.path.join(repo_root(), "src", "repro_torch"),)
    return _WitnessCM(include_paths, guard_blocking)
