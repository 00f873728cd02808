"""JoinFleet — multi-tenant FDJ serving on one shared plane store, on
PyTorch.

One fleet fronts N ``JoinService`` tenants (DESIGN.md §8a):

  * **Shared store.**  Every tenant's planes live in one
    ``FeaturePlaneStore`` on the fleet's device.  Planes are content-hash keyed, so two tenants
    joining the same corpus dedup to ONE resident copy: the second
    tenant's cold query finds every plane resident and charges $0
    extraction / 0 plane H2D — its ledger proves it (``plane_dedup_hits``
    counts the hits served off another tenant's planes).  ``provide``
    holds the store lock across the whole build, so even two tenants
    racing the same cold corpus serialize into one extraction.  Plans
    dedup the same way through the shared ``PlanLibrary`` (steps ①–⑥ are
    deterministic in (corpus, cfg, seed)), so the second tenant's cold
    query re-pays *neither* planning nor plane extraction.
  * **Fair eviction.**  ``add_tenant`` registers a per-tenant byte budget
    with the store; charged bytes split evenly across an entry's owners,
    and budget pressure releases the *most-over-budget* tenant's LRU
    entries — never another tenant's working set (planes.py).
  * **Band-step interleaving.**  ``BandScheduler`` is the FIFO ticket
    gate the sharded (ring) engine passes each band-step enqueue through,
    so K concurrent queries take turns on the device instead of the first
    sweep monopolizing its queue: ``_gated_cfg`` keys the scheduler under
    each tenant's ``engine_opts["sharded"]``.  The numpy and cuda engines
    stream no bands and never see it.  Tenants' kernel launches go onto
    the current stream from their worker threads; the results are
    byte-identical to a serial run.
  * **Admission.**  ``submit`` enqueues a request on its tenant's FIFO
    queue and returns a future; ``max_concurrent`` workers admit requests
    round-robin across tenants (one in flight per tenant — a
    ``JoinService`` is not reentrant), so a bursty tenant cannot starve
    the others.

Requests carry the same typed ``QueryOptions`` surface as
``JoinService.query`` — the fleet adds no third request shape.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

from repro_torch.core.join import FDJConfig, QueryOptions
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import current_tracer, use_tracer
from repro_torch.serving.join_service import (DeltaRows, JoinService, PlanLibrary,
                                        ServeResult)
from repro_torch.serving.planes import FeaturePlaneStore


class BandScheduler:
    """FIFO ticket gate over band-step dispatch enqueues.

    Engines call ``step()`` around each band-step enqueue; tickets are
    granted strictly in arrival order, so two queries dispatching
    concurrently alternate steps on the device (continuous batching) and a
    query that arrives mid-sweep starts interleaving immediately instead
    of waiting out the whole incumbent sweep.  Grants are counted —
    ``interleaves`` is the number of grants handed to a different query
    (thread) than the previous grant, the observable the fleet benchmark
    gates on.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._next_ticket = 0
        self._serving = 0
        self._last_owner: Optional[int] = None
        self.band_steps = 0
        self.interleaves = 0

    @contextlib.contextmanager
    def step(self):
        with self._cond:
            ticket = self._next_ticket
            self._next_ticket += 1
            while ticket != self._serving:
                self._cond.wait()
            owner = threading.get_ident()
            self.band_steps += 1
            if self._last_owner is not None and owner != self._last_owner:
                self.interleaves += 1
            self._last_owner = owner
        try:
            yield
        finally:
            with self._cond:
                self._serving += 1
                self._cond.notify_all()


@dataclasses.dataclass
class _Request:
    tenant: str
    kind: str                      # "query" | "append"
    payload: object                # QueryOptions | DeltaRows
    tracer: object                 # ambient tracer captured at submit
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None
    t_submit: float = 0.0


class FleetFuture:
    """Handle for one submitted request (``result()`` blocks; re-raises
    the worker-side exception, so a failed query fails its caller)."""

    def __init__(self, req: _Request):
        self._req = req

    def result(self, timeout: Optional[float] = None):
        if not self._req.done.wait(timeout):
            raise TimeoutError(
                f"fleet request for tenant {self._req.tenant!r} still "
                f"pending after {timeout}s")
        if self._req.error is not None:
            raise self._req.error
        return self._req.result

    def done(self) -> bool:
        return self._req.done.is_set()


class JoinFleet:
    """N ``JoinService`` tenants behind one store and one scheduler.

    ``metrics`` (``fleet.*``) aggregates across tenants: submitted /
    admitted / completed / failed counters, ``fleet.queue_wait_s`` and
    ``fleet.query_wall_s`` histograms (p50/p99 come from the histogram
    quantiles), and the scheduler's ``fleet.band_steps`` /
    ``fleet.interleaves`` published on ``drain``.  Per-tenant ledgers
    stay on each tenant's ``JoinService`` — the fleet never merges them,
    so "who paid for what" remains answerable.
    """

    def __init__(self, *, byte_budget: Optional[int] = None, device="cuda",
                 mesh=None, store: Optional[FeaturePlaneStore] = None,
                 max_concurrent: int = 2):
        """mesh: the store's execution mesh (``FeaturePlaneStore(mesh=)``).
        A fleet serves a world of one rank only: concurrent queries would
        interleave band steps, and so collectives, in a different order on
        different ranks, so a mesh (or a world, when no mesh is given) of
        more than one rank raises ``ValueError``."""
        if max_concurrent < 1:
            raise ValueError(f"max_concurrent={max_concurrent} must be >= 1")
        from repro_torch.distributed.mesh import world_size
        meshes = [m for m in (mesh, getattr(store, "mesh", None)) if m]
        ranks = max([world_size()] + [m.size for m in meshes])
        if ranks > 1:
            raise ValueError(
                f"JoinFleet over a world of {ranks} ranks: the fleet "
                f"serves one rank (concurrent queries would take their "
                f"collectives in a different order on each rank)")
        self.store = store or FeaturePlaneStore(byte_budget, device=device,
                                                mesh=mesh)
        self.scheduler = BandScheduler()
        self.plan_library = PlanLibrary()
        self.metrics = MetricsRegistry()
        self.max_concurrent = int(max_concurrent)
        self._services: dict = {}          # tenant -> JoinService
        self._queues: dict = {}            # tenant -> list of _Request (FIFO)
        self._running: set = set()         # tenants with a request in flight
        self._rr: list = []                # admission round-robin order
        self._rr_next = 0
        self._cond = threading.Condition()
        self._mlock = threading.Lock()     # metrics writes (inc/observe race)
        self._closed = False
        self._workers = [
            threading.Thread(target=self._worker, name=f"fleet-worker-{i}",
                             daemon=True)
            for i in range(self.max_concurrent)]
        for w in self._workers:
            w.start()

    # -- tenants -------------------------------------------------------------

    def add_tenant(self, name: str, dataset, cfg: Optional[FDJConfig] = None,
                   *, byte_budget: Optional[int] = None,
                   **service_kwargs) -> JoinService:
        """Register a tenant: a ``JoinService`` over the shared store and
        its byte budget registered for fair eviction."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        with self._cond:
            if name in self._services:
                raise ValueError(f"tenant {name!r} already registered")
            self.store.register_tenant(name, byte_budget)
            svc = JoinService(dataset, self._gated_cfg(cfg or FDJConfig()),
                              store=self.store, tenant=name,
                              plan_library=self.plan_library,
                              **service_kwargs)
            self._services[name] = svc
            self._queues[name] = []
            self._rr.append(name)
            return svc

    def service(self, name: str) -> JoinService:
        return self._services[name]

    @property
    def tenants(self) -> list:
        return list(self._rr)

    def _gated_cfg(self, cfg: FDJConfig) -> FDJConfig:
        """Route the config's sharded-engine dispatches through this
        fleet's scheduler.  Flat engine_opts are first keyed under the
        config's own engine so the scheduler entry never leaks into
        another backend's constructor."""
        from repro_torch.engine import ENGINES
        opts = dict(cfg.engine_opts)
        if opts and not (set(opts) <= set(ENGINES)):
            opts = {cfg.engine: opts}
        sharded = dict(opts.get("sharded", {}))
        sharded["scheduler"] = self.scheduler
        opts["sharded"] = sharded
        return cfg.with_overrides(engine_opts=opts)

    # -- submission ----------------------------------------------------------

    def submit(self, tenant: str,
               options: Optional[QueryOptions] = None) -> FleetFuture:
        """Enqueue one query for ``tenant``; returns a future.  The same
        ``QueryOptions`` type ``JoinService.query`` takes — the fleet is
        a scheduler, not a third API."""
        return self._submit(tenant, "query", options or QueryOptions())

    def submit_append(self, tenant: str, rows: DeltaRows,
                      options: Optional[QueryOptions] = None) -> FleetFuture:
        """Enqueue an R-append for ``tenant`` (serialized with its queries
        by the per-tenant admission slot, so growth is ordered)."""
        return self._submit(tenant, "append", (rows, options))

    def _submit(self, tenant: str, kind: str, payload) -> FleetFuture:
        req = _Request(tenant, kind, payload, tracer=current_tracer() or None,
                       t_submit=time.perf_counter())
        with self._cond:
            if self._closed:
                raise RuntimeError("fleet is closed")
            if tenant not in self._services:
                raise KeyError(f"unknown tenant {tenant!r}")
            self._queues[tenant].append(req)
            self._cond.notify_all()
        with self._mlock:
            self.metrics.inc("fleet.submitted")
        return FleetFuture(req)

    def query(self, tenant: str,
              options: Optional[QueryOptions] = None) -> ServeResult:
        """Submit + wait — the synchronous convenience wrapper."""
        return self.submit(tenant, options).result()

    # -- admission loop ------------------------------------------------------

    def _next_request(self) -> Optional[_Request]:
        """Round-robin admission across tenants (caller holds the lock):
        scan from the cursor, skip tenants that are empty or already
        running, advance the cursor past the pick so service rotates."""
        n = len(self._rr)
        for i in range(n):
            idx = (self._rr_next + i) % n
            tenant = self._rr[idx]
            if tenant in self._running or not self._queues[tenant]:
                continue
            self._rr_next = (idx + 1) % n
            self._running.add(tenant)
            return self._queues[tenant].pop(0)
        return None

    def _worker(self) -> None:
        while True:
            with self._cond:
                req = self._next_request()
                while req is None:
                    if self._closed:
                        return
                    self._cond.wait()
                    req = self._next_request()
            self._run(req)

    def _run(self, req: _Request) -> None:
        svc = self._services[req.tenant]
        wait_s = time.perf_counter() - req.t_submit
        with self._mlock:
            self.metrics.inc("fleet.admitted")
            self.metrics.observe("fleet.queue_wait_s", wait_s)
        t0 = time.perf_counter()
        try:
            with use_tracer(req.tracer):
                with current_tracer().span(
                        f"fleet.{req.kind}", track=f"tenant:{req.tenant}",
                        tenant=req.tenant):
                    if req.kind == "query":
                        req.result = svc.query(req.payload)
                    else:
                        rows, options = req.payload
                        req.result = svc.append_right(rows, options)
            with self._mlock:
                self.metrics.inc("fleet.completed")
                self.metrics.observe("fleet.query_wall_s",
                                     time.perf_counter() - t0)
        except BaseException as e:      # delivered to the caller, not lost
            req.error = e
            with self._mlock:
                self.metrics.inc("fleet.failed")
        finally:
            with self._cond:
                self._running.discard(req.tenant)
                self._cond.notify_all()
            req.done.set()

    # -- lifecycle -----------------------------------------------------------

    def drain(self) -> dict:
        """Wait until every queue is empty and nothing is in flight, then
        publish scheduler totals into the metrics and return a summary."""
        with self._cond:
            while any(self._queues.values()) or self._running:
                self._cond.wait()
        with self._mlock:
            sched = self.scheduler
            for name, v in (("band_steps", sched.band_steps),
                            ("interleaves", sched.interleaves)):
                m = f"fleet.{name}"
                self.metrics.inc(m, v - self.metrics.value(m))
            return {
                "tenants": list(self._rr),
                "band_steps": sched.band_steps,
                "interleaves": sched.interleaves,
                "submitted": self.metrics.value("fleet.submitted"),
                "completed": self.metrics.value("fleet.completed"),
                "failed": self.metrics.value("fleet.failed"),
                "store": self.store.snapshot(),
            }

    def close(self) -> None:
        """Drain, then stop the workers (idempotent)."""
        self.drain()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout=10)

    def __enter__(self) -> "JoinFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
