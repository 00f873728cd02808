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
  * **A world of several ranks.**  The fleet's mesh is resolved once, in
    ``__init__``: the store's, else the sharded engine's host mesh of the
    world (``engine.sharded._default_mesh``, which may create process
    groups — itself a collective, so no worker may be the first to ask).
    On a world of more than one rank every tenant's sharded engine gets
    that mesh, and every rank runs the same submissions (SPMD: the
    launcher and the tests call ``add_tenant`` / ``submit`` /
    ``submit_append`` alike on every rank), so a request's submission
    number names it on every rank.  One JAX controller issues one program
    to all devices; here each rank runs up to ``max_concurrent`` worker
    threads of its own, and left alone each rank would admit requests in
    the order its workers free up and its threads would reach the join
    path's collectives in their own order: two queries would meet in
    different collectives on different ranks, and one query's
    ``recv_pairs`` could take the other's pairs (gloo pairs a ``send``
    with a ``recv`` on a group in posting order).  So rank 0 decides both
    orders and the other ranks follow (``_WorldOrder``): rank 0's
    round-robin picks each worker slot's next request and publishes
    (slot, submission number); every collective call of a fleet query
    (``collectives.all_gather``, ``send_pairs``, ``recv_pairs``) and every
    band-step enqueue takes the next grant rank 0 hands out, and on every
    rank the grants run one at a time, in grant order.  A query's calls
    are found through ``collectives.ordered_calls``, a context the fleet
    sets around ``svc.query`` / ``svc.append_right``; on a world of one
    the fleet sets none, and the collectives run as they come.  A world
    that cannot keep the order — a rank dead or stalled past the world's
    group timeout, a rank whose query made other calls than rank 0's —
    fails every pending request with ``FleetWorldError``, and ``close``
    returns.

Requests carry the same typed ``QueryOptions`` surface as
``JoinService.query`` — the fleet adds no third request shape.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Optional

from repro_torch.core.join import FDJConfig, QueryOptions
from repro_torch.distributed import collectives
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import current_tracer, use_tracer
from repro_torch.serving.join_service import (DeltaRows, JoinService, PlanLibrary,
                                        ServeResult)
from repro_torch.serving.planes import FeaturePlaneStore


class FleetWorldError(RuntimeError):
    """The world under a fleet can no longer keep rank 0's order: a
    collective failed or timed out, a rank's query made other calls than
    rank 0 granted, or rank 0 aborted.  Every pending request fails with
    it."""


class BandScheduler:
    """FIFO ticket gate over band-step dispatch enqueues.

    Engines call ``step()`` around each band-step enqueue; tickets are
    granted strictly in arrival order, so two queries dispatching
    concurrently alternate steps on the device (continuous batching) and a
    query that arrives mid-sweep starts interleaving immediately instead
    of waiting out the whole incumbent sweep.  Grants are counted —
    ``interleaves`` is the number of grants handed to a different query
    (thread) than the previous grant, the observable the fleet benchmark
    gates on.  A fleet query on a world of several ranks takes its step as
    a turn of rank 0's order instead (``collectives.turn("band")``), so
    every rank counts the same steps and interleaves.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._next_ticket = 0
        self._serving = 0
        self._last_owner: Optional[threading.Thread] = None
        self.band_steps = 0
        self.interleaves = 0

    def _grant(self) -> None:
        """Count one grant (caller holds ``_cond``).  The owner is the
        thread object, kept alive by ``_last_owner``: an ident is reused
        by a thread started after the previous owner ended."""
        owner = threading.current_thread()
        self.band_steps += 1
        if self._last_owner is not None and owner is not self._last_owner:
            self.interleaves += 1
        self._last_owner = owner

    @contextlib.contextmanager
    def step(self):
        if collectives.ordered():
            with collectives.turn("band"):
                with self._cond:
                    self._grant()
                yield
            return
        with self._cond:
            ticket = self._next_ticket
            self._next_ticket += 1
            while ticket != self._serving:
                self._cond.wait()
            self._grant()
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
    seq: int = 0                   # submission number, the same on every rank


class FleetFuture:
    """Handle for one submitted request (``result()`` blocks; re-raises
    the worker-side exception, so a failed query fails its caller).

    On a world of several ranks every rank holds a future for the same
    request.  Rank 0's (the mesh's coordinator, to which the ring sends
    every pair) resolves to the ``ServeResult`` a one-rank fleet returns:
    pairs, theta, candidates, dollars, plan and dedup counters.  Another
    rank's resolves when its part of the query is done, to what its
    ``JoinService`` returns there: the same plan (theta, planning dollars
    and plane counters), and no candidates or pairs, since its shard's
    pairs went to rank 0.  A query that raises on every rank fails every
    rank's future and the fleet carries on; a world that breaks
    (``FleetWorldError``) fails every pending future on every rank within
    the world's group timeout."""

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


# control records: (type, a, b, c, d) int64
_ADMIT, _GRANT, _END, _STOP, _ABORT = 1, 2, 3, 4, 5
_KINDS = ("",) + collectives.GROUP_KINDS        # "" for a band step
_REQ_KINDS = ("query", "append")
# admissions and grants a world fleet keeps in order for its report
ORDER_LOG = 256


class _WorldOrder:
    """Rank 0's order of a fleet on a world of several ranks, and each
    rank's part in keeping it.

    Rank 0 decides and the other ranks follow:

      * admission: rank 0's worker slot ``w`` picks request ``seq`` by its
        round-robin and publishes (w, seq); a follower's slot ``w`` takes
        exactly request ``seq``, once it has been submitted there and its
        tenant's previous request is done there;
      * grants: a rank-0 thread that reaches an ordered call of query
        ``seq`` (a gather over a group, a pair transfer, a band-step
        enqueue) takes the next grant ``g`` and publishes (g, seq, call);
        on every rank grant ``g`` runs only after grant ``g - 1`` has
        returned there.  A pair transfer is rank 0's ``recv`` from the
        sender and the sender's ``send``; the other ranks pass it by;
      * ends: when query ``seq`` ends on rank 0, rank 0 publishes how many
        grants it took, so a follower whose query wants another call (or
        ended short of rank 0's) knows the world broke.

    The records travel over a gloo group of their own, which every rank
    creates in ``JoinFleet.__init__``, in batches of up to ``BATCH``: one
    control thread a rank broadcasts them from rank 0 and receives them on
    the others, with no lock held (rank 0 sends an empty batch after
    ``heartbeat_s`` idle, so a follower's receive does not time out while
    rank 0 has nothing to say).  Workers wait on ``_cond``, which the
    control thread notifies.  What ``gather_report`` compares across ranks
    is kept as running CRC-32s and counts, so it takes constant memory:
    the admissions, every grant in the order it ran or was passed here,
    and each collective group's calls."""

    BATCH = 64

    def __init__(self, fleet: "JoinFleet", group, rank: int,
                 timeout_s: float):
        self._fleet = fleet
        self._group = group
        self.rank = rank
        self.leader = rank == 0
        self.heartbeat_s = max(0.5, min(5.0, timeout_s / 4))
        self._cond = threading.Condition()
        self._outbox: collections.deque = collections.deque()
        self._next_grant = 0          # rank 0: the next grant to hand out
        self._turn = 0                # the grant that runs next here
        self._waiting: dict = {}      # followers: grant -> call it runs here
        self._mine: dict = {}         # followers: seq -> its grants here
        self._passed: dict = {}       # followers: grant -> (seq, call) of a
        #                               pair transfer between other ranks
        self._grants_of: dict = {}    # rank 0: seq -> grants published
        self._ended: dict = {}        # followers: seq -> rank 0's grants
        self._finished: set = set()   # followers: queries done here
        self.broken: Optional[FleetWorldError] = None
        self.stopped = False          # the control thread saw STOP
        # (count, crc32) of the admissions (slot, seq) in rank 0's order,
        # of the grants (grant, seq, op, kind, peer) in the order they ran
        # or were passed here, and of each group's calls (seq, op, peer)
        self.admissions = [0, 0]
        self.grants = [0, 0]
        # the first ORDER_LOG of those admissions and grants, in order
        # (``world_summary``: what a failed comparison of two runs reads)
        self.order_log: dict = {"admissions": [], "grants": []}
        self.groups: dict = {}
        self.records = 0
        self.batches = 0
        self._thread = threading.Thread(
            target=self._send if self.leader else self._receive,
            name="fleet-control", daemon=True)
        self._thread.start()

    # -- the calls ---------------------------------------------------------

    @staticmethod
    def _code(call) -> int:
        op, kind, _peer = call
        return collectives.ORDERED_OPS.index(op) * 8 + _KINDS.index(kind)

    @staticmethod
    def _call(code: int, peer: int) -> tuple:
        return (collectives.ORDERED_OPS[code // 8], _KINDS[code % 8],
                int(peer))

    def _check(self) -> None:
        if self.broken is not None:
            raise self.broken

    def _take(self, seq: int, call: tuple) -> int:
        """The grant this call runs under (caller holds ``_cond``)."""
        self._check()
        if self.leader:
            g = self._next_grant
            self._next_grant += 1
            self._grants_of[seq] = self._grants_of.get(seq, 0) + 1
            self._outbox.append((_GRANT, g, seq, self._code(call), call[2]))
            self._cond.notify_all()
            return g
        while True:
            self._check()
            mine = self._mine.get(seq)
            if mine:
                g = mine.popleft()
                want = self._waiting.pop(g)
                if want != call:
                    raise FleetWorldError(
                        f"rank {self.rank}: query {seq} made call {call} "
                        f"where rank 0 granted {want} (grant {g})")
                return g
            if seq in self._ended:
                raise FleetWorldError(
                    f"rank {self.rank}: query {seq} made call {call} "
                    f"after rank 0's {self._ended[seq]} grants for it")
            self._cond.wait()

    def _advance(self) -> None:
        """Pass the pair transfers of other ranks that are next in turn
        (caller holds ``_cond``)."""
        while self._turn in self._passed:
            seq, call = self._passed.pop(self._turn)
            self._ran(self._turn, seq, call)
            self._turn += 1

    @staticmethod
    def _fold(acc: list, rec: tuple, log: list = None) -> None:
        acc[0] += 1
        acc[1] = zlib.crc32(repr(rec).encode(), acc[1])
        if log is not None and len(log) < ORDER_LOG:
            log.append(rec)

    def _ran(self, g: int, seq: int, call: tuple) -> None:
        """Fold grant ``g`` into the digest (caller holds ``_cond``)."""
        op, kind, peer = call
        self._fold(self.grants, (g, seq) + call, self.order_log["grants"])
        if op != "band":
            self._fold(self.groups.setdefault(kind, [0, 0]),
                       (seq, op, peer))

    @contextlib.contextmanager
    def turn(self, seq: int, op: str, kind: str = "", peer: int = -1):
        """Run the block as query ``seq``'s next ordered call: after every
        earlier grant has returned on this rank, and before any later one
        starts.  A failed collective breaks the world (its ranks no longer
        agree on what ran); a band step that raises fails its query only,
        as it does on every rank."""
        call = (op, kind, int(peer))
        err = None
        with self._cond:
            try:
                g = self._take(seq, call)
                while self._turn != g:
                    self._check()
                    self._cond.wait()
            except FleetWorldError as e:
                err = e
        if err is not None:
            self._break(err)
            raise err
        failed = None
        try:
            yield
        except BaseException as e:
            if op != "band":
                failed = e
            raise
        finally:
            with self._cond:
                self._turn = g + 1
                self._ran(g, seq, call)
                self._advance()
                self._cond.notify_all()
            if failed is not None:
                self._break(FleetWorldError(
                    f"rank {self.rank}: grant {g}, {op} over {kind!r} of "
                    f"query {seq}, failed: {type(failed).__name__}: "
                    f"{failed}"))

    # -- admissions and ends -------------------------------------------------

    def admit(self, slot: int, req: _Request, tenant_index: int) -> None:
        """Rank 0: publish that worker ``slot`` runs ``req``."""
        with self._cond:
            self._fold(self.admissions, (slot, req.seq),
                       self.order_log["admissions"])
            self._outbox.append((_ADMIT, slot, req.seq, tenant_index,
                                 _REQ_KINDS.index(req.kind)))
            self._cond.notify_all()

    def query_ended(self, seq: int) -> None:
        """Query ``seq`` ended on this rank, raised or not."""
        err = None
        with self._cond:
            if self.leader:
                self._outbox.append((_END, seq, self._grants_of.pop(seq, 0),
                                     0, 0))
                self._cond.notify_all()
                return
            self._finished.add(seq)
            left = self._mine.get(seq)
            if left:
                err = FleetWorldError(
                    f"rank {self.rank}: query {seq} ended with {len(left)} "
                    f"of rank 0's grants for it not taken")
            if seq in self._ended:
                self._forget(seq)
        if err is not None:
            self._break(err)

    def _forget(self, seq: int) -> None:
        for d in (self._mine, self._ended):
            d.pop(seq, None)
        self._finished.discard(seq)

    # -- the control thread ------------------------------------------------

    def _send(self) -> None:
        """Rank 0: broadcast the outbox in batches until STOP or ABORT."""
        import torch
        import torch.distributed as dist
        buf = torch.zeros(1 + 5 * self.BATCH, dtype=torch.int64)
        while True:
            with self._cond:
                # a turn's end notifies too: wait for records or the beat
                beat = time.monotonic() + self.heartbeat_s
                while not self._outbox and time.monotonic() < beat:
                    self._cond.wait(beat - time.monotonic())
                batch = [self._outbox.popleft()
                         for _ in range(min(self.BATCH, len(self._outbox)))]
            buf.zero_()
            buf[0] = len(batch)
            if batch:
                buf[1:1 + 5 * len(batch)] = torch.tensor(batch).reshape(-1)
            try:
                dist.broadcast(buf, src=0, group=self._group)
            except Exception as e:      # a rank is gone: the world broke
                self._break(FleetWorldError(
                    f"rank 0 could not send the fleet's order: "
                    f"{type(e).__name__}: {e}"))
                return
            with self._cond:
                self.records += len(batch)
                self.batches += 1
            if any(r[0] in (_STOP, _ABORT) for r in batch):
                return

    def _receive(self) -> None:
        """A follower: receive rank 0's batches until STOP or ABORT."""
        import torch
        import torch.distributed as dist
        buf = torch.zeros(1 + 5 * self.BATCH, dtype=torch.int64)
        while True:
            try:
                dist.broadcast(buf, src=0, group=self._group)
            except Exception as e:      # rank 0 is gone or stalled
                self._break(FleetWorldError(
                    f"rank {self.rank} lost rank 0's order: "
                    f"{type(e).__name__}: {e}"))
                return
            n = int(buf[0])
            recs = buf[1:1 + 5 * n].reshape(n, 5).tolist()
            admits, err, end = [], None, None
            with self._cond:
                self.records += n
                self.batches += 1
                for typ, a, b, c, d in recs:
                    if typ == _ADMIT:
                        self._fold(self.admissions, (a, b),
                                   self.order_log["admissions"])
                        admits.append((a, b, c, _REQ_KINDS[d]))
                    elif typ == _GRANT:
                        err = err or self._granted(a, b, c, d)
                    elif typ == _END:
                        self._ended[a] = b
                        if a in self._finished:
                            self._forget(a)
                    else:
                        end = typ
                self._cond.notify_all()
            for admit in admits:
                self._fleet._admitted(*admit)
            if err is not None:
                self._break(err)
            if end == _ABORT:
                self._break(FleetWorldError(
                    f"rank 0 aborted the fleet's order (rank {self.rank})"))
            if end is not None:
                with self._cond:
                    self.stopped = end == _STOP
                return

    def _granted(self, g: int, seq: int, code: int, peer: int):
        """Take in rank 0's grant ``g`` (caller holds ``_cond``); returns
        a ``FleetWorldError`` when it cannot run here."""
        call = self._call(code, peer)
        if call[0] == "pairs" and call[2] != self.rank:
            self._passed[g] = (seq, call)
            self._advance()
            return None
        if seq in self._finished:
            return FleetWorldError(
                f"rank {self.rank}: rank 0 granted {call} to query {seq}, "
                f"which has ended here")
        self._waiting[g] = call
        self._mine.setdefault(seq, collections.deque()).append(g)
        return None

    def _break(self, err: FleetWorldError) -> None:
        """Record that the world broke (the first reason stays), wake
        every waiter and fail the fleet's pending requests.  Rank 0 tells
        the others (ABORT)."""
        with self._cond:
            if self.broken is not None:
                return
            self.broken = err
            if self.leader:
                self._outbox.append((_ABORT, 0, 0, 0, 0))
            self._cond.notify_all()
        self._fleet._world_broken(err)

    # -- shutdown ------------------------------------------------------------

    def close_order(self) -> None:
        """Rank 0 sends STOP (after its drain); every rank waits for its
        control thread, which a follower's ends at STOP or ABORT, or when
        rank 0 stays silent past the group timeout."""
        if self.leader:
            with self._cond:
                self._outbox.append((_STOP, 0, 0, 0, 0))
                self._cond.notify_all()
        self._thread.join()
        if self.leader:
            with self._cond:
                self.stopped = self.broken is None

    def world_summary(self) -> dict:
        with self._cond:
            return {"grants": self.grants[0], "admissions":
                    self.admissions[0], "control_records": self.records,
                    "control_batches": self.batches,
                    "admission_order": list(self.order_log["admissions"]),
                    "grant_order": list(self.order_log["grants"]),
                    "broken": str(self.broken) if self.broken else None}

    def rank_digest(self, scheduler: BandScheduler) -> dict:
        """What every rank must agree on: the admission and grant
        sequences, the band steps and interleaves, and the collective
        calls by group, in order (a pair transfer is one call of the pull
        group on every rank)."""
        with self._cond:
            return {"admissions": self.admissions[1],
                    "grants": self.grants[1],
                    "n_admissions": self.admissions[0],
                    "n_grants": self.grants[0],
                    "band_steps": scheduler.band_steps,
                    "interleaves": scheduler.interleaves,
                    "collectives": {k: {"calls": n, "order": crc}
                                    for k, (n, crc) in
                                    sorted(self.groups.items())}}

    def gather_report(self, scheduler: BandScheduler) -> dict:
        """Every rank's digest, gathered over the control group once the
        control threads have ended at STOP (all ranks, no lock held), and
        whether the ranks agree.  A world that broke, or ended short of
        STOP here, gathers nothing."""
        import torch.distributed as dist
        mine = self.rank_digest(scheduler)
        if not self.stopped or self.broken is not None:
            return {"ranks_agree": False, "ranks": [mine],
                    "error": str(self.broken or "no STOP from rank 0")}
        ranks = [None] * dist.get_world_size(self._group)
        try:
            dist.all_gather_object(ranks, mine, group=self._group)
        except Exception as e:          # a rank broke at its end
            return {"ranks_agree": False, "ranks": [mine],
                    "error": f"{type(e).__name__}: {e}"}
        return {"ranks_agree": all(r == mine for r in ranks),
                "ranks": ranks}


class JoinFleet:
    """N ``JoinService`` tenants behind one store, one mesh and one
    scheduler.

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
        """mesh: the store's execution mesh (``FeaturePlaneStore(mesh=)``);
        the fleet's mesh is the store's, else the host mesh of the world,
        resolved here on every rank before any worker starts.  On a world
        of more than one rank every rank must build the same fleet (the
        same ``max_concurrent``, checked here) and make the same
        submissions in the same order; rank 0 then orders admissions and
        every collective call (module docstring)."""
        if max_concurrent < 1:
            raise ValueError(f"max_concurrent={max_concurrent} must be >= 1")
        from repro_torch.distributed.mesh import (world_rank, world_size,
                                                  world_timeout)
        from repro_torch.engine.sharded import _default_mesh
        self.store = store or FeaturePlaneStore(byte_budget, device=device,
                                                mesh=mesh)
        self.mesh = getattr(self.store, "mesh", None) or _default_mesh()
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
        self._submitted = 0                # submission numbers handed out
        self._broken: Optional[FleetWorldError] = None
        # a follower's admissions, per worker slot: (seq, tenant index,
        # kind), and its submitted requests not yet taken, by seq
        self._admits = [collections.deque() for _ in range(max_concurrent)]
        self._pending: dict = {}
        self._order: Optional[_WorldOrder] = None
        self.world_report: Optional[dict] = None
        if world_size() > 1:
            self._order = self._world_order(world_rank(), world_size(),
                                            world_timeout())
        self._workers = [
            threading.Thread(target=self._worker, args=(i,),
                             name=f"fleet-worker-{i}", daemon=True)
            for i in range(self.max_concurrent)]
        for w in self._workers:
            w.start()

    def _world_order(self, rank: int, n: int, timeout) -> _WorldOrder:
        """The control group (every rank, in the same order) and rank 0's
        order over it, after checking that every rank runs as many
        workers."""
        import torch
        import torch.distributed as dist
        group = dist.new_group(list(range(n)), timeout=timeout)
        mine = torch.tensor([self.max_concurrent], dtype=torch.int64)
        got = [torch.zeros_like(mine) for _ in range(n)]
        dist.all_gather(got, mine, group=group)
        workers = [int(t) for t in got]
        if len(set(workers)) != 1:
            raise ValueError(f"the ranks' fleets run {workers} workers: "
                             f"every rank must build the same fleet")
        return _WorldOrder(self, group, rank, timeout.total_seconds())

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
        another backend's constructor.  On a world of several ranks the
        sharded entry also carries the fleet's mesh, so no worker's engine
        resolves (and maybe creates) one."""
        from repro_torch.engine import ENGINES
        opts = dict(cfg.engine_opts)
        if opts and not (set(opts) <= set(ENGINES)):
            opts = {cfg.engine: opts}
        sharded = dict(opts.get("sharded", {}))
        sharded["scheduler"] = self.scheduler
        if self._order is not None:
            sharded.setdefault("mesh", self.mesh)
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
            req.seq = self._submitted
            self._submitted += 1
            if self._broken is not None:
                req.error = self._broken
                req.done.set()
            else:
                self._queues[tenant].append(req)
                if self._order is not None and not self._order.leader:
                    self._pending[req.seq] = req
            self._cond.notify_all()
        with self._mlock:
            self.metrics.inc("fleet.submitted")
            if req.error is not None:
                self.metrics.inc("fleet.failed")
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

    def _admitted(self, slot: int, seq: int, tenant_index: int,
                  kind: str) -> None:
        """A follower: rank 0's worker ``slot`` runs request ``seq``."""
        with self._cond:
            self._admits[slot].append((seq, tenant_index, kind))
            self._cond.notify_all()

    def _followed_request(self, slot: int):
        """A follower's next request for worker ``slot`` (caller holds the
        lock): rank 0's pick, once it has been submitted here and its
        tenant's previous request is done here.  Returns (request or None,
        ``FleetWorldError`` or None)."""
        adm = self._admits[slot]
        if not adm:
            return None, None
        seq, idx, kind = adm[0]
        req = self._pending.get(seq)
        if req is None:                 # not submitted here yet
            return None, None
        tenant = self._rr[idx] if idx < len(self._rr) else None
        if req.tenant != tenant or req.kind != kind:
            return None, FleetWorldError(
                f"rank 0 admitted request {seq} ({kind} of tenant "
                f"{tenant!r}); here it is a {req.kind} of tenant "
                f"{req.tenant!r}: the ranks' submissions differ")
        queue = self._queues[tenant]
        if queue[0] is not req or tenant in self._running:
            return None, None           # its tenant's earlier request first
        adm.popleft()
        queue.pop(0)
        del self._pending[seq]
        self._running.add(tenant)
        return req, None

    def _worker(self, slot: int) -> None:
        order = self._order
        follow = order is not None and not order.leader
        while True:
            err = None
            with self._cond:
                while True:
                    if self._broken is not None:
                        return
                    if follow:
                        req, err = self._followed_request(slot)
                    else:
                        req = self._next_request()
                    if req is not None or err is not None:
                        break
                    if self._closed:
                        return
                    self._cond.wait()
            if err is not None:
                order._break(err)
                continue
            if order is not None and order.leader:
                order.admit(slot, req, self._rr.index(req.tenant))
            self._run(req)

    def _run(self, req: _Request) -> None:
        svc = self._services[req.tenant]
        wait_s = time.perf_counter() - req.t_submit
        with self._mlock:
            self.metrics.inc("fleet.admitted")
            self.metrics.observe("fleet.queue_wait_s", wait_s)
        t0 = time.perf_counter()
        order = self._order
        try:
            with use_tracer(req.tracer):
                with current_tracer().span(
                        f"fleet.{req.kind}", track=f"tenant:{req.tenant}",
                        tenant=req.tenant):
                    with collectives.ordered_calls(order, req.seq) \
                            if order is not None else contextlib.nullcontext():
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
            if order is not None:
                order.query_ended(req.seq)
            with self._cond:
                self._running.discard(req.tenant)
                self._cond.notify_all()
            req.done.set()

    def _world_broken(self, err: FleetWorldError) -> None:
        """Fail every request not yet running and stop admitting: the
        world under the fleet broke (``_WorldOrder._break``)."""
        with self._cond:
            if self._broken is None:
                self._broken = err
            failed = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            for adm in self._admits:
                adm.clear()
            self._pending.clear()
            self._cond.notify_all()
        for r in failed:
            r.error = err
            r.done.set()
        if failed:
            with self._mlock:
                self.metrics.inc("fleet.failed", len(failed))

    # -- lifecycle -----------------------------------------------------------

    def drain(self) -> dict:
        """Wait until every queue is empty and nothing is in flight, then
        publish scheduler totals into the metrics and return a summary
        (on a world of several ranks also this rank's part of rank 0's
        order: grants, admissions, control records)."""
        with self._cond:
            while any(self._queues.values()) or self._running:
                self._cond.wait()
        with self._mlock:
            sched = self.scheduler
            for name, v in (("band_steps", sched.band_steps),
                            ("interleaves", sched.interleaves)):
                m = f"fleet.{name}"
                self.metrics.inc(m, v - self.metrics.value(m))
            out = {
                "tenants": list(self._rr),
                "band_steps": sched.band_steps,
                "interleaves": sched.interleaves,
                "submitted": self.metrics.value("fleet.submitted"),
                "completed": self.metrics.value("fleet.completed"),
                "failed": self.metrics.value("fleet.failed"),
                "store": self.store.snapshot(),
            }
        if self._order is not None:
            out["world"] = dict(self._order.world_summary(), size=self.mesh.size,
                                rank=self._order.rank)
        return out

    def close(self) -> None:
        """Drain, then stop the workers (idempotent).  On a world of
        several ranks every rank must close: rank 0 then sends STOP, each
        rank waits for its control thread, and the ranks compare their
        digests (``world_report``: ``ranks_agree``, each rank's digest,
        and this rank's final grant and record counts under ``order``)."""
        self.drain()
        order = self._order
        if order is not None:
            order.close_order()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout=10)
        if order is not None and self.world_report is None:
            self.world_report = dict(
                order.gather_report(self.scheduler),
                order=order.world_summary())

    def __enter__(self) -> "JoinFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
