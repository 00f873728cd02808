"""Ring engine: L sharded over the ranks of a join mesh, R streamed in
bands through a depth-k prefetch ring, candidates compacted on the device
(port of the JAX package's ``engine/sharded.py``; its name stays
``"sharded"`` so that engine names, ``engine_opts`` keys and CLI flags
match the reference's).

Layout (the reference's, over a ``torch.distributed`` world of ranks in
place of a device mesh; ``distributed/mesh.py``):

  * L rows are sharded over the mesh's L axes — ``("pod", "data")`` on a
    join mesh, ``("data",)`` on the host mesh: each of the ``l_shards =
    n_pods * n_data`` shards owns ``rows_shard`` contiguous rows of L
    padded to ``l_shards * tl``.  R is replicated on every rank and
    *streamed*: the host loop walks R in ``r_chunk``-column bands.  At
    host step ``k`` pod ``p`` works band ``(k + p * stride) % n_chunks``
    (``stride = max(1, n_chunks // n_pods)``), so the pods occupy
    distinct bands while each still covers every band over the sweep;
    within a pod the band is split over the ``model`` axis, each rank
    taking an ``r_chunk / n_model``-column sub-band.  Device-resident
    working state is O(rows_shard · r_chunk), never O(rows · n_r);
  * per band step the fused CNF kernel (``cnf_join_block``, grid
    rows_shard/tl × r_sub/tr tiles, with its evals grid) produces the
    packed int32 mask, which is immediately compacted on the device into
    an (i, j) candidate buffer (``engine.extract``: the ``csrc/extract.cu``
    kernel) — the mask never leaves device memory;
  * the band loop runs a **depth-k prefetch ring** (``prefetch_depth``,
    default 2): up to ``k`` band steps are enqueued (no host sync) before
    the host blocks pulling the oldest step's count and eval counter (8
    bytes) and its first ``count`` buffer rows.  Stream ordering replaces
    JAX's async dispatch: each step's kernels and the copy of its counters
    into pinned host memory run on the current stream, followed by an
    event; its pairs are copied on a separate copy stream that waits on
    that event only, so the pull does not queue behind the successors'
    kernels.  ``prefetch_depth=1`` is the serial control: ``overlap_s`` is
    exactly 0;
  * the counts then meet on the host, over ``gloo``
    (``distributed.collectives``, which counts every call's bytes by
    group): the world's counts and eval counters are gathered, so every
    rank takes the same overflow decision; the rank's global base comes
    from ``extract.hierarchical_offsets`` (within the pod, then the pod
    totals across pods — the only collective that crosses a pod) and is
    checked against the gathered counts; the other ranks send their pairs
    to the coordinating rank (rank 0), 8 B a pair;
  * CNF evaluation **short-circuits** (``early_reject``, default on) as
    the kernel does; the work done is pulled per step as an int32 eval
    counter and surfaced as ``EngineStats.conjunct_evals``.

Every rank runs the same program on the same inputs (SPMD); an all-gather
of a plan fingerprint at the start of each evaluation checks it.  Only the
coordinating rank yields chunks (each L-complete, so the steps partition
the candidate set); the other ranks evaluate their shards and yield
nothing.  ``bytes_to_host`` on the coordinator is the reference's sum over
the world: 12 B a rank a step (count, base, eval counter), 8 B a rank
again for each retry pull, and 8 B a pair.

Capacity is bounded-and-retried, never silently truncated: the device
count keeps growing past the buffer; on overflow (any rank's count over
its capacity, decided on the gathered counts) every rank re-runs *that
step* at the grown capacity (``extract.grow_caps``, ≥4× per shard, the
uniform dispatch capacity being the per-shard max) and invalidates and
re-dispatches **all** in-flight successor steps, so no chunk is ever
emitted at a stale buffer size.  Capacities are sweep-local:
``self.capacity`` is construction-time config and is never mutated (the
last sweep's final sizes are ``last_sweep_caps`` / ``last_sweep_capacity``).
Padded rows/cols are filtered on the host — O(candidates) work.

The mesh is resolved per evaluation (a mesh given at construction wins,
else the plane set's, else the host mesh of the current world) and never
pinned on the instance.  On ``device="cpu"`` the same loop runs the
kernels' plain-torch versions, synchronously.  What the reference has and
this engine has not: its jit program cache (nothing here is compiled per
plan; kernel A's clause plan is cached by its wrapper).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.engine import extract
from repro_torch.engine.base import ChunkDelta, CnfEngine
from repro_torch.obs.trace import current_tracer


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unpulled band step of the prefetch ring."""
    k: int                             # host step index
    cap: int                           # buffer rows it was built at
    buf: torch.Tensor                  # device int32 (cap, 2)
    meta: torch.Tensor                 # host int32 (2,): count, evals
    done: Optional[torch.cuda.Event]   # after compaction + meta copy (CUDA)
    t_enq: float = 0.0                 # perf_counter at enqueue (trace)
    events: list = dataclasses.field(default_factory=list)  # trace instants


class _Transfers:
    """Device-to-host pulls of the ring's steps.  On CUDA: the counters are
    copied into pinned memory on the compute stream as the step is
    enqueued, and the pairs on a copy stream that waits on the step's
    event; on the CPU both are the tensors themselves."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None

    def post(self, k: int, cap: int, buf, meta_dev) -> _InFlight:
        if not self.cuda:
            return _InFlight(k, cap, buf, meta_dev, None)
        meta = torch.empty(meta_dev.shape, dtype=meta_dev.dtype,
                           pin_memory=True)
        meta.copy_(meta_dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return _InFlight(k, cap, buf, meta, done)

    @staticmethod
    def wait(step: _InFlight) -> np.ndarray:
        """Block until the step's counters are on the host."""
        if step.done is not None:
            step.done.synchronize()
        return step.meta.numpy()

    def pairs(self, step: _InFlight, take: int) -> np.ndarray:
        """The step's first ``take`` buffer rows on the host."""
        if not self.cuda:
            return step.buf[:take].numpy()
        host = torch.empty((take, 2), dtype=torch.int32, pin_memory=True)
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(step.done)
            host.copy_(step.buf[:take], non_blocking=True)
            # the allocator must not hand this memory to a later step
            # before the copy stream has read it
            step.buf.record_stream(self.copy_stream)
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        copied.synchronize()
        return host.numpy()


_HOST_MESH: dict = {}                  # world -> shared default mesh
_HOST_MESH_LOCK = threading.Lock()     # fleet: engines resolve it concurrently


def _default_mesh():
    """The host mesh of the current world, one per world: a stable key for
    the plane sets' ``pack_cache``."""
    from repro_torch.distributed.mesh import (make_host_mesh, world_rank,
                                              world_size)
    import torch.distributed as dist
    world = dist.group.WORLD if dist.is_available() and \
        dist.is_initialized() else None
    key = (id(world), world_size(), world_rank())
    with _HOST_MESH_LOCK:
        if key not in _HOST_MESH:
            _HOST_MESH.clear()
            _HOST_MESH[key] = make_host_mesh()
        return _HOST_MESH[key]


def _mesh_geometry(mesh):
    """(l_axes, n_pods, n_data, n_model) for any engine-usable mesh."""
    from repro_torch.distributed.mesh import l_shard_axes
    names = mesh.axis_names
    if "data" not in names:
        raise ValueError(f"mesh {names} has no 'data' axis")
    return (l_shard_axes(mesh), mesh.shape.get("pod", 1),
            mesh.shape["data"], mesh.shape.get("model", 1))


class ShardedEngine(CnfEngine):
    name = "sharded"

    def __init__(self, mesh=None, *, tl: int = 128, tr: int = 128,
                 r_chunk: Optional[int] = None,
                 capacity: Optional[int] = None, use_kernel: bool = True,
                 prefetch_depth: Optional[int] = None,
                 early_reject: bool = True, scheduler=None, device="cuda"):
        """mesh: a ``distributed.mesh.JoinMesh`` with a "data" axis and
        optional "pod" / "model" axes; when None the mesh is resolved
        *per evaluation* (the plane set's, else the host mesh).  tl/tr:
        kernel tile edges (tr % 32 == 0), which are also the units of the
        eval counter.  r_chunk: R stream band (multiple of tr * n_model;
        default 4 * tr * n_model).  capacity: initial per-rank per-step
        candidate buffer (default max(4096, 4 * rows_shard)); overflow
        grows a per-shard working copy >=4x within the sweep, never this
        config value.  use_kernel=False swaps the fused kernel for its
        plain-torch version over the whole sub-band
        (``cnf_join_ref_counted``: one eval unit is the sub-band, as the
        reference's jnp path counts it); it is for ``device="cpu"`` only —
        on CUDA the ring always runs the kernels.  prefetch_depth: how many
        band steps may be in flight at once (default 2; 1 = serial).
        early_reject=False disables the conjunct short-circuit.
        scheduler: the fleet's ``BandScheduler``; when set, every
        band-step *enqueue* runs under ``scheduler.step()`` (pulls and
        filtering are not gated).  device: where this rank's ring runs
        (``cuda`` unless the caller asks for ``cpu``)."""
        if tr % 32 != 0:
            raise ValueError(f"tr={tr} must be a multiple of 32 (packed mask)")
        if not use_kernel and torch.device(device).type == "cuda":
            raise ValueError(
                "use_kernel=False runs the plain-torch CNF; on a CUDA device "
                "the ring engine runs the kernels (pass device='cpu')")
        self.mesh = mesh
        self.tl = int(tl)
        self.tr = int(tr)
        self.r_chunk = int(r_chunk) if r_chunk else None
        if self.r_chunk and self.r_chunk % self.tr != 0:
            # necessary on any mesh; the full tr*n_model divisibility is
            # checked once the mesh (and its model-axis width) is known
            raise ValueError(
                f"r_chunk={self.r_chunk} must be a multiple of tr={tr}")
        self.capacity = capacity
        self.use_kernel = bool(use_kernel)
        if prefetch_depth is not None and int(prefetch_depth) < 1:
            raise ValueError(
                f"prefetch_depth={prefetch_depth} must be >= 1 (1 = serial)")
        self.prefetch_depth = int(prefetch_depth) if prefetch_depth else None
        self.early_reject = bool(early_reject)
        self.scheduler = scheduler
        self.device = resolve_device(device)
        # diagnostics only (tests, reports): the per-shard capacities the
        # most recent sweep ended at.  Not config — the next evaluation
        # starts from ``self.capacity`` again.
        self.last_sweep_caps: Optional[np.ndarray] = None

    @property
    def effective_prefetch_depth(self) -> int:
        """The ring depth evaluations run at: ``prefetch_depth``, else 2."""
        return self.prefetch_depth or 2

    @property
    def last_sweep_capacity(self) -> int:
        """Max capacity the most recent sweep ended at (0 if the engine has
        not evaluated yet)."""
        if self.last_sweep_caps is None:
            return 0
        return int(self.last_sweep_caps.max())

    def _resolve_r_chunk(self, n_model: int) -> int:
        r_chunk = self.r_chunk if self.r_chunk else 4 * self.tr * n_model
        if r_chunk % (self.tr * n_model) != 0:
            raise ValueError(
                f"r_chunk={r_chunk} must be a multiple of tr*n_model="
                f"{self.tr * n_model} (each of the {n_model} model-axis "
                f"ranks kernels a whole-tile sub-band)")
        return r_chunk

    def _resolve_mesh(self, feats):
        """The evaluation mesh for this call — resolved fresh every time: a
        mesh passed at construction wins, else the plane set's (its
        store's), else the host mesh.  Never cached on the instance."""
        return self.mesh or getattr(feats, "mesh", None) or _default_mesh()

    # -- device work of one band step ----------------------------------------

    def _band_mask(self, staged, kclauses, thetas, col0, r_sub):
        """(packed int32 mask, int32 eval units) of this rank's L shard
        against R columns [col0, col0 + r_sub)."""
        from repro_torch.kernels.fused_cnf_join import ops as cnf_ops
        from repro_torch.kernels.fused_cnf_join import ref as cref
        emb_l, emb_r, scal_l, scal_r = staged.arrays
        erk = emb_r[:, col0:col0 + r_sub]
        srk = scal_r[:, col0:col0 + r_sub]
        # evals: conjunct-eval units the device really computed — kernel
        # path: clauses per tile, summed over the tile grid on the device
        # (unit = tl*tr pairs); plain path: clauses for the whole sub-band
        # (unit = rows_shard*r_sub pairs)
        if self.use_kernel:
            packed, evals_grid = cnf_ops.cnf_join_block(
                emb_l, erk, scal_l, srk, kclauses, thetas, tl=self.tl,
                tr=self.tr, early_reject=self.early_reject, with_evals=True)
            return packed, evals_grid.sum(dtype=torch.int32)
        ok, units = cref.cnf_join_ref_counted(
            emb_l, erk, scal_l, srk, kclauses, thetas,
            early_reject=self.early_reject)
        return cref.pack_mask(ok), torch.full((), units, dtype=torch.int32,
                                              device=ok.device)

    # -- evaluation ---------------------------------------------------------

    @staticmethod
    def _check_plan(mesh, *plan) -> None:
        """Every rank must run the same plan: all-gather a fingerprint of
        it (one int32 a rank) and compare."""
        fp = zlib.crc32(repr(plan).encode()) & 0x7FFFFFFF
        got = collectives.all_gather(np.array([fp], np.int32), mesh, "pull")
        if (got != fp).any():
            raise RuntimeError(
                f"ranks disagree on the plan (fingerprints "
                f"{got.reshape(-1).tolist()}): every rank must evaluate the "
                f"same clauses, thresholds and corpus")

    def _evaluate_stream(self, feats, clauses, thetas, n_l, n_r):
        from repro_torch.kernels.fused_cnf_join import ops as cnf_ops

        mesh = self._resolve_mesh(feats)
        l_axes, n_pods, n_data, n_model = _mesh_geometry(mesh)
        l_shards = n_pods * n_data
        n_dev = l_shards * n_model
        r_chunk = self._resolve_r_chunk(n_model)
        r_sub = r_chunk // n_model
        # pad L to a multiple of l_shards*tl (equal, tile-aligned shards)
        # and R to a multiple of r_chunk (whole stream steps); a serving
        # plane set is assembled on its device with zero H2D and laid out
        # on the mesh once (both memoized in its pack_cache)
        tracer = current_tracer()
        t_stage0 = time.perf_counter()
        staged = cnf_ops.stage_planes(feats, clauses, tl=l_shards * self.tl,
                                      tr=r_chunk, device=self.device,
                                      mesh=mesh, l_axes=l_axes)
        if tracer:
            tracer.record_span(
                "stage_planes", t_stage0, time.perf_counter(),
                attrs={"bytes_h2d": staged.bytes_h2d,
                       "bytes_reshard": staged.bytes_reshard})
        kclauses = staged.kclauses
        rows_shard, pr_n = staged.emb_l.shape[1], staged.emb_r.shape[1]
        n_chunks = pr_n // r_chunk
        thetas = tuple(float(t) for t in thetas)
        # this rank's place: its L rows, and its pod's band rotation
        pod = mesh.coords.get("pod", 0)
        model = mesh.coords.get("model", 0)
        row0 = (pod * n_data + mesh.coords["data"]) * rows_shard
        stride = max(1, n_chunks // n_pods)
        coordinator = mesh.is_coordinator

        # per-(pod, data, model)-shard capacities, local to THIS sweep:
        # growth persists across the sweep's remaining steps but never
        # mutates the engine — a shared serving engine that once hit a
        # dense join must not over-allocate every later query
        caps = np.full(n_dev, self.capacity or max(4096, 4 * rows_shard),
                       np.int64)
        depth = self.effective_prefetch_depth
        self._check_plan(mesh, kclauses, thetas, n_l, n_r, rows_shard, pr_n,
                         r_chunk, int(caps[0]), self.tl, self.tr,
                         self.use_kernel, self.early_reject, depth)
        timing = {"dispatch": 0.0}
        # host conversion factor from device eval *units* to (pair, clause)
        # evaluations (see _band_mask)
        unit_pairs = (self.tl * self.tr if self.use_kernel
                      else rows_shard * r_sub)
        io = _Transfers(self.device)
        sched = self.scheduler

        def dispatch(k) -> _InFlight:
            """Enqueue band step k at the current uniform capacity (no host
            sync).  Under a fleet scheduler the enqueue itself is the
            scheduling point: steps from concurrent queries take turns in
            ticket order."""
            cap = int(caps.max())
            t0 = time.perf_counter()
            with sched.step() if sched is not None \
                    else contextlib.nullcontext():
                band = (k + pod * stride) % n_chunks
                col0 = band * r_chunk + model * r_sub
                packed, evals = self._band_mask(staged, kclauses, thetas,
                                                col0, r_sub)
                buf, cnt = extract.extract_pairs(packed, capacity=cap,
                                                 row_offset=row0,
                                                 col_offset=col0)
                step = io.post(k, cap, buf, torch.stack([cnt, evals]))
            timing["dispatch"] += time.perf_counter() - t0
            step.t_enq = t0
            return step

        def pull_counts(step):
            """Block on this rank's count + eval units, then gather the
            world's (every rank decides on the same counts); returns
            (counts per rank, pair-clause evals, bytes the reference
            pulls)."""
            meta = io.wait(step)
            world = collectives.all_gather(meta[:2], mesh, "pull")
            counts = world[:, 0].copy()
            ev = world[:, 1].copy()
            return counts, int(ev.sum()) * unit_pairs, counts.nbytes + ev.nbytes

        ring: collections.deque = collections.deque()   # oldest first
        next_k = 0
        hold_overlap = 0.0             # consumer hold with a step in flight
        while ring or next_k < n_chunks:
            # keep up to `depth` steps in flight: refill BEFORE blocking on
            # the oldest step's pull, so successor bands compute while the
            # host pulls/filters and the consumer holds the chunk.  At
            # depth 1 this is the serial loop — the ring is empty during
            # the pull and the hold.
            while len(ring) < depth and next_k < n_chunks:
                ring.append(dispatch(next_k))
                next_k += 1
            step = ring.popleft()
            k = step.k
            t_enq = step.t_enq         # first enqueue: the in-flight window
            step_events = step.events  # opens here even across retries
            t_pull0 = time.perf_counter()
            bytes_to_host = 0
            conjunct_evals = 0         # includes retry attempts: real work
            counts, ev, nb = pull_counts(step)
            conjunct_evals += ev
            bytes_to_host += nb
            retired = []               # invalidated steps, held until the
            while (counts > step.cap).any():   # retry's pull (stream order)
                # overflow: grow only the overflowing shards (>=4x each);
                # counts are exact true totals, so the retried step —
                # dispatched at the new per-shard max — cannot overflow
                # again.  Every in-flight successor was built at the stale
                # capacity: invalidate them all and re-dispatch them right
                # after the retry, in order.
                caps[:] = extract.grow_caps(caps, counts)
                t_retry0 = time.perf_counter()
                successors = [s.k for s in ring]
                if tracer:
                    step_events.append(
                        ("overflow", t_retry0,
                         {"counts_max": int(counts.max()),
                          "cap": step.cap}))
                    if successors:
                        step_events.append(
                            ("invalidate", t_retry0, {"steps": successors}))
                retired += [step, *ring]
                ring.clear()
                step = dispatch(k)
                for kk in successors:
                    redis = dispatch(kk)
                    if tracer:
                        redis.events.append(
                            ("redispatch", redis.t_enq, {"cap": redis.cap}))
                    ring.append(redis)
                t_pull0 += time.perf_counter() - t_retry0   # it's dispatch,
                counts, ev, nb = pull_counts(step)          # not pull
                conjunct_evals += ev
                bytes_to_host += nb
            retired.clear()
            cap = step.cap
            base, _ = extract.hierarchical_offsets(int(counts[mesh.rank]),
                                                   mesh)
            bytes_to_host += 4 * n_dev          # one int32 base a rank
            expect = np.cumsum(counts) - counts
            if base != expect[mesh.rank]:
                raise RuntimeError(
                    "hierarchical candidate-count prefix-sum disagrees with "
                    f"host bookkeeping: rank {mesh.rank} base {base} vs "
                    f"expected {int(expect[mesh.rank])}")
            # this rank's first `count` buffer rows (the O(candidates)
            # pull); the coordinator receives the others' in rank order
            take = int(counts[mesh.rank])
            own = io.pairs(step, take) if take else None
            if not coordinator:
                if take:
                    collectives.send_pairs(own, mesh)
                timing["dispatch"] = 0.0
                continue
            segs = []
            for d in range(n_dev):
                n = int(counts[d])
                if n:
                    seg = own if d == mesh.rank else \
                        collectives.recv_pairs(n, d, mesh)
                    bytes_to_host += seg.nbytes
                    segs.append(seg)
            if segs:
                arr = np.concatenate(segs, axis=0)
                keep = (arr[:, 0] < n_l) & (arr[:, 1] < n_r)  # drop padding
                arr = arr[keep]
                pairs = list(zip(arr[:, 0].tolist(), arr[:, 1].tolist()))
            else:
                pairs = []
            chunk_h2d = staged.bytes_h2d if k == 0 else 0
            chunk_reshard = staged.bytes_reshard if k == 0 else 0
            t_pull1 = time.perf_counter()
            pull_s = t_pull1 - t_pull0
            dispatch_s, timing["dispatch"] = timing["dispatch"], 0.0
            # overlap accounting: host work done while a successor step was
            # in flight on the device — this pull/filter window, plus the
            # time the consumer held the previous chunk.  Exactly 0 for the
            # depth-1 (serial) ring.
            overlap_s = (pull_s if ring else 0.0) + hold_overlap
            trace = track = None
            if tracer:
                # the "dispatch" slice is the *in-flight window* (enqueue →
                # pull-begin): at depth ≥ 2 it contains predecessors' pull
                # windows — the ring overlap, visible as cross-track slice
                # overlap in Perfetto; at depth 1 it never does.  The host
                # enqueue wall itself rides along as ``enqueue_s``.
                trace = [
                    {"name": "dispatch", "t0": t_enq, "t1": t_pull0,
                     "attrs": {"enqueue_s": dispatch_s, "cap": cap,
                               "band": k}},
                    {"name": "pull", "t0": t_pull0, "t1": t_pull1,
                     "attrs": {"bytes": bytes_to_host,
                               "candidates": len(pairs)}},
                ]
                track = f"ring{k % depth}"
            t_yield = time.perf_counter()
            yield ChunkDelta(pairs, bytes_to_host, chunk_h2d, chunk_reshard,
                             dispatch_s=dispatch_s, pull_s=pull_s,
                             overlap_s=overlap_s,
                             conjunct_evals=conjunct_evals,
                             trace=trace, trace_events=step_events or None,
                             track=track)
            hold = time.perf_counter() - t_yield
            hold_overlap = hold if ring else 0.0
        self.last_sweep_caps = caps.copy()
