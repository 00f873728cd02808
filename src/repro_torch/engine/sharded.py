"""Ring engine: R streamed in bands through a depth-k prefetch ring on one
device, candidates compacted on the device (port of the JAX package's
``engine/sharded.py`` on one device; its name stays ``"sharded"`` so that
engine names, ``engine_opts`` keys and CLI flags match the reference's).

Layout:

  * L is staged whole on the device (``rows`` = L padded to ``tl``); R is
    padded to ``r_chunk`` and *streamed*: the host loop walks R in
    ``r_chunk``-column bands.  Device-resident working state is
    O(rows · r_chunk), never O(rows · n_r);
  * per band step the fused CNF kernel (``cnf_join_block``, grid rows/tl
    × r_chunk/tr tiles, with its evals grid) produces the packed int32
    mask, which is immediately compacted on the device into a (i, j)
    candidate buffer (``engine.extract``: the ``csrc/extract.cu`` kernel)
    — the mask never leaves device memory;
  * the band loop runs a **depth-k prefetch ring** (``prefetch_depth``,
    default 2 ≡ the classic double buffer): up to ``k`` band steps are
    enqueued (no host sync) before the host blocks pulling the oldest
    step's count, base and eval counter (12 bytes) and its first
    ``count`` buffer rows — O(candidates) transfer in all.  Stream
    ordering replaces JAX's async dispatch: each step's kernels and the
    copy of its three counters into pinned host memory run on the current
    stream, followed by an event; its pairs are copied on a separate copy
    stream that waits on that event only, so the pull does not queue
    behind the successors' kernels.  ``prefetch_depth=1`` (≡
    ``double_buffer=False``) is the serial control: ``overlap_s`` is
    exactly 0;
  * CNF evaluation **short-circuits** (``early_reject``, default on) as
    the kernel does; the work done is pulled per step as an int32 eval
    counter and surfaced as ``EngineStats.conjunct_evals``.

Capacity is bounded-and-retried, never silently truncated: the device
count keeps growing past the buffer; on overflow the host re-runs *that
step* at the grown capacity (``extract.grow_caps``, ≥4×) and invalidates
and re-dispatches **all** in-flight successor steps, so no chunk is ever
emitted at a stale buffer size.  Capacities are sweep-local:
``self.capacity`` is construction-time config and is never mutated (the
last sweep's final sizes are ``last_sweep_caps`` / ``last_sweep_capacity``).
Padded rows/cols are filtered on the host — O(candidates) work.

On ``device="cpu"`` the same loop runs the kernels' plain-torch versions,
synchronously.  What the reference has and this engine has not: its jit
program cache (nothing here is compiled per plan; kernel A's clause plan
is cached by its wrapper), the mesh (L shards, pods, the model axis) and
``hierarchical_offsets`` (one device: the base is the 1-rank exclusive
prefix sum, 0, still computed and pulled so the bookkeeping check stays).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine import extract
from repro_torch.engine.base import ChunkDelta, CnfEngine
from repro_torch.obs.trace import current_tracer


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unpulled band step of the prefetch ring."""
    k: int                             # host step index
    cap: int                           # buffer rows it was built at
    buf: torch.Tensor                  # device int32 (cap, 2)
    meta: torch.Tensor                 # host int32 (3,): count, base, evals
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
        meta = torch.empty(3, dtype=torch.int32, pin_memory=True)
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


class ShardedEngine(CnfEngine):
    name = "sharded"

    def __init__(self, *, tl: int = 128, tr: int = 128,
                 r_chunk: Optional[int] = None,
                 capacity: Optional[int] = None, use_kernel: bool = True,
                 double_buffer: bool = True,
                 prefetch_depth: Optional[int] = None,
                 early_reject: bool = True, scheduler=None, device="cuda"):
        """tl/tr: kernel tile edges (tr % 32 == 0), which are also the
        units of the eval counter.  r_chunk: R stream band (multiple of tr;
        default 4*tr).  capacity: initial per-step candidate buffer
        (default max(4096, 4 * rows)); overflow grows a working copy >=4x
        within the sweep, never this config value.  use_kernel=False swaps
        the fused kernel for its plain-torch version over the whole band
        (``cnf_join_ref_counted``: one eval unit is the band, as the
        reference's jnp path counts it); it is for ``device="cpu"`` only —
        on CUDA the ring always runs the kernels.  prefetch_depth: how many band
        steps may be in flight at once (default 2; 1 = serial).
        double_buffer=False is the legacy spelling of prefetch_depth=1 (an
        explicit prefetch_depth wins).  early_reject=False disables the
        conjunct short-circuit.  scheduler: the fleet's ``BandScheduler``;
        when set, every band-step *enqueue* runs under
        ``scheduler.step()`` (pulls and filtering are not gated).
        device: where the ring runs (``cuda`` unless the caller asks for
        ``cpu``)."""
        if tr % 32 != 0:
            raise ValueError(f"tr={tr} must be a multiple of 32 (packed mask)")
        if not use_kernel and torch.device(device).type == "cuda":
            raise ValueError(
                "use_kernel=False runs the plain-torch CNF; on a CUDA device "
                "the ring engine runs the kernels (pass device='cpu')")
        self.tl = int(tl)
        self.tr = int(tr)
        self.r_chunk = int(r_chunk) if r_chunk else None
        if self.r_chunk and self.r_chunk % self.tr != 0:
            raise ValueError(
                f"r_chunk={self.r_chunk} must be a multiple of tr={tr}")
        self.capacity = capacity
        self.use_kernel = bool(use_kernel)
        self.double_buffer = bool(double_buffer)
        if prefetch_depth is not None and int(prefetch_depth) < 1:
            raise ValueError(
                f"prefetch_depth={prefetch_depth} must be >= 1 (1 = serial)")
        self.prefetch_depth = int(prefetch_depth) if prefetch_depth else None
        self.early_reject = bool(early_reject)
        self.scheduler = scheduler
        self.device = resolve_device(device)
        # diagnostics only (tests, reports): the capacities the most recent
        # sweep ended at.  Not config — the next evaluation starts from
        # ``self.capacity`` again.
        self.last_sweep_caps: Optional[np.ndarray] = None

    @property
    def effective_prefetch_depth(self) -> int:
        """The ring depth evaluations run at: an explicit ``prefetch_depth``
        wins; otherwise 2 (double buffer) or 1 (``double_buffer=False``)."""
        if self.prefetch_depth is not None:
            return self.prefetch_depth
        return 2 if self.double_buffer else 1

    @property
    def last_sweep_capacity(self) -> int:
        """Max capacity the most recent sweep ended at (0 if the engine has
        not evaluated yet)."""
        if self.last_sweep_caps is None:
            return 0
        return int(self.last_sweep_caps.max())

    # -- device work of one band step ----------------------------------------

    def _band_mask(self, staged, kclauses, thetas, col0, r_chunk):
        """(packed int32 mask, int32 eval units) of band [col0, col0 +
        r_chunk) against all of L."""
        from repro_torch.kernels.fused_cnf_join import ops as cnf_ops
        from repro_torch.kernels.fused_cnf_join import ref as cref
        emb_l, emb_r, scal_l, scal_r = staged.arrays
        erk = emb_r[:, col0:col0 + r_chunk]
        srk = scal_r[:, col0:col0 + r_chunk]
        # evals: conjunct-eval units the device really computed — kernel
        # path: clauses per tile, summed over the tile grid on the device
        # (unit = tl*tr pairs); plain path: clauses for the whole band
        # (unit = rows*r_chunk pairs)
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

    def _evaluate_stream(self, feats, clauses, thetas, n_l, n_r):
        from repro_torch.kernels.fused_cnf_join import ops as cnf_ops

        r_chunk = self.r_chunk or 4 * self.tr
        # pad L to a multiple of tl and R to a multiple of r_chunk (whole
        # stream steps); a serving plane set is assembled on its device
        # with zero H2D (memoized in its pack_cache)
        tracer = current_tracer()
        t_stage0 = time.perf_counter()
        staged = cnf_ops.stage_planes(feats, clauses, tl=self.tl, tr=r_chunk,
                                      device=self.device)
        if tracer:
            tracer.record_span(
                "stage_planes", t_stage0, time.perf_counter(),
                attrs={"bytes_h2d": staged.bytes_h2d, "bytes_reshard": 0})
        kclauses = staged.kclauses
        rows, pr_n = staged.emb_l.shape[1], staged.emb_r.shape[1]
        n_chunks = pr_n // r_chunk
        thetas = tuple(float(t) for t in thetas)

        # capacities local to THIS sweep: growth persists across the
        # sweep's remaining steps but never mutates the engine — a shared
        # serving engine that once hit a dense join must not over-allocate
        # every later query.  One entry: one device.
        caps = np.full(1, self.capacity or max(4096, 4 * rows), np.int64)
        timing = {"dispatch": 0.0}
        # host conversion factor from device eval *units* to (pair, clause)
        # evaluations (see _band_mask)
        unit_pairs = (self.tl * self.tr if self.use_kernel
                      else rows * r_chunk)
        io = _Transfers(self.device)
        sched = self.scheduler

        def dispatch(k) -> _InFlight:
            """Enqueue band step k at the current capacity (no host sync).
            Under a fleet scheduler the enqueue itself is the scheduling
            point: steps from concurrent queries take turns in ticket
            order."""
            cap = int(caps.max())
            t0 = time.perf_counter()
            with sched.step() if sched is not None \
                    else contextlib.nullcontext():
                col0 = k * r_chunk
                packed, evals = self._band_mask(staged, kclauses, thetas,
                                                col0, r_chunk)
                buf, cnt = extract.extract_pairs(packed, capacity=cap,
                                                 row_offset=0,
                                                 col_offset=col0)
                counts = cnt.reshape(1)
                # the 1-rank exclusive prefix sum of the counts: the base
                # the reference's hierarchical_offsets gives one device
                base = torch.cumsum(counts, 0, dtype=torch.int32) - counts
                step = io.post(k, cap, buf,
                               torch.cat([counts, base, evals.reshape(1)]))
            timing["dispatch"] += time.perf_counter() - t0
            step.t_enq = t0
            return step

        def pull_counts(step):
            """Block on step's count + eval units; returns (counts,
            pair-clause evals, bytes pulled)."""
            meta = io.wait(step)
            counts = meta[0:1].copy()
            ev = meta[2:3].copy()
            return counts, int(ev.sum()) * unit_pairs, counts.nbytes + ev.nbytes

        depth = self.effective_prefetch_depth
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
                # overflow: counts are exact true totals, so the retried
                # step — dispatched at the grown capacity — cannot
                # overflow again.  Every in-flight successor was built at
                # the stale capacity: invalidate them all and re-dispatch
                # them right after the retry, in order.
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
            bases = step.meta.numpy()[1:2].copy()
            bytes_to_host += bases.nbytes
            expect = np.cumsum(counts) - counts
            if not np.array_equal(bases, expect):
                raise RuntimeError(
                    "candidate-count prefix-sum disagrees with host "
                    f"bookkeeping: device bases {bases.tolist()} vs "
                    f"expected {expect.tolist()}")
            chunk_h2d = staged.bytes_h2d if k == 0 else 0
            # the step's first `count` buffer rows: the O(candidates) pull
            take = int(counts[0])
            if take:
                arr = io.pairs(step, take)
                bytes_to_host += arr.nbytes
                keep = (arr[:, 0] < n_l) & (arr[:, 1] < n_r)  # drop padding
                arr = arr[keep]
                pairs = list(zip(arr[:, 0].tolist(), arr[:, 1].tolist()))
            else:
                pairs = []
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
            yield ChunkDelta(pairs, bytes_to_host, chunk_h2d, 0,
                             dispatch_s=dispatch_s, pull_s=pull_s,
                             overlap_s=overlap_s,
                             conjunct_evals=conjunct_evals,
                             trace=trace, trace_events=step_events or None,
                             track=track)
            hold = time.perf_counter() - t_yield
            hold_overlap = hold if ring else 0.0
        self.last_sweep_caps = caps.copy()
