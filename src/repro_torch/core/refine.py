"""RefinementPump — step ⑨ as a consumer of the step-② candidate stream.

``fdj_join`` historically barriered on the full candidate set before the
first refinement oracle call, so end-to-end latency was step-② wall time
*plus* refinement wall time.  The pump overlaps them: the caller thread
drives ``CnfEngine.evaluate_stream`` (JAX dispatch must stay on one
thread) and feeds each ``CandidateChunk`` into a *bounded* queue; a single
worker thread drains the queue and issues batched oracle calls.  The
bounded queue gives backpressure — the engine stalls rather than buffering
an unbounded candidate backlog when the oracle is the slow side.

Two refinement modes, matching core.join step ⑨:

  * ``refine_batch(pairs) -> accepted set`` — the precision-1 path: pairs
    are oracle-labeled in batches of ``batch_pairs`` as chunks land.  One
    worker thread means the caller's label cache and CostLedger need no
    locking (the producer thread never touches them during refinement).
  * ``final(sorted_pairs) -> accepted set`` — the Appx-C precision-subset
    path: the Hoeffding ladder needs distance quantiles over the *whole*
    candidate set, so chunks are only accumulated and ``final`` runs once
    at drain time.  Output is bit-identical to the barrier path by
    construction (the sorted union equals ``evaluate().candidates``).

Wall accounting (recorded into ``CostLedger`` when one is passed):
``step2_wall`` is time spent inside the engine stream, ``refine_wall``
time inside oracle refinement, ``overlap_wall`` the portion of the two
that ran concurrently — barrier mode is ``step2 + refine``; a perfectly
pipelined run approaches ``max(step2, refine)``.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from typing import Callable, Iterable, Optional

from repro_torch.engine.base import CandidateChunk, EngineStats
from repro_torch.obs.trace import current_tracer

_DONE = object()                       # queue sentinel


@dataclasses.dataclass
class PumpStats:
    step2_wall: float = 0.0            # engine time producing chunks
    refine_wall: float = 0.0           # oracle time refining them
    overlap_wall: float = 0.0          # concurrency actually achieved
    total_wall: float = 0.0            # end-to-end pump wall
    chunks: int = 0
    batches: int = 0                   # oracle call batches issued
    # engine-internal pipeline split (EngineStats sums; DESIGN.md §3): the
    # double-buffered sharded backend keeps a band step in flight while
    # the pump refines the previous chunk, so engine_overlap_s > 0 here
    # means step ② compute hid under oracle refinement as well as under
    # the engine's own host pulls.
    engine_dispatch_s: float = 0.0
    engine_pull_s: float = 0.0
    engine_overlap_s: float = 0.0
    engine_conjunct_evals: int = 0     # (pair, clause) evals step ② did
    # chunks the worker's failure handler consumed-and-discarded after its
    # refine callback died: the producer may race a few puts in before it
    # notices the failure, and silence here would look like refined work
    chunks_dropped: int = 0


@dataclasses.dataclass
class PumpResult:
    pairs: set                         # accepted (i, j)
    candidates: list                   # sorted union of all chunk candidates
    engine_stats: Optional[EngineStats]
    stats: PumpStats


class RefinementPump:
    def __init__(self, refine_batch: Optional[Callable] = None, *,
                 final: Optional[Callable] = None,
                 batch_pairs: int = 512, max_queue_chunks: int = 4):
        if (refine_batch is None) == (final is None):
            raise ValueError("exactly one of refine_batch/final is required")
        self.refine_batch = refine_batch
        self.final = final
        self.batch_pairs = int(batch_pairs)
        self.max_queue_chunks = int(max_queue_chunks)
        if self.batch_pairs <= 0 or self.max_queue_chunks <= 0:
            raise ValueError("batch_pairs and max_queue_chunks must be >= 1")
        # the stats of the most recent run(), kept observable even when
        # run() raises (a dead worker's PumpResult never materializes but
        # its chunks_dropped count still matters to the caller)
        self.last_stats: Optional[PumpStats] = None

    def run(self, chunks: Iterable[CandidateChunk],
            ledger=None) -> PumpResult:
        """Drain ``chunks`` (engine work happens in this thread's ``next``
        calls), refining concurrently; returns accepted pairs + accounting."""
        stats = PumpStats()
        self.last_stats = stats
        accepted: set = set()
        candidates: list = []
        chunk_stats: list = []
        refine_s = [0.0]               # worker-written, read after join()
        failure: list = []

        q: queue.Queue = queue.Queue(maxsize=self.max_queue_chunks)
        # tracing across the thread boundary (DESIGN.md §7): contextvars do
        # not cross threading.Thread, so the worker gets the tracer and its
        # parent span (this thread's innermost open span — the query/join
        # root) captured *here*, by closure.  Worker batches render on
        # their own "refine-pump" track: they run concurrently with
        # band_step slices and must not share a lane with them.
        tracer = current_tracer()
        pump_parent = tracer.current_span() if tracer else None
        metrics = getattr(ledger, "metrics", None)

        def worker():
            pending: list = []
            done_seen = False

            def flush(batch):
                t0 = time.perf_counter()
                accepted.update(self.refine_batch(batch))
                t1 = time.perf_counter()
                refine_s[0] += t1 - t0
                stats.batches += 1
                if tracer:
                    tracer.record_span(
                        "refine_batch", t0, t1, parent=pump_parent,
                        track="refine-pump",
                        attrs={"pairs": len(batch), "batch": stats.batches})
                if metrics is not None:
                    metrics.inc("refine.batches")
                    metrics.inc("refine.pairs", len(batch))

            try:
                while True:
                    item = q.get()
                    if metrics is not None:
                        metrics.set_gauge("refine.queue_depth", q.qsize())
                    if item is _DONE:
                        done_seen = True
                        if pending:
                            flush(pending)
                        return
                    pending.extend(item)
                    # cursor, not repeated slicing: one giant chunk (the
                    # degenerate refine-everything path) stays O(pairs)
                    start = 0
                    while len(pending) - start >= self.batch_pairs:
                        flush(pending[start: start + self.batch_pairs])
                        start += self.batch_pairs
                    if start:
                        pending = pending[start:]
            except BaseException as e:   # surface in the caller, not stderr
                failure.append(e)
                # sink mode: keep consuming until the producer's _DONE so a
                # plain blocking q.put always completes — the wakeup the
                # producer relies on — and count what worker death throws
                # away instead of discarding it silently.  (If the tail
                # flush above raised, _DONE was already consumed: don't
                # block on a queue nobody will feed again.)
                while not done_seen:
                    if q.get() is _DONE:
                        return
                    stats.chunks_dropped += 1

        t_start = time.perf_counter()
        w = None
        if self.refine_batch is not None:
            w = threading.Thread(target=worker, name="refine-pump", daemon=True)
            w.start()

        it = iter(chunks)
        try:
            while not failure:               # dead worker: stop driving step ②
                t0 = time.perf_counter()
                chunk = next(it, _DONE)
                stats.step2_wall += time.perf_counter() - t0
                if chunk is _DONE:
                    break
                stats.chunks += 1
                candidates.extend(chunk.candidates)
                chunk_stats.append(chunk.stats)
                if w is not None and chunk.candidates:
                    # plain blocking put — bounded, so it backpressures
                    # step ② when the oracle is the slow side, and safe:
                    # a dead worker's failure handler keeps consuming
                    # until _DONE, so this can never hang (and never
                    # busy-waits producer wall into step2_wall)
                    q.put(chunk.candidates)
                    if metrics is not None:
                        metrics.set_gauge("refine.queue_depth", q.qsize())
        finally:
            # the engine stream may raise mid-sweep: still shut the worker
            # down (discarding queued-but-unrefined chunks) so no thread
            # outlives run() mutating the label cache / ledger
            if w is not None:
                if sys.exc_info()[0] is not None:
                    while True:
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            break
                q.put(_DONE)
                w.join()

        if w is not None and failure:
            raise failure[0]
        candidates.sort()
        if self.final is not None:
            t0 = time.perf_counter()
            accepted = set(self.final(candidates))
            t1 = time.perf_counter()
            refine_s[0] += t1 - t0
            if tracer:
                tracer.record_span("refine_final", t0, t1,
                                   parent=pump_parent,
                                   attrs={"candidates": len(candidates)})

        stats.refine_wall = refine_s[0]
        stats.total_wall = time.perf_counter() - t_start
        stats.overlap_wall = max(
            0.0, min(stats.step2_wall, stats.refine_wall,
                     stats.step2_wall + stats.refine_wall - stats.total_wall))
        if ledger is not None:
            ledger.record_walls(stats.step2_wall, stats.refine_wall,
                                stats.overlap_wall)
        engine_stats = (EngineStats.merged(chunk_stats)
                        if any(s is not None for s in chunk_stats) else None)
        if engine_stats is not None:
            engine_stats.n_candidates = len(candidates)
            stats.engine_dispatch_s = engine_stats.dispatch_wall_s
            stats.engine_pull_s = engine_stats.pull_wall_s
            stats.engine_overlap_s = engine_stats.overlap_s
            stats.engine_conjunct_evals = engine_stats.conjunct_evals
            if ledger is not None:
                ledger.record_engine_stats(engine_stats)
        return PumpResult(pairs=accepted, candidates=candidates,
                          engine_stats=engine_stats, stats=stats)
