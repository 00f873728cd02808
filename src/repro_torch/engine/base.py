"""CnfEngine — the step-② evaluation-engine interface.

Step ② of FDJ (Alg 6) evaluates the featurized decomposition — a CNF with
per-clause tied thresholds (Lemma D.1 form) — over the full L×R cross
product and returns the surviving candidate pairs.  Everything downstream
(refinement, precision subsets) is O(candidates); everything upstream
(featurization) is O(n_l + n_r); this stage is the only O(n_l · n_r)
compute in the system, so it gets its own subsystem with three backends:

  * ``numpy``   — single-host blocked loop (reference semantics)
  * ``cuda``    — single-device fused CUDA kernel, packed-bitmask host
                  transfer (its plain-torch version on ``device="cpu"``)
  * ``sharded`` — the ring engine: R streamed in bands through a prefetch
                  ring with on-device candidate compaction; host traffic
                  is O(candidates)

All backends must return the *identical* candidate set for identical
inputs (guarded by tests/test_torch_engines.py).  Engines also report
``EngineStats`` so runs can compare host-transfer bytes.

Semantics contract (shared across backends, enforced here):

  * empty clause list ⇒ vacuous conjunction ⇒ every pair is a candidate;
  * distances are clipped to [0, 1]; a pair passes clause ``c`` iff the
    min distance over the clause's featurizations is <= theta[c];
  * missing values are encoded inside the feature arrays (distance 1), so
    a clause whose features are all missing only passes when theta >= 1;
  * candidates are returned as a row-major-sorted list of (i, j) tuples.

Streaming contract (DESIGN.md §3a): ``evaluate_stream`` yields
``CandidateChunk``s incrementally as the backend scans the plane — the
numpy/cuda backends emit one chunk per L-row block, the sharded backend
one chunk per R-band step.  Chunks are pairwise disjoint, each
chunk's candidates are row-major sorted *within* the chunk, and the sorted
union over all chunks is bit-identical to ``evaluate().candidates``
(``evaluate`` is literally a drain of the stream).  Downstream consumers
(core.refine.RefinementPump) may start refining a chunk while the engine
is still producing the next one.
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Iterator, Optional, Sequence

from repro_torch.obs.trace import Tracer, current_tracer

# vacuous-conjunction (empty clause list) emissions are chunked so one host
# list never materializes the whole n_l x n_r cross product: each chunk
# covers whole L rows and holds at most ~this many pairs (one row minimum)
VACUOUS_CHUNK_PAIRS = 1 << 16


def iter_cross_product_chunks(n_l: int, n_r: int):
    """Bounded row-block emission of the full n_l x n_r cross product:
    yields row-major-sorted pair lists of whole L rows, each at most
    ~VACUOUS_CHUNK_PAIRS pairs (one row minimum).  The single chunking
    policy shared by the engines' vacuous-conjunction path and the
    degenerate-plan stream in core.join — nothing for a degenerate
    extent (n_l == 0 or n_r == 0)."""
    rows_per = max(1, VACUOUS_CHUNK_PAIRS // max(n_r, 1))
    for i0 in range(0, n_l, rows_per):
        yield [(i, j) for i in range(i0, min(i0 + rows_per, n_l))
               for j in range(n_r)]


@dataclasses.dataclass
class EngineStats:
    """Per-evaluation accounting, for the engine-comparison benchmark."""
    engine: str
    n_l: int = 0
    n_r: int = 0
    n_candidates: int = 0
    wall_s: float = 0.0
    # host wall split for pipelined backends (sharded double buffering,
    # DESIGN.md §3): dispatch_wall_s is time spent enqueueing device steps
    # (async — no host sync), pull_wall_s is time blocked pulling counts/
    # bases/candidate shards and filtering padding.  overlap_s is the
    # portion of this chunk's host work (pull + consumer hold) during
    # which a *successor* step was already in flight on the device — the
    # serial loop scores exactly 0, so a pipeline silently degrading to
    # serial is visible in accounting (benchmarks/run.py gates it).
    # Whole-evaluation values are the per-chunk sums (``merged``).
    dispatch_wall_s: float = 0.0
    pull_wall_s: float = 0.0
    overlap_s: float = 0.0
    # bytes moved device -> host to recover the candidate set.  The numpy
    # backend computes on the host (0 by definition); the cuda backend
    # pulls the packed n_l×n_r/8 bitmask; the sharded backend pulls only
    # per-step counts plus the compacted (i, j) pairs.
    bytes_to_host: int = 0
    # bytes moved host -> device to stage the feature planes for this
    # evaluation.  Cold path: the full packed plane set.  Warm serving path
    # (planes already device-resident via serving.planes): 0 — the
    # invariant the FeaturePlaneStore exists to provide (DESIGN.md §4).
    bytes_h2d: int = 0
    # bytes moved device -> device to lay store-resident planes out on the
    # sharded engine's mesh.  Paid at most once per (plane set, mesh): the
    # sharded assembly is memoized, so warm serving queries report 0 (the
    # multi-pod serving invariant, DESIGN.md §4).  Always 0 for the
    # single-device backends.
    bytes_reshard: int = 0
    # (pair, clause) evaluations actually computed for this chunk — the
    # honest FLOPs proxy behind the conjunct short-circuit (DESIGN.md §3).
    # Counts padded pairs and retry re-attempts (work the device really
    # did), so an "optimization" that merely moves work elsewhere cannot
    # hide.  Full-width CNF charges n_pairs * n_clauses; early rejection
    # charges 1 clause for every tile/band whose first-conjunct popcount
    # was zero.
    conjunct_evals: int = 0

    @property
    def plane_bytes(self) -> int:
        """Size of the full boolean match plane — the O(n²) yardstick."""
        return self.n_l * self.n_r

    @property
    def flops_per_candidate(self) -> float:
        """Conjunct evaluations per surviving candidate — the step-② cost
        ratio the short-circuit is gated on (lower is better)."""
        return self.conjunct_evals / max(self.n_candidates, 1)

    def as_dict(self) -> dict:
        return {
            "engine": self.engine, "n_l": self.n_l, "n_r": self.n_r,
            "n_candidates": self.n_candidates, "wall_s": self.wall_s,
            "dispatch_wall_s": self.dispatch_wall_s,
            "pull_wall_s": self.pull_wall_s,
            "overlap_s": self.overlap_s,
            "bytes_to_host": self.bytes_to_host,
            "bytes_h2d": self.bytes_h2d,
            "bytes_reshard": self.bytes_reshard,
            "plane_bytes": self.plane_bytes,
            "conjunct_evals": self.conjunct_evals,
            "flops_per_candidate": self.flops_per_candidate,
        }

    @classmethod
    def merged(cls, deltas: Sequence["EngineStats"]) -> "EngineStats":
        """Aggregate per-chunk stat deltas into whole-evaluation stats."""
        deltas = [d for d in deltas if d is not None]
        if not deltas:
            return cls("none")
        out = cls(deltas[0].engine, n_l=deltas[0].n_l, n_r=deltas[0].n_r)
        for d in deltas:
            out.n_candidates += d.n_candidates
            out.wall_s += d.wall_s
            out.dispatch_wall_s += d.dispatch_wall_s
            out.pull_wall_s += d.pull_wall_s
            out.overlap_s += d.overlap_s
            out.bytes_to_host += d.bytes_to_host
            out.bytes_h2d += d.bytes_h2d
            out.bytes_reshard += d.bytes_reshard
            out.conjunct_evals += d.conjunct_evals
        return out


@dataclasses.dataclass
class EngineResult:
    candidates: list                   # sorted [(i, j), ...]
    stats: EngineStats


@dataclasses.dataclass
class ChunkDelta:
    """One backend emission of ``_evaluate_stream``: the chunk's pairs plus
    its per-chunk accounting.  Backends without a dispatch/pull split (the
    host-resident numpy loop, the cuda mask pull) may instead yield the
    legacy ``(pairs, bytes_to_host, bytes_h2d, bytes_reshard)`` tuple —
    ``_stream_checked`` normalizes both forms."""
    pairs: list
    bytes_to_host: int = 0
    bytes_h2d: int = 0
    bytes_reshard: int = 0
    dispatch_s: float = 0.0            # host time enqueueing device steps
    pull_s: float = 0.0                # host time pulling + filtering
    overlap_s: float = 0.0             # host work done with a step in flight
    conjunct_evals: int = 0            # (pair, clause) evals this chunk did
    # optional tracing payload (DESIGN.md §7) — backends that measure their
    # own sub-phase timestamps attach them here and ``_stream_checked``
    # turns them into child slices of the chunk's ``band_step[k]`` span.
    # ``trace`` is a list of ``{"name", "t0", "t1", "attrs"}`` dicts (perf-
    # counter seconds), ``trace_events`` a list of ``(name, ts, attrs)``
    # instants (overflow / invalidate / redispatch), ``track`` the
    # rendering lane (the sharded ring uses one lane per ring slot so
    # concurrent steps render side by side instead of mis-nesting).  All
    # three are ignored — and should stay None — when tracing is off.
    trace: Optional[list] = None
    trace_events: Optional[list] = None
    track: Optional[str] = None


@dataclasses.dataclass
class CandidateChunk:
    """One streamed emission of step ②: a disjoint slice of the candidate
    set, sorted row-major within the chunk, plus the per-chunk stats delta
    (wall seconds spent producing *this* chunk, bytes pulled for it)."""
    candidates: list                   # sorted [(i, j), ...] for this chunk
    stats: EngineStats                 # delta, not cumulative
    index: int = 0                     # chunk ordinal in emission order


class CnfEngine(abc.ABC):
    """One step-② backend.  Subclasses implement ``_evaluate_stream``."""

    name: str = "abstract"

    def evaluate(self, feats: Sequence, clauses: Sequence, thetas) -> EngineResult:
        """Batch evaluation — a thin drain of ``evaluate_stream``.

        feats: list of core.featurize.FeatureData (full corpus);
        clauses: CNF over feature indices; thetas: per-clause thresholds."""
        t0 = time.perf_counter()
        cands: list = []
        chunks = list(self.evaluate_stream(feats, clauses, thetas))
        for ch in chunks:
            cands.extend(ch.candidates)
        cands.sort()
        stats = EngineStats.merged([ch.stats for ch in chunks])
        stats.n_candidates = len(cands)
        stats.wall_s = time.perf_counter() - t0
        return EngineResult(cands, stats)

    def evaluate_stream(self, feats: Sequence, clauses: Sequence,
                        thetas) -> Iterator[CandidateChunk]:
        """Yield disjoint ``CandidateChunk``s; sorted union ≡ ``evaluate``.

        Per-chunk ``stats.wall_s`` measures engine time only: the clock
        stops while the consumer holds the chunk, so a slow consumer does
        not inflate step-② accounting."""
        # validate eagerly (this is not itself a generator): a bad call
        # raises here, at the call site, not at the consumer's first next()
        thetas = tuple(thetas)         # bind once: callers may pass iterators
        if len(clauses) != len(thetas):
            raise ValueError(
                f"{len(clauses)} clauses but {len(thetas)} thresholds")
        n_l, n_r = corpus_shape(feats, clauses)
        return self._stream_checked(feats, clauses, thetas, n_l, n_r)

    def _stream_checked(self, feats, clauses, thetas, n_l, n_r):
        # tracing (DESIGN.md §7): band_step spans are recorded
        # *retroactively* from timestamps the loop measures anyway — a span
        # held open across ``yield`` would bill consumer hold time to the
        # engine.  NULL_TRACER is falsy, so the untraced hot loop pays one
        # truthiness check per chunk and zero allocations.
        tracer = current_tracer()
        t_prev = time.perf_counter()
        if not clauses:
            # vacuous conjunction: admit everything without touching a
            # backend — emitted in bounded row-block chunks so the stream
            # (and a RefinementPump behind it) never holds one host list of
            # the whole n_l x n_r cross product on a large corpus
            idx = 0
            for cands in iter_cross_product_chunks(n_l, n_r):
                t_now = time.perf_counter()
                if tracer:
                    tracer.record_span(
                        f"band_step[{idx}]", t_prev, t_now,
                        attrs={"engine": self.name, "vacuous": True,
                               "candidates": len(cands)})
                yield CandidateChunk(
                    cands, EngineStats(self.name, n_l=n_l, n_r=n_r,
                                       n_candidates=len(cands),
                                       wall_s=t_now - t_prev),
                    idx)
                idx += 1
                t_prev = time.perf_counter()
            if idx == 0:               # degenerate extent: one empty chunk
                yield CandidateChunk(
                    [], EngineStats(self.name, n_l=n_l, n_r=n_r,
                                    wall_s=time.perf_counter() - t_prev), 0)
            return
        for idx, delta in enumerate(
                self._evaluate_stream(feats, clauses, thetas, n_l, n_r)):
            if not isinstance(delta, ChunkDelta):
                delta = ChunkDelta(*delta)
            pairs = sorted(delta.pairs)
            t_now = time.perf_counter()
            if tracer:
                self._trace_band_step(tracer, idx, delta, len(pairs),
                                      t_prev, t_now)
            yield CandidateChunk(
                pairs, EngineStats(self.name, n_l=n_l, n_r=n_r,
                                   n_candidates=len(pairs),
                                   wall_s=t_now - t_prev,
                                   dispatch_wall_s=delta.dispatch_s,
                                   pull_wall_s=delta.pull_s,
                                   overlap_s=delta.overlap_s,
                                   bytes_to_host=delta.bytes_to_host,
                                   bytes_h2d=delta.bytes_h2d,
                                   bytes_reshard=delta.bytes_reshard,
                                   conjunct_evals=delta.conjunct_evals), idx)
            t_prev = time.perf_counter()

    def _trace_band_step(self, tracer: Tracer, idx, delta, n_pairs,
                         t_prev, t_now):
        """Record one chunk's ``band_step[idx]`` span plus any backend-
        provided sub-slices (sharded dispatch/pull windows).  The step span
        opens at the earliest sub-slice start — for a prefetched ring step
        that is the *enqueue* instant, which predates ``t_prev``, so steps
        overlap in time and each rides its own ring-slot track."""
        slices = delta.trace or ()
        t0 = min([t_prev] + [s["t0"] for s in slices])
        step = tracer.record_span(
            f"band_step[{idx}]", t0, t_now, track=delta.track,
            attrs={"engine": self.name, "candidates": n_pairs,
                   "bytes_to_host": delta.bytes_to_host,
                   "conjunct_evals": delta.conjunct_evals},
            events=delta.trace_events)
        for s in slices:
            tracer.record_span(s["name"], s["t0"], s["t1"], parent=step,
                               track=delta.track, attrs=s.get("attrs"))

    @abc.abstractmethod
    def _evaluate_stream(self, feats, clauses, thetas, n_l: int, n_r: int):
        """Yields a ``ChunkDelta`` (or the legacy 4-tuple ``(pairs,
        bytes_to_host, bytes_h2d, bytes_reshard)``) per backend-defined
        chunk; chunks must be disjoint and together cover
        the exact candidate set.  ``bytes_h2d`` is the plane upload
        attributed to the chunk (backends stage planes once, so only the
        first chunk of a cold evaluation carries a nonzero value; 0
        throughout when planes are already device-resident);
        ``bytes_reshard`` likewise carries the sharded backend's one-time
        device-to-device mesh layout cost on the first chunk."""


def corpus_shape(feats: Sequence, clauses: Sequence) -> tuple:
    """(n_l, n_r) from the feature arrays; validates cross-feature agreement."""
    if not feats:
        raise ValueError("no featurizations materialized")
    shapes = {(f.data_l.shape[0], f.data_r.shape[0]) for f in feats}
    if len(shapes) != 1:
        raise ValueError(f"inconsistent corpus shapes across features: {shapes}")
    for c in clauses:
        for fi in c:
            if not 0 <= fi < len(feats):
                raise ValueError(f"clause references feature {fi}, "
                                 f"have {len(feats)}")
    return next(iter(shapes))
