"""Monetary cost accounting (paper §8.1 methodology).

Every oracle/extraction/embedding invocation is *simulated* against ground
truth, but its cost is charged as if the real prompt had been sent: tokens
are counted from the prompt string that would have been constructed, priced
with the per-model $/Mtok constants below (GPT-4.1-class join/extraction LLM,
o3-class featurization-generation LLM, text-embedding-3-large-class E).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# $ per 1M tokens (input, output) — OpenAI list prices (2025)
PRICE_JOIN_LLM_IN = 2.00       # GPT-4.1 input
PRICE_JOIN_LLM_OUT = 8.00      # GPT-4.1 output
PRICE_GEN_LLM_IN = 2.00        # o3 input
PRICE_GEN_LLM_OUT = 8.00       # o3 output
PRICE_EMBED = 0.13             # text-embedding-3-large

CHARS_PER_TOKEN = 4.0          # standard approximation


def n_tokens(text: str) -> int:
    return max(1, int(len(text) / CHARS_PER_TOKEN))


# CostLedger field -> canonical metric name (DESIGN.md §7).  Every *flow*
# field (charges, walls, counts) accumulates through ``_flow`` so a bound
# MetricsRegistry sees each delta as it happens; ``ledger_from_metrics``
# inverts the mapping, and tests pin the round trip — the ledger and the
# registry are two views of one record, never two records.
FIELD_METRICS = {
    "labeling": "cost.labeling_usd",
    "construction": "cost.construction_usd",
    "inference": "cost.inference_usd",
    "refinement": "cost.refinement_usd",
    "step2_wall": "wall.step2_s",
    "refine_wall": "wall.refine_s",
    "overlap_wall": "wall.overlap_s",
    "step2_dispatch_wall": "wall.step2_dispatch_s",
    "step2_pull_wall": "wall.step2_pull_s",
    "step2_overlap_wall": "wall.step2_overlap_s",
    "step2_conjunct_evals": "engine.conjunct_evals",
    "plane_hits": "planes.hits",
    "plane_misses": "planes.misses",
    "plane_dedup_hits": "planes.dedup_hits",
    "plane_evicted_bytes": "planes.evicted_bytes",
    "bytes_h2d": "planes.bytes_h2d",
    "bytes_reshard": "planes.bytes_reshard",
    "recalibrations": "calib.recalibrations",
    "theta_swaps": "calib.theta_swaps",
    "theta_drift": "calib.theta_drift",
    "reservoir_cost": "calib.reservoir_usd",
}
# plane_resident_bytes is a *level*, not a flow: it maps to a gauge
GAUGE_METRICS = {"plane_resident_bytes": "planes.resident_bytes"}


@dataclasses.dataclass
class CostLedger:
    """Accumulates costs by category (paper Fig 9 breakdown)."""
    labeling: float = 0.0        # LLM labels for sampled pairs
    construction: float = 0.0    # featurization-generation LLM calls
    inference: float = 0.0       # feature extraction + embeddings
    refinement: float = 0.0      # LLM on predicted-positive pairs
    # wall-clock accounting for the step-②/⑨ pipeline (DESIGN.md §3a):
    # seconds, not dollars — reported via wall_summary(), kept out of the
    # monetary breakdown().  overlap_wall > 0 only when stream_refinement
    # actually ran refinement concurrently with candidate production.
    step2_wall: float = 0.0      # candidate production (engine stream)
    refine_wall: float = 0.0     # oracle refinement
    overlap_wall: float = 0.0    # portion of the two that ran concurrently
    # engine-internal pipeline split (sharded double buffering, DESIGN.md
    # §3): host time enqueueing device steps vs blocked pulling/filtering,
    # and the host work that ran with a successor step in flight.
    # step2_overlap_wall == 0 on the sharded engine means the band loop
    # degraded to serial — the regression the benchmark gate watches.
    step2_dispatch_wall: float = 0.0
    step2_pull_wall: float = 0.0
    step2_overlap_wall: float = 0.0
    # (pair, clause) evaluations step ② actually computed (the conjunct
    # short-circuit's honest FLOPs proxy — EngineStats.conjunct_evals,
    # including padding and overflow-retry re-work).  A count, not
    # dollars; reported via wall_summary(), kept out of breakdown().
    step2_conjunct_evals: int = 0
    # serving counters (DESIGN.md §4): plane-store traffic for this query.
    # Counts, not dollars — the whole point of the store is that a plane
    # hit costs $0; reported via serving_summary(), kept out of total.
    plane_hits: int = 0          # (spec, side) planes served device-resident
    plane_misses: int = 0        # planes that had to be extracted + uploaded
    plane_dedup_hits: int = 0    # hits on planes another tenant materialized
                                 # (shared-store fleet: the $0 dedup proof)
    plane_evicted_bytes: int = 0 # device bytes freed by LRU eviction
    plane_resident_bytes: int = 0  # device bytes pinned after the query
    bytes_h2d: int = 0           # host->device plane bytes actually moved
    bytes_reshard: int = 0       # device->device bytes laying planes out on
                                 # the sharded engine's mesh (warm: 0)
    # online guarantee calibration (DESIGN.md §4a): serving-time reservoir
    # recalibration of cached plans.  ``reservoir_cost`` dollars are ALSO
    # counted inside ``labeling`` (they are oracle labels) — this field
    # exists so the serving benchmark can report what keeping the guarantee
    # live costs, separately from plan-time sampling.
    recalibrations: int = 0      # reservoir-refresh + invariant checks run
    theta_swaps: int = 0         # recalibrations that hot-swapped theta
    theta_drift: float = 0.0     # summed L-inf theta movement across swaps
    reservoir_cost: float = 0.0  # labeling dollars spent refreshing reservoirs
    # observability binding (DESIGN.md §7): when set, every flow mutation
    # also feeds the equivalent metric (FIELD_METRICS) as it happens, so
    # the registry is always reconcilable with the ledger.  Bookkeeping,
    # not a charge: excluded from equality/repr.
    metrics: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)
    # True once record_plane_traffic actually ran on this ledger: the
    # resident-bytes *level* is only meaningful then, and ``absorb`` must
    # not let a ledger that never touched the plane store clobber it
    plane_level_set: bool = dataclasses.field(
        default=False, compare=False, repr=False)

    def _flow(self, field: str, v) -> None:
        """Accumulate a flow field, feeding the bound metric if any."""
        if not v:
            return
        setattr(self, field, getattr(self, field) + v)
        if self.metrics is not None:
            self.metrics.inc(FIELD_METRICS[field], v)

    def _set_resident(self, resident_bytes: int) -> None:
        self.plane_resident_bytes = int(resident_bytes)
        self.plane_level_set = True
        if self.metrics is not None:
            self.metrics.set_gauge(GAUGE_METRICS["plane_resident_bytes"],
                                   self.plane_resident_bytes)

    def bind_metrics(self, registry) -> None:
        """Attach a MetricsRegistry: future mutations stream into it, and
        the ledger's current state is published up front so a mid-life
        binding starts reconciled."""
        self.metrics = registry
        for field, metric in FIELD_METRICS.items():
            v = getattr(self, field)
            if v:
                registry.inc(metric, v)
        if self.plane_level_set:
            registry.set_gauge(GAUGE_METRICS["plane_resident_bytes"],
                               self.plane_resident_bytes)

    def charge_label(self, prompt_tokens: int, output_tokens: int = 1):
        self._flow("labeling", (prompt_tokens * PRICE_JOIN_LLM_IN
                                + output_tokens * PRICE_JOIN_LLM_OUT) / 1e6)

    def charge_refine(self, prompt_tokens: int, output_tokens: int = 1):
        self._flow("refinement", (prompt_tokens * PRICE_JOIN_LLM_IN
                                  + output_tokens * PRICE_JOIN_LLM_OUT) / 1e6)

    def charge_generation(self, prompt_tokens: int, output_tokens: int):
        self._flow("construction", (prompt_tokens * PRICE_GEN_LLM_IN
                                    + output_tokens * PRICE_GEN_LLM_OUT) / 1e6)

    def charge_extraction(self, prompt_tokens: int, output_tokens: int):
        self._flow("inference", (prompt_tokens * PRICE_JOIN_LLM_IN
                                 + output_tokens * PRICE_JOIN_LLM_OUT) / 1e6)

    def charge_embedding(self, tokens: int):
        self._flow("inference", tokens * PRICE_EMBED / 1e6)

    def record_walls(self, step2: float, refine: float, overlap: float):
        self._flow("step2_wall", step2)
        self._flow("refine_wall", refine)
        self._flow("overlap_wall", overlap)

    def record_engine_walls(self, dispatch: float, pull: float,
                            overlap: float):
        """Accumulate the engine-internal dispatch/pull/overlap split
        (``EngineStats.dispatch_wall_s`` etc. of one evaluation)."""
        self._flow("step2_dispatch_wall", dispatch)
        self._flow("step2_pull_wall", pull)
        self._flow("step2_overlap_wall", overlap)

    def record_engine_stats(self, stats) -> None:
        """Convenience: record an ``EngineStats``'s pipeline walls (no-op
        for None, e.g. the degenerate-plan path)."""
        if stats is not None:
            self.record_engine_walls(stats.dispatch_wall_s,
                                     stats.pull_wall_s, stats.overlap_s)
            self._flow("step2_conjunct_evals", int(stats.conjunct_evals))

    def record_plane_traffic(self, *, hits: int = 0, misses: int = 0,
                             evicted_bytes: int = 0, resident_bytes: int = 0,
                             bytes_h2d: int = 0, bytes_reshard: int = 0,
                             dedup_hits: int = 0):
        """Accumulate plane-store counters (resident_bytes is a level, not a
        flow: callers pass the store's current value and it overwrites)."""
        self._flow("plane_hits", int(hits))
        self._flow("plane_misses", int(misses))
        self._flow("plane_dedup_hits", int(dedup_hits))
        self._flow("plane_evicted_bytes", int(evicted_bytes))
        self._set_resident(resident_bytes)
        self._flow("bytes_h2d", int(bytes_h2d))
        self._flow("bytes_reshard", int(bytes_reshard))

    def record_recalibration(self, *, swapped: bool, drift: float,
                             dollars: float) -> None:
        """One serving-time guarantee recalibration: an invariant check on
        the refreshed reservoir, plus (when the cached theta failed it) a
        device re-sweep that hot-swapped the plan's thresholds."""
        self._flow("recalibrations", 1)
        self._flow("theta_swaps", int(swapped))
        self._flow("theta_drift", float(drift))
        self._flow("reservoir_cost", float(dollars))

    def absorb(self, other: "CostLedger") -> None:
        """Merge another ledger's charges in (serving: per-query ledgers
        accumulate into the service-lifetime ledger).  Flows add; the
        resident-bytes *level* only transfers when the absorbed ledger
        actually recorded plane traffic — a query that never touched the
        store (degenerate plan, storeless execute) must not zero the
        service-lifetime residency."""
        for field in FIELD_METRICS:
            self._flow(field, getattr(other, field))
        if other.plane_level_set:
            self._set_resident(other.plane_resident_bytes)

    def serving_summary(self) -> dict:
        """Plane-store counters for the Fig-9 breakdown / serving benchmark."""
        return {
            "plane_hits": self.plane_hits,
            "plane_misses": self.plane_misses,
            "plane_dedup_hits": self.plane_dedup_hits,
            "plane_evicted_bytes": self.plane_evicted_bytes,
            "plane_resident_bytes": self.plane_resident_bytes,
            "bytes_h2d": self.bytes_h2d,
            "bytes_reshard": self.bytes_reshard,
            "recalibrations": self.recalibrations,
            "theta_swaps": self.theta_swaps,
            "theta_drift": self.theta_drift,
            "reservoir_cost": self.reservoir_cost,
        }

    def wall_summary(self) -> dict:
        """Pipeline wall seconds; pipelined_wall is the effective critical
        path (step2 + refine - overlap) the streaming pump achieves."""
        return {
            "step2_wall": self.step2_wall,
            "refine_wall": self.refine_wall,
            "overlap_wall": self.overlap_wall,
            "pipelined_wall": self.step2_wall + self.refine_wall
            - self.overlap_wall,
            "step2_dispatch_wall": self.step2_dispatch_wall,
            "step2_pull_wall": self.step2_pull_wall,
            "step2_overlap_wall": self.step2_overlap_wall,
            "step2_conjunct_evals": self.step2_conjunct_evals,
        }

    @property
    def total(self) -> float:
        return self.labeling + self.construction + self.inference + self.refinement

    def breakdown(self) -> dict:
        return {
            "labeling": self.labeling,
            "construction": self.construction,
            "inference": self.inference,
            "refinement": self.refinement,
            "total": self.total,
        }


_INT_FIELDS = {f.name for f in dataclasses.fields(CostLedger)
               if f.type == "int"}


def ledger_from_metrics(registry) -> CostLedger:
    """Reconstruct a CostLedger from a bound MetricsRegistry — the
    derivability invariant of DESIGN.md §7: for any ledger with
    ``bind_metrics(fresh_registry)``, ``ledger_from_metrics(registry) ==
    ledger`` (tests/test_obs.py pins it).  A registry shared by several
    ledgers derives their absorbed sum."""
    out = CostLedger()
    for field, metric in FIELD_METRICS.items():
        v = registry.value(metric)
        setattr(out, field, int(v) if field in _INT_FIELDS else v)
    gauge = GAUGE_METRICS["plane_resident_bytes"]
    if registry.has(gauge):
        out.plane_resident_bytes = int(registry.value(gauge))
        out.plane_level_set = True
    return out


def naive_join_cost(texts_l, texts_r, join_prompt_overhead_tokens: int = 40) -> float:
    """Cost of the naive all-pairs LLM join (cost-ratio denominator)."""
    tl = [n_tokens(t) for t in texts_l]
    tr = [n_tokens(t) for t in texts_r]
    total_in = sum(tl) * len(tr) + sum(tr) * len(tl) \
        + join_prompt_overhead_tokens * len(tl) * len(tr)
    total_out = len(tl) * len(tr)
    return (total_in * PRICE_JOIN_LLM_IN + total_out * PRICE_JOIN_LLM_OUT) / 1e6
