"""JoinService — repeated FDJ queries over a device-resident plane store,
on PyTorch.

The serving regime (ROADMAP north star) answers many join queries against
the same tables: different recall/precision targets, different engines,
re-runs as rows arrive.  A one-shot ``fdj_join`` re-pays steps ①–⑦ every
time; the service splits the pipeline at its two durable artifacts:

  * **plans** (steps ①–⑥, ``core.join.plan_join``) — cached per query
    parameters.  A repeated query skips sampling, generation, scaffolding
    and thresholding entirely; because every stage is deterministic in
    (corpus, cfg, seed), replaying a cached plan is byte-identical to a
    cold run.
  * **planes** (step ⑦) — pinned in a ``FeaturePlaneStore``.  The warm
    path charges zero extraction dollars and moves zero plane bytes to the
    device; both ``CnfEngine`` backends (and their streaming mode +
    ``RefinementPump``) are fed directly from the store via the
    ``plane_provider`` seam of ``execute_join``.  The store lives on
    ``FDJConfig.device``; the recalibration sweep runs there too.

**Delta joins.**  ``append_right(rows)`` grows R in place: resident R
planes are extended by extracting *only the appended rows* (embed planes
are row-independent; scalar planes re-normalize from stored raw values
when the whole-corpus scale statistic shifts — see planes.py).  The next
query under a cached plan then evaluates only L × ΔR through the engine
and merges candidates/accepted pairs with the cached result, which is
exactly equivalent to evaluating the full concatenated corpus under the
same plan (CNF evaluation and precision-1 refinement are per-pair
independent; tests/test_torch_serving.py proves pair equality against a
cold materialization of the grown corpus).  The Appx-C precision path
(T_P < 1) needs whole-candidate-set quantiles, so those queries fall back
to full evaluation.

Plans are carried forward across appends (the delta-join contract,
DESIGN.md §4): the recall guarantee transfers under the usual sampling
assumption that appended rows are drawn from the same distribution the
plan was calibrated on.  ``query(refresh_plan=True)`` re-plans against
the current corpus when that assumption is in doubt.

**Online recalibration (DESIGN.md §4a).**  Carrying theta forward makes
the recall guarantee a *plan-time* statement; appends that shift the
plane distributions (new rows wordier, rescaled scalars) silently void
it.  The service therefore keeps a labeled *reservoir* per cached plan —
seeded for free from the plan's own threshold sample S′ — and, on the
first query after the corpus grew, tops it up with delta-region pairs
(labeled; the only new dollars), re-runs ``adj_target`` at the grown
pair count, and checks the cached theta against the refreshed target
T′.  Reservoir distances come free from the resident planes.  If the
cached theta still meets T′ the check is all that happens — the delta
path and its eval cache survive untouched, so stable distributions keep
the cheap incremental join.  If it fails, the device threshold sweep
re-solves Eq 4 on the reservoir, theta is hot-swapped in the cached
plan, and the (now-stale) cached evaluation is dropped.  Counters
(``recalibrations``, ``theta_swaps``, ``theta_drift``,
``reservoir_cost``) land in the ``CostLedger``; gate ``recalibrate``
off in ``FDJConfig`` for the historical carry-forward behavior.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import threading
import time
import warnings
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.adj_target import adj_target
from repro_torch.core.costs import CostLedger
from repro_torch.core.featurize import distance_stack, vectorize
from repro_torch.core.join import (FDJConfig, JoinPlan, JoinResult, QueryOptions,
                             _get_engine, apply_conjunct_order, execute_join,
                             make_label_fn, needs_planes, plan_join)
from repro_torch.core.scaffold import min_fpr_thresholds, ordered_conjuncts
from repro_torch.core.refine import RefinementPump
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import current_tracer
from repro_torch.serving.planes import (FeaturePlaneStore,
                                  corpus_fingerprint)


@dataclasses.dataclass
class DeltaRows:
    """R rows to append: record texts, per-field values, and the ground
    truth pairs they add (global (i, j) indices, used for evaluation)."""
    texts: list
    fields: dict
    truth: set


def hold_out_right(ds, n_delta: int):
    """Split a dataset into a base view (R minus the last ``n_delta`` rows)
    plus the held-out ``DeltaRows`` — the benchmark/test fixture for the
    append path.  The base keeps the dataset name, so extraction
    determinism (keyed by (name, side, record index)) is preserved and
    ``base + delta`` is content-identical to the original."""
    cut = ds.n_r - n_delta
    if cut <= 0:
        raise ValueError(f"n_delta={n_delta} >= n_r={ds.n_r}")
    base = dataclasses.replace(
        ds,
        texts_r=list(ds.texts_r[:cut]),
        fields_r={k: list(v[:cut]) for k, v in ds.fields_r.items()},
        truth_set={(i, j) for (i, j) in ds.truth_set if j < cut},
        self_join=False)
    delta = DeltaRows(
        texts=list(ds.texts_r[cut:]),
        fields={k: list(v[cut:]) for k, v in ds.fields_r.items()},
        truth={(i, j) for (i, j) in ds.truth_set if j >= cut})
    return base, delta


def perturb_rows(rows: DeltaRows, *, n_tokens: int = 4,
                 seed: int = 0) -> DeltaRows:
    """Distribution-shifted copy of ``rows``: deterministic junk tokens are
    appended to every non-empty string field value (and record text).  The
    ground-truth pairs are untouched, but token-overlap and n-gram embed
    similarities between the appended rows and their true L matches drop,
    inflating clause distances — exactly the recall-threatening shift the
    delta-join contract assumes away.  The recalibration tests and the
    calibration benchmark replay this as their scripted append stream."""
    rng = np.random.default_rng(seed)

    def junk() -> str:
        return " ".join(
            "zq" + "".join(chr(97 + int(rng.integers(26))) for _ in range(6))
            for _ in range(n_tokens))

    fields = {}
    for k, vals in rows.fields.items():
        fields[k] = [v + " " + junk() if isinstance(v, str) and v else v
                     for v in vals]
    texts = [t + " " + junk() for t in rows.texts]
    return DeltaRows(texts=texts, fields=fields, truth=set(rows.truth))


@dataclasses.dataclass
class ServeResult:
    join: JoinResult               # pairs / recall / precision / ledger / stats
    plan_hit: bool                 # steps ①–⑥ served from the plan cache
    delta_rows: int                # R rows evaluated incrementally (0 = full)
    store: dict                    # this query's plane-store counter delta
    wall_s: float

    @property
    def pairs(self) -> set:
        return self.join.pairs

    @property
    def cost(self) -> CostLedger:
        return self.join.cost


@dataclasses.dataclass
class _EvalCache:
    n_r: int                       # R extent the cached evaluation covers
    candidates: list               # sorted step-② survivors at that extent
    pairs: set                     # accepted output pairs at that extent
    scales: tuple                  # per-used-spec scalar normalization at
                                   # eval time (None for embed kinds) — the
                                   # delta path is only exact while these
                                   # hold, so a shift forces re-evaluation


@dataclasses.dataclass
class _Reservoir:
    """Labeled calibration reservoir for one cached plan: a uniform pair
    sample over the L×R region it currently covers (``n_r`` marks the R
    extent), kept representative across appends by proportional top-up —
    and proportional down-sampling of the old region once ``reservoir_cap``
    binds.  Seeded for free from the plan's threshold sample S′; only the
    delta-region top-ups pay new oracle labels (``dollars``)."""
    pairs: list                    # global (i, j) pairs
    labels: np.ndarray             # (len(pairs),) bool oracle labels
    n_r: int                       # R extent the sample uniformly covers
    dollars: float = 0.0           # cumulative top-up labeling spend


def _plane_scales(planes) -> tuple:
    if planes is None:
        return ()
    return tuple(f.scale if f.kind == "scalar" else None for f in planes)


class PlanLibrary:
    """Cross-tenant plan dedup for the fleet (DESIGN.md §8a).

    ``plan_join`` is deterministic in (corpus, cfg, seed) — the basis of
    the per-service plan cache — so two tenants planning the same corpus
    under the same plan key would rebuild byte-identical plans, re-paying
    sampling, generation and threshold labeling.  The library memoizes
    plans by (fp_l, fp_r, plan key) across services sharing it: the
    second tenant's cold query charges $0 for steps ①–⑥, completing the
    shared-store story (planes dedup step ⑦; this dedups ①–⑥).

    Plans are mutable serving state (recalibration hot-swaps theta), so
    the library never shares an object: it stores a snapshot on ``put``
    and loans a deep copy on ``get`` — one tenant's theta swap can never
    bleed into another's guarantee.  LRU-bounded, lock-guarded.

    ``lease(key)`` serializes cold planning per key (the analogue of the
    store lock held through ``provide``): two tenants racing the same
    cold (corpus, plan key) plan once — the loser wakes to a library hit.
    The tenant that plans also puts the plan's planes into the store
    before it lets the lease go (``JoinService._query_impl``), so the
    loser's ``provide`` finds them resident, as in a serial run.
    """

    _MAX = 32

    def __init__(self):
        self._plans: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._leases: dict = {}        # key -> [per-key lock, holder count]
        self.hits = 0
        self.misses = 0

    @contextlib.contextmanager
    def lease(self, key: tuple):
        # refcounted so the entry dies with its last holder: a long-lived
        # fleet rotating plan keys must not accumulate one Lock per key
        # ever leased (keys cached in _plans used to pin theirs forever)
        with self._lock:
            entry = self._leases.get(key)
            if entry is None:
                lk = threading.Lock()
                entry = self._leases[key] = [lk, 0]
            else:
                lk = entry[0]
            entry[1] += 1
        try:
            with lk:
                yield
        finally:
            with self._lock:
                entry[1] -= 1
                if entry[1] == 0 and self._leases.get(key) is entry:
                    del self._leases[key]

    def get(self, key: tuple) -> Optional[JoinPlan]:
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                self.misses += 1
                return None
            self.hits += 1
            self._plans.move_to_end(key)
            return copy.deepcopy(plan)

    def put(self, key: tuple, plan: JoinPlan) -> None:
        with self._lock:
            self._plans[key] = copy.deepcopy(plan)
            self._plans.move_to_end(key)
            while len(self._plans) > self._MAX:
                self._plans.popitem(last=False)


class JoinService:
    """Serve repeated ``fdj_join`` queries against one (growing) corpus.

    Each query gets a fresh oracle/extractor and its own ``CostLedger`` —
    the store and the plan cache are the *only* cross-query memory, so the
    per-query ledger honestly reports what serving saved (a fresh
    extractor would re-charge everything the store didn't absorb).
    Ledgers accumulate into ``self.ledger``.
    """

    _EVAL_CACHE_MAX = 8            # candidate lists retained for delta joins
    _PLAN_CACHE_MAX = 16           # cached plans (LRU): a long-lived tenant
    #   with rotating configs must not leak plans + their reservoirs
    #   unboundedly

    def __init__(self, dataset, cfg: Optional[FDJConfig] = None, *,
                 store: Optional[FeaturePlaneStore] = None,
                 extractor_factory: Optional[Callable] = None,
                 proposer_factory: Optional[Callable] = None,
                 tenant: Optional[str] = None,
                 plan_library: Optional[PlanLibrary] = None,
                 oracle_factory: Optional[Callable] = None):
        from repro_torch.data.simulated_llm import (SimulatedExtractor,
                                              SimulatedProposer)
        self.dataset = dataset
        self.cfg = cfg or FDJConfig()
        self.store = store or FeaturePlaneStore(device=self.cfg.device)
        self.tenant = tenant       # fleet identity: store-ownership and
        #   fair-eviction attribution for every plane this service touches
        self._plan_library = plan_library  # cross-tenant plan dedup (fleet)
        # late-bound: append_right swaps self.dataset for the grown corpus,
        # and the default oracle must follow it (a custom factory that
        # closes over a dataset owns that tracking itself)
        self._oracle_factory = oracle_factory or \
            (lambda: self.dataset.make_oracle())
        self._extractor_factory = extractor_factory or \
            (lambda ds: SimulatedExtractor(ds, seed=self.cfg.seed))
        self._proposer_factory = proposer_factory or \
            (lambda ds: SimulatedProposer(ds))
        self._fp_l = corpus_fingerprint(dataset.name, "l", dataset.texts_l,
                                        dataset.fields_l)
        self._fp_r = corpus_fingerprint(dataset.name, "r", dataset.texts_r,
                                        dataset.fields_r)
        self._plans: dict = {}     # plan key -> JoinPlan
        self._evals: dict = {}     # plan key -> _EvalCache
        self._reservoirs: dict = {}  # plan key -> _Reservoir (calibration)
        self.ledger = CostLedger() # service-lifetime accumulation
        # service-lifetime metrics (DESIGN.md §7).  Each per-query/append
        # ledger is bound to this registry, so every flow feeds it exactly
        # once as it happens; the lifetime ledger stays UNbound — its
        # ``absorb`` would re-feed the same flows.  Invariant:
        # ``ledger_from_metrics(self.metrics) == self.ledger`` at all times
        # (tests/test_torch_obs.py pins it).
        self.metrics = MetricsRegistry()
        self.queries = 0
        self.appends = 0

    # -- internals ----------------------------------------------------------

    def _plan_key(self, cfg: FDJConfig) -> tuple:
        """Everything steps ①–⑥ depend on besides the corpus itself."""
        return (cfg.recall_target, cfg.precision_target, cfg.delta,
                cfg.gen_positives, cfg.thresh_positives, cfg.alpha, cfg.beta,
                cfg.gamma, cfg.max_iter, cfg.mc_trials, cfg.seed)

    def _provider(self, extractor) -> Callable:
        def provide(specs, ledger):
            return self.store.provide(specs, extractor, ledger,
                                      fp_l=self._fp_l, fp_r=self._fp_r,
                                      tenant=self.tenant)
        return provide

    @staticmethod
    def _coerce_options(options, legacy: dict) -> QueryOptions:
        """The one options path (DESIGN.md §8): a ``QueryOptions`` is used
        as-is; the historical kwarg surface (five special-cased kwargs +
        open-ended ``**cfg_overrides``) is a deprecation shim that routes
        through ``QueryOptions.from_legacy``."""
        legacy = {k: v for k, v in legacy.items() if v is not None}
        if options is not None:
            if legacy:
                raise TypeError(
                    f"pass either options=QueryOptions(...) or legacy "
                    f"kwargs, not both (got {sorted(legacy)})")
            return options
        if legacy:
            warnings.warn(
                "JoinService per-query kwargs are deprecated; pass "
                "options=QueryOptions(...) instead", DeprecationWarning,
                stacklevel=3)
        return QueryOptions.from_legacy(**legacy)

    # -- queries ------------------------------------------------------------

    def query(self, options: Optional[QueryOptions] = None, *,
              refresh_plan: Optional[bool] = None,
              incremental: Optional[bool] = None,
              **legacy_overrides) -> ServeResult:
        """One FDJ query against the current corpus.

        ``options`` is the typed request surface shared with
        ``JoinFleet.submit``; the keyword form is the deprecated legacy
        shim (see ``_coerce_options``).

        Warm-path invariants (tests/test_torch_serving.py): a repeated
        query reports zero extraction charges, zero plane H2D bytes, and
        returns pairs byte-identical to a cold ``fdj_join`` with the same
        config, on every engine and in stream mode.
        """
        opts = self._coerce_options(
            options, dict(legacy_overrides, refresh_plan=refresh_plan,
                          incremental=incremental))
        tracer = current_tracer()
        with tracer.span("query", n=self.queries) as sp:
            out = self._query_impl(opts)
            if tracer:
                sp.set(engine=out.join.engine_stats.engine
                       if out.join.engine_stats else "none",
                       plan_hit=out.plan_hit, delta_rows=out.delta_rows,
                       candidates=out.join.candidate_count)
        self.metrics.inc("serve.plan_hits" if out.plan_hit
                         else "serve.plan_misses")
        self.metrics.observe("serve.query_wall_s", out.wall_s)
        return out

    def _query_impl(self, opts: QueryOptions) -> ServeResult:
        t0 = time.perf_counter()
        refresh_plan, incremental = opts.refresh_plan, opts.incremental
        cfg = opts.resolve(self.cfg)

        qledger = CostLedger()
        qledger.bind_metrics(self.metrics)   # flows feed once, as they happen
        oracle = self._oracle_factory()
        oracle.ledger = qledger
        label = make_label_fn(oracle, {})
        extractor = self._extractor_factory(self.dataset)
        snap0 = self.store.snapshot()

        # capture the plane set execute/delta consumed: the eval cache must
        # remember the scalar normalizations its candidates were computed
        # under (the delta path is only exact while those hold)
        raw_provider = self._provider(extractor)
        captured: dict = {}

        def provider(specs, led):
            # one provide() per query: a delta-path fallback re-enters via
            # execute_join, which must reuse the already-provided planes
            # rather than re-counting store hits
            if "planes" not in captured:
                captured["planes"] = raw_provider(specs, led)
            return captured["planes"]

        key = self._plan_key(cfg)
        plan = self._plans.get(key)
        plan_hit = plan is not None and not refresh_plan
        if plan_hit:
            self._plans.pop(key)            # LRU: hit refreshes recency
            self._plans[key] = plan
        else:
            lib = self._plan_library
            lib_key = (self._fp_l, self._fp_r, key)

            def build():
                return plan_join(self.dataset, oracle,
                                 self._proposer_factory(self.dataset),
                                 extractor, cfg, ledger=qledger, label=label)

            if lib is not None:
                # cross-tenant dedup: a sibling service already planned
                # this exact (corpus, plan key) — determinism makes the
                # loaned copy byte-identical to planning it here.  The
                # lease serializes racing colds, so the loser wakes to a
                # hit instead of planning the same thing twice.  The
                # planner provides its planes before it lets the lease
                # go: its extractor already paid planning's first-touch
                # records, and a loser that built the planes first, with a
                # fresh extractor, would pay those records again.
                with lib.lease(lib_key):
                    plan = None if refresh_plan else lib.get(lib_key)
                    plan_hit = plan is not None
                    if plan is None:
                        plan = build()
                        lib.put(lib_key, plan)
                        if needs_planes(plan, cfg):
                            with current_tracer().span(
                                    "extract", specs=len(plan.used_specs)):
                                provider(plan.used_specs, qledger)
            else:
                plan = build()
            self._plans.pop(key, None)
            self._plans[key] = plan
            self._evals.pop(key, None)      # plan rebuilt: stale evaluation
            self._reservoirs.pop(key, None)
            if plan.calib_pairs is not None:
                # seed the calibration reservoir from the plan's own labeled
                # threshold sample — step ④ already paid for these labels
                self._reservoirs[key] = _Reservoir(
                    pairs=list(plan.calib_pairs),
                    labels=np.asarray(plan.calib_labels, bool).copy(),
                    n_r=self.dataset.n_r)
            while len(self._plans) > self._PLAN_CACHE_MAX:
                # bounded: a tenant rotating configs
                # must not pin plans + reservoirs + eval caches forever.
                # Evicting a plan drops its dependents — they are keyed by
                # it and unreachable once it is gone.
                old = next(iter(self._plans))
                self._plans.pop(old)
                self._evals.pop(old, None)
                self._reservoirs.pop(old, None)

        # online guarantee recalibration (DESIGN.md §4a): before the plan is
        # replayed over a grown corpus, check its theta against a refreshed
        # reservoir + adjusted target, hot-swapping when the invariant broke.
        # Must run before the delta path — a swap invalidates the cached
        # evaluation (its candidates were produced under the old theta).
        res = self._reservoirs.get(key)
        if (cfg.recalibrate and plan_hit and not plan.degenerate
                and res is not None and res.n_r < self.dataset.n_r):
            with current_tracer().span("recalibrate",
                                       reservoir=len(res.pairs)):
                self._recalibrate(cfg, key, plan, res, label, provider,
                                  qledger)

        cached = self._evals.get(key)
        n_r = self.dataset.n_r
        delta_rows = 0
        jr = None
        if (incremental and cached is not None and cached.n_r < n_r
                and cfg.precision_target >= 1.0):
            jr = self._delta_execute(cfg, plan, cached, label, provider,
                                     qledger)
            if jr is not None:
                delta_rows = n_r - cached.n_r
        if jr is None:
            # degenerate plans skip candidate retention: the delta path
            # regenerates the cross product directly, so caching O(n_l·n_r)
            # tuples would pin memory for nothing
            jr = execute_join(self.dataset, oracle, extractor, cfg, plan,
                              plane_provider=provider, ledger=qledger,
                              label=label,
                              keep_candidates=not plan.degenerate)
        self._evals.pop(key, None)           # re-insert at MRU position
        self._evals[key] = _EvalCache(n_r, jr.candidates, set(jr.pairs),
                                      _plane_scales(captured.get("planes")))
        while len(self._evals) > self._EVAL_CACHE_MAX:
            # bounded: each cache pins a full candidate list; dropping one
            # only costs the next query under that plan a full evaluation
            self._evals.pop(next(iter(self._evals)))

        diff = FeaturePlaneStore.delta(snap0, self.store.snapshot())
        qledger.record_plane_traffic(
            hits=diff["hits"], misses=diff["misses"],
            dedup_hits=diff["dedup_hits"],
            evicted_bytes=diff["evicted_bytes"],
            resident_bytes=diff["resident_bytes"],
            bytes_h2d=diff["bytes_to_device"]
            + (jr.engine_stats.bytes_h2d if jr.engine_stats else 0),
            bytes_reshard=(jr.engine_stats.bytes_reshard
                           if jr.engine_stats else 0))
        self.ledger.absorb(qledger)
        self.queries += 1
        return ServeResult(join=jr, plan_hit=plan_hit, delta_rows=delta_rows,
                           store=diff, wall_s=time.perf_counter() - t0)

    def _recalibrate(self, cfg: FDJConfig, key: tuple, plan: JoinPlan,
                     res: _Reservoir, label, provider,
                     qledger: CostLedger) -> None:
        """Refresh the plan's calibration reservoir to the grown corpus and
        re-establish the recall invariant (DESIGN.md §4a).

        1. Top up the reservoir with uniform delta-region pairs, sized
           proportionally to the appended area so the sample stays uniform
           over the grown L×R (down-sampling the old region once
           ``reservoir_cap`` binds).  Labels are the only new dollars.
        2. Re-run ``adj_target`` at the grown pair count -> refreshed T′.
        3. Check the cached theta's recall on the reservoir (distances are
           free — they come from the already-resident planes, under the
           *current* normalization, so scalar rescales are seen too).
        4. Only if the invariant broke: re-solve Eq 4 via the device sweep,
           hot-swap theta/T′ in the cached plan, and drop the cached
           evaluation (its candidates predate the swap).
        """
        n_l, n_r = self.dataset.n_l, self.dataset.n_r
        off = res.n_r
        rng = np.random.default_rng([abs(cfg.seed), off, n_r])
        old_area = n_l * off
        delta_area = n_l * (n_r - off)
        # --- 1. proportional top-up ---------------------------------------
        n_new = int(math.ceil(len(res.pairs) * delta_area / max(old_area, 1)))
        cap = max(int(cfg.reservoir_cap), 1)
        if len(res.pairs) + n_new > cap:
            frac_old = old_area / max(old_area + delta_area, 1)
            n_keep = min(max(int(round(cap * frac_old)), 1), len(res.pairs))
            n_new = max(cap - n_keep, 0)
            keep = np.sort(rng.choice(len(res.pairs), size=n_keep,
                                      replace=False))
            res.pairs = [res.pairs[i] for i in keep]
            res.labels = res.labels[keep]
        n_new = min(n_new, delta_area)
        spent0 = qledger.labeling
        if n_new > 0:
            width = n_r - off
            flat = rng.choice(delta_area, size=n_new, replace=False)
            new_pairs = [(int(t // width), off + int(t % width))
                         for t in flat]
            new_labels = label(new_pairs, "labeling")
            res.pairs = res.pairs + new_pairs
            res.labels = np.concatenate([res.labels,
                                         np.asarray(new_labels, bool)])
        res.n_r = n_r
        dollars = qledger.labeling - spent0
        res.dollars += dollars

        # --- 2. refreshed adjusted target ---------------------------------
        k_plus = int(res.labels.sum())
        if k_plus == 0:
            # no positives to calibrate against: record the check and keep
            # the cached theta (nothing sounder is computable from here)
            qledger.record_recalibration(swapped=False, drift=0.0,
                                         dollars=dollars)
            return
        delta_recall = cfg.delta if cfg.precision_target >= 1.0 \
            else cfg.delta / 2.0
        adj = adj_target(k_plus, plan.sc_local.n_clauses, cfg.recall_target,
                         delta_recall, n_pairs=n_l * n_r,
                         k_sample=len(res.pairs), n_trials=cfg.mc_trials,
                         seed=cfg.seed)

        # --- 3. invariant check on free plane distances -------------------
        planes = provider(plan.used_specs, qledger)
        cd = plan.sc_local.clause_distances(
            distance_stack(list(planes), res.pairs))
        sel = np.all(cd <= plan.theta[None, :], axis=1)
        recall = float((sel & res.labels).sum()) / k_plus
        if recall >= adj.t_prime - 1e-12:
            plan.t_prime = adj.t_prime
            qledger.record_recalibration(swapped=False, drift=0.0,
                                         dollars=dollars)
            return

        # --- 4. re-sweep + hot-swap ---------------------------------------
        with current_tracer().span("theta_swap") as sp:
            thr = min_fpr_thresholds(cd, res.labels, adj.t_prime,
                                     method="auto", device=cfg.device)
            old_theta = np.asarray(plan.theta, float)
            drift = float(np.max(np.abs(thr.theta - old_theta))) \
                if thr.theta.shape == old_theta.shape else float("inf")
            plan.theta = thr.theta
            plan.t_prime = adj.t_prime
            plan.feasible = thr.feasible
            # new thresholds move per-conjunct pass rates: refresh the
            # cached plan's evaluation order from the same reservoir
            # distances (free — cd is already in hand; candidate set
            # invariant either way)
            plan.conjunct_order = ordered_conjuncts(cd, thr.theta,
                                                    plan.sc_local.clauses)
            self._evals.pop(key, None)      # candidates predate the swap
            sp.set(drift=drift, t_prime=adj.t_prime)
        qledger.record_recalibration(swapped=True, drift=drift,
                                     dollars=dollars)

    def _delta_execute(self, cfg: FDJConfig, plan: JoinPlan,
                       cached: _EvalCache, label, provider,
                       qledger: CostLedger) -> Optional[JoinResult]:
        """Evaluate only L × ΔR under the cached plan and merge.

        Exactness: the CNF decides each pair independently and precision-1
        refinement is a per-pair oracle call, so (cached result on R[:off])
        ∪ (this evaluation on R[off:]) equals a full evaluation of the
        grown corpus under the same plan, pair for pair — PROVIDED the
        plane normalizations the cached candidates were computed under
        still hold.  A scalar plane whose whole-corpus scale shifted (a
        rescaling append, or a plane that was evicted and re-extracted on
        the grown corpus) changes distances for the *old* rows too, so
        this returns None and the caller re-evaluates in full.
        """
        off = cached.n_r
        n_l, n_r = self.dataset.n_l, self.dataset.n_r
        engine_stats = None
        if plan.degenerate:
            # refine-everything over L × ΔR, labeled in bounded row blocks
            # (the same chunking policy as core.join's barrier fallback —
            # never one O(n_l·Δn_r) host list)
            from repro_torch.engine.base import iter_cross_product_chunks
            t0 = time.perf_counter()
            accepted = set()
            for block in iter_cross_product_chunks(n_l, n_r - off):
                block = [(i, j + off) for (i, j) in block]
                labs = label(block, "refinement")
                accepted |= {p for p, l in zip(block, labs) if l}
            qledger.record_walls(0.0, time.perf_counter() - t0, 0.0)
        else:
            planes = provider(plan.used_specs, qledger)
            if _plane_scales(planes) != cached.scales:
                return None          # normalization shifted: delta inexact
            sub = planes.slice_r(off)
            eng = _get_engine(cfg)
            # the delta join evaluates under the cached plan's measured
            # conjunct order — same permutation the full evaluation used,
            # so the merge stays bit-exact (order never changes the set)
            d_clauses, d_theta = apply_conjunct_order(
                plan.sc_local.clauses, plan.theta,
                plan.conjunct_order if cfg.order_conjuncts else None)
            if cfg.stream_refinement:
                def shifted(chunks):
                    for ch in chunks:
                        ch.candidates = [(i, j + off)
                                         for (i, j) in ch.candidates]
                        yield ch

                def refine_chunk(batch):
                    labs = label(batch, "refinement")
                    return {p for p, l in zip(batch, labs) if l}

                pump = RefinementPump(refine_chunk,
                                      batch_pairs=cfg.refine_batch_pairs,
                                      max_queue_chunks=cfg.pump_queue_chunks)
                pr = pump.run(shifted(eng.evaluate_stream(
                    sub, d_clauses, d_theta)), ledger=qledger)
                delta_cands = pr.candidates
                accepted = pr.pairs
                engine_stats = pr.engine_stats
            else:
                res = eng.evaluate(sub, d_clauses, d_theta)
                delta_cands = [(i, j + off) for (i, j) in res.candidates]
                engine_stats = res.stats
                t0 = time.perf_counter()
                labs = label(delta_cands, "refinement")
                accepted = {p for p, l in zip(delta_cands, labs) if l}
                qledger.record_walls(res.stats.wall_s,
                                     time.perf_counter() - t0, 0.0)
                qledger.record_engine_stats(engine_stats)

        out_pairs = set(cached.pairs) | accepted
        if plan.degenerate:
            # candidates are definitionally the full cross product: count
            # without retaining O(n_l·n_r) tuples in the cache
            candidates, n_cands = None, n_l * n_r
        else:
            candidates = sorted(cached.candidates + list(delta_cands))
            n_cands = len(candidates)
        truth = self.dataset.truth_set
        tp = len(out_pairs & truth)
        recall = tp / max(len(truth), 1)
        precision = tp / max(len(out_pairs), 1) if out_pairs else 1.0
        return JoinResult(
            pairs=out_pairs, recall=recall, precision=precision,
            cost=qledger, scaffold=plan.scaffold, specs=plan.specs,
            theta=plan.theta, t_prime=plan.t_prime,
            candidate_count=n_cands,
            met_target=(recall >= cfg.recall_target - 1e-12
                        and precision >= cfg.precision_target - 1e-12),
            engine_stats=engine_stats, candidates=candidates)

    # -- appends ------------------------------------------------------------

    def append_right(self, rows: DeltaRows,
                     options: Optional[QueryOptions] = None) -> dict:
        """Append R rows, extending resident R planes by the delta only.

        ``options`` is accepted for call-shape parity with ``query`` and
        ``JoinFleet.submit`` (scripted drivers carry one request type); an
        append itself is config-independent, so the options are validated
        against the base config and otherwise unused.

        Returns the append's ledger + store counter delta.  Cached plans
        and cached evaluations survive — the next query under a cached
        plan joins only L × ΔR (see ``_delta_execute``).

        "Delta only" is a statement about the expensive resources —
        extraction charges and bytes to device scale with ΔR.  Host-side
        bookkeeping (re-fingerprinting the grown side, list copies, and
        the simulated extractor's per-side value pass) is still O(n_r)
        per append; chaining the fingerprint incrementally and slicing the
        extraction simulation are follow-ups if appends ever dominate.
        """
        if options is not None:
            options.resolve(self.cfg)   # reject unknown override fields
        ds = self.dataset
        off = ds.n_r
        new_texts = list(ds.texts_r) + list(rows.texts)
        new_fields = {k: list(v) + list(rows.fields[k])
                      for k, v in ds.fields_r.items()}
        new_truth = set(ds.truth_set) | set(rows.truth)
        self.dataset = dataclasses.replace(
            ds, texts_r=new_texts, fields_r=new_fields, truth_set=new_truth,
            self_join=False)
        old_fp = self._fp_r
        self._fp_r = corpus_fingerprint(ds.name, "r", new_texts, new_fields)

        aledger = CostLedger()
        aledger.bind_metrics(self.metrics)   # same once-per-flow feed as query
        extractor = self._extractor_factory(self.dataset)
        embedder = getattr(extractor, "_embedder", None)
        snap0 = self.store.snapshot()
        n_new = len(new_texts)
        for entry in self.store.entries_for("r", old_fp):
            spec = entry.spec
            delta_vals = extractor.extract_values(
                spec, "r", aledger, idx=np.arange(off, n_new))
            vals = list(entry.values) + list(delta_vals)
            # retire the old-fingerprint entry *before* pinning the grown
            # one: no transient double residency to trip byte-budget
            # eviction of live planes
            self.store.drop(spec, "r", old_fp, superseded=True)
            if entry.kind == "embed":
                dfd = vectorize(spec, [], delta_vals, embedder)
                host = np.concatenate([entry.host, dfd.data_r], axis=0)
                dev = torch.cat([entry.device, torch.from_numpy(
                    dfd.data_r).to(self.store.device)], dim=0)
                self.store.charge_upload(dfd.data_r.nbytes)
                self.store.put(spec, "r", self._fp_r, vals, host,
                               "embed", entry.scale, device=dev,
                               tenant=self.tenant)
            else:
                # scalar planes: the p95–p5 scale is a whole-corpus
                # statistic — recompute from raw values so the result is
                # byte-identical to a cold materialization of the grown
                # corpus.  Unchanged scale ⇒ append-only upload; shifted
                # scale ⇒ both (4-byte/row) sides re-pinned.
                l_entry = self.store.peek(spec, "l", self._fp_l)
                vals_l = l_entry.values if l_entry is not None else \
                    extractor.extract_values(spec, "l", aledger)
                fd = vectorize(spec, vals_l, vals, embedder)
                if l_entry is not None and fd.scale == l_entry.scale:
                    delta_host = fd.data_r[off:]
                    host = np.concatenate([entry.host, delta_host])
                    dev = torch.cat([entry.device, torch.from_numpy(
                        delta_host).to(self.store.device)])
                    self.store.charge_upload(delta_host.nbytes)
                    self.store.put(spec, "r", self._fp_r, vals, host,
                                   "scalar", fd.scale, device=dev,
                                   tenant=self.tenant)
                else:
                    self.store.put(spec, "r", self._fp_r, vals, fd.data_r,
                                   "scalar", fd.scale, tenant=self.tenant)
                    self.store.put(spec, "l", self._fp_l, vals_l, fd.data_l,
                                   "scalar", fd.scale, tenant=self.tenant)

        diff = FeaturePlaneStore.delta(snap0, self.store.snapshot())
        aledger.record_plane_traffic(
            hits=diff["hits"], misses=diff["misses"],
            dedup_hits=diff["dedup_hits"],
            evicted_bytes=diff["evicted_bytes"],
            resident_bytes=diff["resident_bytes"],
            bytes_h2d=diff["bytes_to_device"])
        self.ledger.absorb(aledger)
        self.appends += 1
        return {"rows": len(rows.texts), "ledger": aledger, "store": diff}
