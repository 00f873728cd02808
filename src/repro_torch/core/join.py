"""FDJ — the final algorithm (Alg 6) plus the precision extension (Appx C),
on PyTorch.

``fdj_join`` wires the full pipeline:
  1. uniform sample S, oracle labels          (cost: labeling)
  2. candidate featurizations (Alg 1-3)       (cost: construction+inference)
  3. logical scaffold (Alg 4) on S
  4. second sample S', labels                 (cost: labeling)
  5. T' = adj-target(k+, r, T, δ·)            (offline MC, cached)
  6. Θ* = argmin FPR s.t. recall_{S'} >= T'   (Eq 4)
  7. full-corpus extraction for used featurizations (cost: inference)
  8. blocked CNF evaluation over L×R -> Ŷ     (repro_torch.engine backend)
  9. refinement: oracle on Ŷ                  (cost: refinement) — precision 1
     (or Appx-C featurization-precision subsets when T_P < 1)

The pipeline is split at its natural serving seam (DESIGN.md §4):
``plan_join`` runs steps ①–⑥ (corpus-size-free, O(sample)) and returns a
``JoinPlan``; ``execute_join`` runs steps ⑦–⑨ against any corpus shape.
Step ⑦ goes through a pluggable *plane provider* — by default the
extractor's ``materialize`` (cold path), in serving the
``FeaturePlaneStore`` (device-resident planes, zero re-extraction).
``fdj_join`` composes the two.  Step ⑥'s threshold sweep and step ② run
on ``FDJConfig.device``.  The Appx-C path (T_P < 1) draws its subset
samples from a fresh ``seed + 1`` stream, so a replayed plan (serving)
executes byte-identically to a cold run.

With ``stream_refinement=True`` steps ⑧ and ⑨ are pipelined: the engine's
``evaluate_stream`` emits per-chunk candidates that a ``RefinementPump``
(core.refine) refines concurrently, so end-to-end wall approaches
max(step ②, refinement) instead of their sum.  Output pairs and ledger
totals are identical to barrier mode (tests/test_refine_pump.py).

Evaluation (recall/precision vs ground truth) and the Fig-9 cost breakdown
come back in ``JoinResult``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import generation, scaffold as scaffold_lib
from repro_torch.core.adj_target import adj_target
from repro_torch.core.bargain import bargain_precision_subset
from repro_torch.core.costs import CostLedger
from repro_torch.core.refine import RefinementPump
from repro_torch.core.scaffold import Scaffold, min_fpr_thresholds
from repro_torch.obs.trace import current_tracer


@dataclasses.dataclass
class FDJConfig:
    recall_target: float = 0.9
    precision_target: float = 1.0
    delta: float = 0.1
    gen_positives: int = 50        # positives for featurization gen + scaffold
    thresh_positives: int = 200    # positives for threshold selection
    alpha: int = 3                 # cost-to-cover convergence bound (Alg 3)
    beta: int = 20                 # demonstration examples per LLM call
    gamma: float = 0.05            # min cost improvement to extend scaffold
    max_iter: int = 8              # Alg 1 iterations
    mc_trials: int = 20000
    block: int = 4096              # L/R block edge for step-2 evaluation
    engine: str = "cuda"           # numpy | cuda | sharded (repro_torch.engine)
    device: str = "cuda"           # where the threshold sweep and the cuda
    #   and sharded engines run; "cpu" runs the kernels' plain-torch versions
    engine_opts: dict = dataclasses.field(default_factory=dict)
    #   extra get_engine kwargs (tile sizes etc.) — either flat kwargs for
    #   cfg.engine, or keyed per engine name ({"cuda": {...}, ...}) so a
    #   per-query engine override picks its own opts
    stream_refinement: bool = False  # pipeline step ⑨ over step ②'s stream
    pods: int = 1                  # sharded engine: pod-axis width of the
    #   (pod, data, model) join mesh over the torch.distributed world
    #   (distributed.mesh.make_join_mesh) when > 1 and no explicit mesh is
    #   in engine_opts; execution-only, never part of a serving plan key
    #   (same candidate set on any mesh)
    refine_batch_pairs: int = 512  # oracle batch size inside the pump
    pump_queue_chunks: int = 4     # bounded chunk queue (engine backpressure)
    prefetch_depth: Optional[int] = None  # sharded engine: band steps in
    #   flight at once (None = engine default, 2; 1 = serial A/B control);
    #   execution-only, never part of a serving plan key
    order_conjuncts: bool = True   # evaluate conjuncts in the plan's
    #   measured cheapest-and-most-selective-first order (plan_join rates
    #   them on the threshold sample for free; candidate set is invariant
    #   — the conjunction commutes); False = the scaffold's natural order,
    #   the A/B control.  Execution-only, never part of a serving plan key
    recalibrate: bool = True       # serving: keep cached plans' theta
    #   calibrated online — after appends shift plane distributions, the
    #   JoinService refreshes a labeled reservoir, re-runs adj_target +
    #   the device threshold sweep, and hot-swaps theta when the cached
    #   value no longer meets the refreshed target (DESIGN.md §4a);
    #   execution-only, never part of a serving plan key
    reservoir_cap: int = 4096      # max labeled reservoir pairs per plan
    seed: int = 0

    def with_overrides(self, **overrides) -> "FDJConfig":
        """A copy with ``overrides`` applied — the one sanctioned way to
        derive a per-query config from a base config (``QueryOptions``
        resolves through here).  Unknown field names raise immediately
        instead of silently vanishing into ``dataclasses.replace``'s
        error text at some downstream call site."""
        unknown = set(overrides) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise TypeError(
                f"unknown FDJConfig field(s) {sorted(unknown)}; valid "
                f"fields: {sorted(f.name for f in dataclasses.fields(self))}")
        return dataclasses.replace(self, **overrides)


# QueryOptions field -> FDJConfig field it overrides (``stream`` is the
# historical serving spelling of ``stream_refinement``)
_OPT_CFG_FIELDS = {
    "engine": "engine",
    "stream": "stream_refinement",
    "recall_target": "recall_target",
    "precision_target": "precision_target",
    "delta": "delta",
}


@dataclasses.dataclass(frozen=True)
class QueryOptions:
    """One typed request against a serving surface (DESIGN.md §8).

    This is the single options path shared by ``JoinService.query``,
    ``JoinService.append_right`` and ``JoinFleet.submit`` — it replaces
    the historical five special-cased kwargs + open-ended
    ``**cfg_overrides`` sprawl (kept alive as deprecation shims that
    route through here, parity-tested byte-identical).

    The five named fields are the common per-request knobs; anything else
    an ``FDJConfig`` carries goes through ``overrides`` (validated by
    ``FDJConfig.with_overrides``, so typos raise at submit time, not at
    some engine call site).  ``refresh_plan`` / ``incremental`` are
    serving execution directives, not config: they never enter the plan
    key."""
    engine: Optional[str] = None          # numpy | cuda | sharded
    stream: Optional[bool] = None         # pipeline refinement over step ②
    recall_target: Optional[float] = None
    precision_target: Optional[float] = None
    delta: Optional[float] = None
    refresh_plan: bool = False            # drop the cached plan, re-plan
    incremental: bool = True              # allow the delta-join fast path
    overrides: dict = dataclasses.field(default_factory=dict)
    #   any further FDJConfig fields (mc_trials, engine_opts, seed, ...)

    @classmethod
    def from_legacy(cls, *, refresh_plan: bool = False,
                    incremental: bool = True, **kw) -> "QueryOptions":
        """Adapter for the pre-fleet kwarg surface: the five named kwargs
        map onto typed fields, everything else lands in ``overrides``."""
        named = {k: kw.pop(k) for k in list(kw)
                 if k in _OPT_CFG_FIELDS and k != "stream"}
        if "stream" in kw:
            named["stream"] = kw.pop("stream")
        return cls(refresh_plan=refresh_plan, incremental=incremental,
                   overrides=kw, **named)

    def resolve(self, base: FDJConfig) -> FDJConfig:
        """The effective per-request config: ``base`` with this request's
        named fields and ``overrides`` applied (named fields win)."""
        merged = dict(self.overrides)
        for opt_field, cfg_field in _OPT_CFG_FIELDS.items():
            v = getattr(self, opt_field)
            if v is not None:
                merged[cfg_field] = v
        if not merged:
            return base
        return base.with_overrides(**merged)


@dataclasses.dataclass
class JoinPlan:
    """Output of steps ①–⑥: the featurized decomposition plus thresholds.

    A plan is a pure function of (dataset content, cfg, seed) and contains
    nothing corpus-shape-specific beyond what the samples baked in — the
    serving layer caches it across repeated queries and carries it forward
    over delta appends (the delta-join contract, DESIGN.md §4)."""
    specs: list                    # all proposed featurizations
    scaffold: Scaffold             # clauses over `specs` indices
    used_specs: list               # specs the scaffold references
    sc_local: Scaffold             # scaffold remapped onto used_specs
    theta: np.ndarray              # per-clause thresholds (Eq 4)
    t_prime: float                 # adjusted recall target (step ⑤)
    feasible: bool                 # Eq-4 feasibility on S'
    # the labeled threshold sample S' itself, retained so the serving layer
    # can seed a per-plan calibration reservoir (join_service recalibration:
    # after appends shift plane distributions, adj_target + the device sweep
    # re-run on the reservoir and hot-swap ``theta``).  Labels were already
    # charged by step ④ — carrying them is free.
    calib_pairs: Optional[list] = None
    calib_labels: Optional[np.ndarray] = None
    # measured conjunct evaluation order (scaffold.ordered_conjuncts on
    # S′'s clause distances — free, they were computed for threshold
    # selection anyway).  A permutation of range(n_clauses) or None; pure
    # execution hint: candidate set is invariant under it.  Serving keeps
    # it with the cached plan and refreshes it on theta recalibration.
    conjunct_order: Optional[list] = None

    @property
    def degenerate(self) -> bool:
        """No usable decomposition: refine-everything fallback (sound)."""
        return not self.feasible or not self.sc_local.n_clauses


@dataclasses.dataclass
class JoinResult:
    pairs: set                     # final output pairs (i, j)
    recall: float
    precision: float
    cost: CostLedger
    scaffold: Scaffold
    specs: list
    theta: np.ndarray
    t_prime: float
    candidate_count: int
    met_target: bool
    engine_stats: Optional[object] = None   # engine.EngineStats of step ②
    candidates: Optional[list] = None       # sorted step-② survivors (serving
                                            # keeps them for delta-join merges)


def make_label_fn(oracle, cache: dict) -> Callable:
    """Cached oracle labeling: each pair is charged at most once per cache."""
    def label(pairs, kind):
        new = [p for p in pairs if p not in cache]
        if new:
            labs = oracle.label_pairs(new, kind=kind)
            for p, l in zip(new, labs):
                cache[p] = bool(l)
        return np.asarray([cache[p] for p in pairs], bool)
    return label


def _sample_pairs(n_l: int, n_r: int, k: int, rng) -> list:
    idx = rng.choice(n_l * n_r, size=min(k, n_l * n_r), replace=False)
    return [(int(i // n_r), int(i % n_r)) for i in idx]


def plan_join(dataset, oracle, proposer, extractor, cfg: FDJConfig, *,
              ledger: Optional[CostLedger] = None,
              label: Optional[Callable] = None) -> JoinPlan:
    """Steps ①–⑥: sample, generate featurizations, scaffold, thresholds."""
    # planning is recorded as one retroactive span with stage-boundary
    # events (sampled/featurized/scaffolded/thresholds) — plan_join runs
    # once per query, so the collection cost is irrelevant
    tracer = current_tracer()
    t_plan0 = time.perf_counter()
    marks: list = []
    rng = np.random.default_rng(cfg.seed)
    ledger = ledger if ledger is not None else oracle.ledger
    if label is None:
        label = make_label_fn(oracle, {})
    n_l, n_r = dataset.n_l, dataset.n_r
    n_pairs = n_l * n_r
    rate = max(dataset.n_positive, 1) / n_pairs

    # --- 1. generation sample ------------------------------------------------
    k_gen = min(int(math.ceil(cfg.gen_positives / rate * 1.25)), n_pairs)
    s1 = _sample_pairs(n_l, n_r, k_gen, rng)
    y1 = label(s1, "labeling")
    marks.append(("sampled", time.perf_counter(), {"pairs": len(s1)}))

    # --- 2. candidate featurizations ----------------------------------------
    specs = generation.get_candidate_featurizations(
        s1, y1, proposer, extractor, dataset.join_prompt, ledger,
        alpha=cfg.alpha, beta=cfg.beta, max_iter=cfg.max_iter, seed=cfg.seed)
    marks.append(("featurized", time.perf_counter(), {"specs": len(specs)}))

    # --- 3. scaffold ----------------------------------------------------------
    d1 = extractor.pair_distances(specs, s1, ledger)
    max_clauses = max(int(math.floor(1.0 / max(1.0 - cfg.recall_target, 1e-9))), 1)
    sc = scaffold_lib.get_logical_scaffold(d1, y1, cfg.recall_target,
                                           gamma=cfg.gamma, max_clauses=max_clauses)
    if sc.n_clauses == 0:
        # no featurization helps: degenerate to refine-everything (still valid)
        sc = Scaffold(clauses=[])
    marks.append(("scaffolded", time.perf_counter(),
                  {"clauses": sc.n_clauses}))

    # --- 4. threshold sample --------------------------------------------------
    k_thr = min(int(math.ceil(cfg.thresh_positives / rate * 1.25)), n_pairs)
    s2 = _sample_pairs(n_l, n_r, k_thr, rng)
    y2 = label(s2, "labeling")
    k_plus = int(y2.sum())

    # --- 5-6. adjusted target + thresholds ------------------------------------
    used = sc.used_featurizations()
    used_specs = [specs[i] for i in used]
    remap = {f: i for i, f in enumerate(used)}
    sc_local = Scaffold(clauses=[[remap[f] for f in c] for c in sc.clauses])
    delta_recall = cfg.delta if cfg.precision_target >= 1.0 else cfg.delta / 2.0
    if sc_local.n_clauses and k_plus > 0:
        adj = adj_target(k_plus, sc_local.n_clauses, cfg.recall_target,
                         delta_recall, n_pairs=n_pairs, k_sample=len(s2),
                         n_trials=cfg.mc_trials, seed=cfg.seed)
        t_prime = adj.t_prime
        d2 = extractor.pair_distances(used_specs, s2, ledger)
        cd2 = sc_local.clause_distances(d2)
        # Eq-4 selection goes through the device sweep (threshold_sweep
        # kernel grid + coordinate refinement; greedy remains the
        # never-worse A/B baseline)
        thr = min_fpr_thresholds(cd2, y2, t_prime, method="auto",
                                 device=cfg.device)
        theta = thr.theta
        feasible = thr.feasible
        # rate each conjunct's selectivity on the same S′ distances —
        # free measurement, consumed by the engines' short-circuit
        conjunct_order = scaffold_lib.ordered_conjuncts(
            cd2, theta, sc_local.clauses)
    else:
        t_prime = 1.0
        theta = np.zeros(0)
        feasible = False
        conjunct_order = None

    if tracer:
        marks.append(("thresholds", time.perf_counter(),
                      {"feasible": feasible, "t_prime": t_prime}))
        tracer.record_span(
            "plan", t_plan0, time.perf_counter(),
            attrs={"specs": len(specs), "clauses": sc_local.n_clauses,
                   "feasible": feasible}, events=marks)
    return JoinPlan(specs=specs, scaffold=sc, used_specs=used_specs,
                    sc_local=sc_local, theta=theta, t_prime=t_prime,
                    feasible=feasible, calib_pairs=list(s2),
                    calib_labels=np.asarray(y2, bool),
                    conjunct_order=conjunct_order)


def needs_planes(plan: JoinPlan, cfg: FDJConfig) -> bool:
    """Whether ``execute_join`` materializes ``plan``'s planes (step ⑦):
    a degenerate plan needs them only for the Appx-C precision ladder."""
    return bool((not plan.degenerate)
                or (cfg.precision_target < 1.0 and plan.used_specs))


def execute_join(dataset, oracle, extractor, cfg: FDJConfig, plan: JoinPlan,
                 *, plane_provider: Optional[Callable] = None,
                 ledger: Optional[CostLedger] = None,
                 label: Optional[Callable] = None,
                 keep_candidates: bool = False) -> JoinResult:
    """Steps ⑦–⑨: materialize planes, evaluate the CNF, refine.

    ``plane_provider(used_specs, ledger) -> Sequence[FeatureData]`` is the
    step-⑦ seam: default is the extractor's full-corpus ``materialize``
    (cold); the serving layer passes the FeaturePlaneStore's ``provide``
    (device-resident, charges only misses).

    ``keep_candidates=True`` retains the sorted step-② survivor list on
    the result (the serving layer needs it for delta-join merges); one-
    shot callers leave it off so a degenerate plan doesn't pin O(n_l·n_r)
    tuples past the join.
    """
    ledger = ledger if ledger is not None else oracle.ledger
    if label is None:
        label = make_label_fn(oracle, {})
    provider = plane_provider or \
        (lambda specs, led: extractor.materialize(specs, led))
    n_l, n_r = dataset.n_l, dataset.n_r
    # fresh, plan-independent stream for the Appx-C subset sampler so a
    # replayed plan (serving) executes byte-identically to a cold run
    rng = np.random.default_rng(cfg.seed + 1)

    # --- 7. plane materialization ---------------------------------------------
    feats: Sequence = []
    if needs_planes(plan, cfg):
        with current_tracer().span("extract", specs=len(plan.used_specs)):
            feats = provider(plan.used_specs, ledger)

    # --- 8-9. candidate production + refinement --------------------------------
    # degenerate scaffold: decomposition admits everything (always-sound)
    engine_stats = None
    if cfg.stream_refinement:
        if plan.degenerate:
            chunk_iter = _degenerate_chunks(n_l, n_r)
        else:
            chunk_iter = _stream_cnf(feats, plan.sc_local, plan.theta, cfg,
                                     order=plan.conjunct_order)
        if cfg.precision_target >= 1.0:
            def refine_chunk(batch):
                labs = label(batch, "refinement")
                return {p for p, l in zip(batch, labs) if l}
            pump = RefinementPump(refine_chunk,
                                  batch_pairs=cfg.refine_batch_pairs,
                                  max_queue_chunks=cfg.pump_queue_chunks)
        else:
            # Appx C needs quantiles over the whole candidate set: the pump
            # accumulates the stream and runs the ladder once at drain time
            pump = RefinementPump(
                final=lambda cands: _precision_extension(
                    cands, feats, label, cfg, rng),
                max_queue_chunks=cfg.pump_queue_chunks)
        pr = pump.run(chunk_iter, ledger=ledger)
        out_pairs = pr.pairs
        cand_arr = pr.candidates
        n_cands = len(cand_arr)
        engine_stats = pr.engine_stats
    elif plan.degenerate and cfg.precision_target >= 1.0:
        # refine-everything fallback, labeled in bounded row blocks: per-pair
        # oracle refinement needs no global view, so label block by block
        from repro_torch.engine.base import iter_cross_product_chunks
        out_pairs = set()
        n_cands = 0
        cand_arr = [] if keep_candidates else None
        tracer = current_tracer()
        t0 = time.perf_counter()
        for block in iter_cross_product_chunks(n_l, n_r):
            tb0 = time.perf_counter()
            labs = label(block, "refinement")
            out_pairs |= {p for p, l in zip(block, labs) if l}
            n_cands += len(block)
            if cand_arr is not None:
                cand_arr.extend(block)
            if tracer:
                tracer.record_span("refine_batch", tb0, time.perf_counter(),
                                   attrs={"pairs": len(block)})
        ledger.record_walls(0.0, time.perf_counter() - t0, 0.0)
    else:
        if plan.degenerate:
            # Appx-C (T_P < 1) needs whole-candidate-set quantiles: the
            # full list is materialized for the precision ladder only
            cand_arr = [(i, j) for i in range(n_l) for j in range(n_r)]
        else:
            cand_arr, engine_stats = _evaluate_cnf(
                feats, plan.sc_local, plan.theta, cfg,
                order=plan.conjunct_order)
        n_cands = len(cand_arr)
        tracer = current_tracer()
        t0 = time.perf_counter()
        if cfg.precision_target >= 1.0:
            labs = label(cand_arr, "refinement")
            out_pairs = {p for p, l in zip(cand_arr, labs) if l}
        else:
            out_pairs = _precision_extension(cand_arr, feats, label, cfg, rng)
        t1 = time.perf_counter()
        if tracer:
            tracer.record_span("refine_batch", t0, t1,
                               attrs={"pairs": n_cands})
        ledger.record_walls(engine_stats.wall_s if engine_stats else 0.0,
                            t1 - t0, 0.0)
        ledger.record_engine_stats(engine_stats)

    truth = dataset.truth_set
    tp = len(out_pairs & truth)
    recall = tp / max(len(truth), 1)
    precision = tp / max(len(out_pairs), 1) if out_pairs else 1.0
    return JoinResult(
        pairs=out_pairs, recall=recall, precision=precision, cost=ledger,
        scaffold=plan.scaffold, specs=plan.specs, theta=plan.theta,
        t_prime=plan.t_prime,
        candidate_count=n_cands,
        met_target=(recall >= cfg.recall_target - 1e-12
                    and precision >= cfg.precision_target - 1e-12),
        engine_stats=engine_stats,
        candidates=sorted(cand_arr) if keep_candidates and cand_arr is not None
        else None,
    )


def fdj_join(dataset, oracle, proposer, extractor, cfg: FDJConfig,
             plane_provider: Optional[Callable] = None) -> JoinResult:
    """dataset: data.synth.JoinDataset; oracle: core.llm.Oracle;
    proposer/extractor: generation protocol impls (dataset-owned)."""
    ledger = oracle.ledger
    label = make_label_fn(oracle, {})   # shared: refinement reuses sample labels
    with current_tracer().span("fdj_join", engine=cfg.engine,
                               stream=cfg.stream_refinement):
        plan = plan_join(dataset, oracle, proposer, extractor, cfg,
                         ledger=ledger, label=label)
        return execute_join(dataset, oracle, extractor, cfg, plan,
                            plane_provider=plane_provider, ledger=ledger,
                            label=label)


def apply_conjunct_order(clauses: list, theta: np.ndarray,
                         order: Optional[list]):
    """Permute (clauses, theta) jointly by the plan's measured evaluation
    order.  A no-op (the natural order) when ``order`` is None; raises if
    ``order`` is not a permutation of the clause indices — a stale order
    from a structurally different scaffold must never silently misalign
    thresholds with clauses."""
    if order is None:
        return clauses, theta
    if sorted(order) != list(range(len(clauses))):
        raise ValueError(
            f"conjunct order {order} is not a permutation of "
            f"{len(clauses)} clauses")
    return [clauses[i] for i in order], theta[np.asarray(order, int)]


def _ordered_cnf(sc: Scaffold, theta: np.ndarray, cfg: FDJConfig,
                 order: Optional[list]):
    if not cfg.order_conjuncts:
        order = None
    return apply_conjunct_order(sc.clauses, theta, order)


def _evaluate_cnf(feats, sc: Scaffold, theta: np.ndarray, cfg: FDJConfig,
                  order: Optional[list] = None):
    """Step 2: CNF evaluation over the full cross product via the engine.

    Returns (candidates, EngineStats).  ``order`` is the plan's measured
    conjunct order — an execution hint only (the candidate set is
    invariant; both backends get the same permuted clause list, so
    cross-backend parity is preserved)."""
    clauses, th = _ordered_cnf(sc, theta, cfg, order)
    res = _get_engine(cfg).evaluate(feats, clauses, th)
    return res.candidates, res.stats


def _stream_cnf(feats, sc: Scaffold, theta: np.ndarray, cfg: FDJConfig,
                order: Optional[list] = None):
    """Streaming step ②: hands back the engine's chunk iterator for the
    RefinementPump."""
    clauses, th = _ordered_cnf(sc, theta, cfg, order)
    return _get_engine(cfg).evaluate_stream(feats, clauses, th)


def _get_engine(cfg: FDJConfig):
    from repro_torch.engine import ENGINES, get_engine

    opts = dict(cfg.engine_opts)
    if opts and set(opts) <= set(ENGINES):   # per-engine keyed mapping
        opts = dict(opts.get(cfg.engine, {}))
    if cfg.engine == "numpy":
        opts.setdefault("block", cfg.block)
    if cfg.engine in ("cuda", "sharded"):
        opts.setdefault("device", cfg.device)
    if cfg.engine == "sharded":
        if cfg.prefetch_depth is not None:
            opts.setdefault("prefetch_depth", cfg.prefetch_depth)
        if cfg.pods > 1 and "mesh" not in opts:
            from repro_torch.distributed import mesh as mesh_mod
            opts["mesh"] = mesh_mod.make_join_mesh(n_pods=cfg.pods)
    return get_engine(cfg.engine, **opts)


def _degenerate_chunks(n_l: int, n_r: int):
    """Refine-everything fallback as a bounded-chunk stream (stats-free,
    mirroring the barrier fallback's engine_stats=None).  Chunked by the
    same policy as the engines' vacuous-conjunction path so the
    RefinementPump's bounded queue — not one host list — is what limits
    resident pairs."""
    from repro_torch.engine.base import CandidateChunk, iter_cross_product_chunks
    for idx, pairs in enumerate(iter_cross_product_chunks(n_l, n_r)):
        yield CandidateChunk(pairs, None, idx)


def _precision_extension(cand_pairs, feats, label, cfg: FDJConfig,
                         rng) -> set:
    """Appx C: per-featurization precision subsets skip refinement.

    Distances come from the materialized planes (``feats``); on a
    *degenerate* plan the used specs are materialized up front (free on
    the serving warm path, where the planes are store-resident).  Runs on
    the host: the subset samples consume ``rng`` feature by feature, in
    the reference's order, so both packages draw the same pairs."""
    if not cand_pairs:
        return set()
    remaining = np.arange(len(cand_pairs))
    accepted: set = set()
    r = max(len(feats), 1)
    delta1 = cfg.delta / (2.0 * r)
    for fd in feats:
        if remaining.size == 0:
            break
        pairs_sub = [cand_pairs[i] for i in remaining]
        d = fd.pair_distances(pairs_sub)

        def label_fn(idx):
            return label([pairs_sub[i] for i in idx], "refinement")

        mask = bargain_precision_subset(d, label_fn, cfg.precision_target,
                                        delta1, rng=rng)
        accepted |= {pairs_sub[i] for i in np.flatnonzero(mask)}
        remaining = remaining[~mask]
    # leftover pairs: oracle refinement (precision 1 on them)
    left = [cand_pairs[i] for i in remaining]
    labs = label(left, "refinement")
    accepted |= {p for p, l in zip(left, labs) if l}
    return accepted
