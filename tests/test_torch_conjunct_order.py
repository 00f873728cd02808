"""Selectivity-ordered CNF + conjunct short-circuit on the port's engines.

Ports the 14 tests of tests/test_conjunct_order.py.  The ordering
invariant: a conjunction commutes, so the candidate set is bit-identical
under any evaluation order and with early rejection on or off, on every
engine of the port (``numpy``, ``cuda``, ``sharded``, here with
``device="cpu"``: the kernels' plain versions; the card's cases are in
tests/test_torch_conjunct_order_cuda.py) — only ``conjunct_evals`` moves.
On a skewed-selectivity fixture the ordered short-circuit evaluation must
do strictly less (pair, clause) work than unordered full width, and a band
whose first conjunct rejects everything must emit no candidates and
charge only first-conjunct work.  The plan's measured conjunct order is
a drawn number, so it must equal the reference's on the same fixture.
"""

import itertools

import numpy as np
import pytest

from repro_torch.core.costs import CostLedger
from repro_torch.core.featurize import FeaturizationSpec, vectorize
from repro_torch.core.join import (FDJConfig, _get_engine,
                                   apply_conjunct_order, fdj_join, plan_join)
from repro_torch.core.scaffold import ordered_conjuncts
from repro_torch.data import synth
from repro_torch.data.cnf_fixtures import representative_cnf
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.engine import ENGINES, get_engine

_OPTS = {
    "numpy": dict(block=32),
    "cuda": dict(tl=32, tr=64, l_block=32, device="cpu"),
    "sharded": dict(tl=32, tr=32, r_chunk=64, device="cpu"),
}


# --- ordering policy --------------------------------------------------------

def test_ordered_conjuncts_selective_first():
    """The rejecting clause goes first even when listed last."""
    # clause 0 passes every sample row at theta=0.5; clause 1 passes none
    cd = np.array([[0.1, 0.9], [0.2, 0.8], [0.1, 0.7], [0.3, 0.9]])
    theta = np.array([0.5, 0.5])
    assert ordered_conjuncts(cd, theta, [[0], [1]]) == [1, 0]


def test_ordered_conjuncts_cost_breaks_selectivity_ties():
    """Equal pass rates: the narrower (cheaper) clause goes first."""
    cd = np.array([[0.9, 0.9], [0.1, 0.1]])
    theta = np.array([0.5, 0.5])
    assert ordered_conjuncts(cd, theta, [[0, 1, 2], [0]]) == [1, 0]


def test_ordered_conjuncts_pass_everything_sorts_last():
    cd = np.array([[0.1, 0.4, 0.9], [0.2, 0.3, 0.8]])
    theta = np.array([0.5, 0.5, 0.5])                # clauses 0,1 pass all
    order = ordered_conjuncts(cd, theta, [[0], [1], [2]])
    assert order[0] == 2                             # the only rejector
    assert order[1:] == [0, 1]                       # stable among inf ranks


def test_ordered_conjuncts_empty_sample_is_identity():
    assert ordered_conjuncts(np.zeros((0, 2)), np.array([0.5, 0.5]),
                             [[0], [1]]) == [0, 1]


def test_ordered_conjuncts_rejects_width_mismatch():
    with pytest.raises(ValueError, match="disagrees"):
        ordered_conjuncts(np.zeros((3, 2)), np.array([0.5, 0.5]), [[0]])


def test_apply_conjunct_order_permutes_jointly_and_validates():
    clauses = [[0], [1, 2]]
    theta = np.array([0.3, 0.7])
    oc, ot = apply_conjunct_order(clauses, theta, [1, 0])
    assert oc == [[1, 2], [0]] and ot.tolist() == [0.7, 0.3]
    same_c, same_t = apply_conjunct_order(clauses, theta, None)
    assert same_c is clauses and same_t is theta     # None = no-op
    with pytest.raises(ValueError, match="permutation"):
        apply_conjunct_order(clauses, theta, [0, 0])
    with pytest.raises(ValueError, match="permutation"):
        apply_conjunct_order(clauses, theta, [0])


# --- the ordering invariant, per engine -------------------------------------

def _materialized_cnf(ds):
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    return feats, clauses, thetas


@pytest.mark.parametrize("engine", ENGINES)
def test_candidate_set_invariant_under_order_and_early_reject(engine):
    """Every permutation of the conjuncts, early rejection on and off, vs
    natural order full width: bit-identical candidates on a ragged corpus,
    and the empty scaffold's cross product."""
    ds = synth.police_records(n_incidents=37, reports_per_incident=2, seed=5)
    feats, clauses, thetas = _materialized_cnf(ds)
    theta = np.asarray(thetas, float)
    base = get_engine(engine, early_reject=False, **_OPTS[engine]).evaluate(
        feats, clauses, thetas)
    assert base.stats.n_candidates > 0
    for order in itertools.permutations(range(len(clauses))):
        oc, ot = apply_conjunct_order(clauses, theta, list(order))
        for er in (True, False):
            got = get_engine(engine, early_reject=er,
                             **_OPTS[engine]).evaluate(feats, oc, list(ot))
            assert got.candidates == base.candidates, (order, er)
    # empty scaffold: order is vacuous, both paths emit the cross product
    empty = get_engine(engine, **_OPTS[engine]).evaluate(feats, [], [])
    assert len(empty.candidates) == ds.n_l * ds.n_r


# --- skewed selectivity: ordered short-circuit does less work ---------------

def _skewed_fixture():
    """33 x 128, 2-clause CNF: the clause listed FIRST passes every pair;
    the clause listed second matches only R band [64, 96).  Natural order
    wastes full-width work on 3 dead bands; selectivity order puts the
    banded clause first so those bands short-circuit after one conjunct."""
    n_l, n_r = 33, 128
    texts_l = ["same text"] * n_l
    texts_r = ["zzz yyy"] * 64 + ["same text"] * 32 + ["zzz yyy"] * 32
    tag = FeaturizationSpec("tag", "", "word_overlap", "llm", "tag")
    name = FeaturizationSpec("name", "", "word_overlap", "llm", "name")
    feats = [vectorize(tag, ["x"] * n_l, ["x"] * n_r),
             vectorize(name, texts_l, texts_r)]
    clauses = [[0], [1]]                             # unselective first
    thetas = [0.5, 0.25]
    want = [(i, j) for i in range(n_l) for j in range(64, 96)]
    return feats, clauses, thetas, want


def test_skew_fixture_ordering_flips_the_clauses():
    """ordered_conjuncts on sampled clause distances picks the banded
    clause first — the measurement the plan gets for free from S'."""
    feats, clauses, thetas, _ = _skewed_fixture()
    # sample rows: clause 0 distance always 0 (passes), clause 1 mostly 1
    cd = np.array([[0.0, 1.0]] * 6 + [[0.0, 0.0]] * 2)
    assert ordered_conjuncts(cd, np.asarray(thetas, float), clauses) == [1, 0]


@pytest.mark.parametrize("engine", ENGINES)
def test_short_circuit_saves_evals_at_identical_candidates(engine):
    """Acceptance property: on the skewed regime, ordered + early-reject
    charges strictly fewer conjunct_evals than unordered full width while
    the candidate set stays bit-identical."""
    feats, clauses, thetas, want = _skewed_fixture()
    opts = dict(_OPTS[engine])
    if engine == "sharded":
        opts["capacity"] = 2048                      # no retry re-work noise
    full = get_engine(engine, early_reject=False, **opts).evaluate(
        feats, clauses, thetas)
    oc, ot = apply_conjunct_order(clauses, np.asarray(thetas, float), [1, 0])
    ordered = get_engine(engine, **opts).evaluate(feats, oc, list(ot))
    assert full.candidates == ordered.candidates == sorted(want)
    assert 0 < ordered.stats.conjunct_evals < full.stats.conjunct_evals, (
        f"{engine}: ordered={ordered.stats.conjunct_evals} "
        f"full={full.stats.conjunct_evals}")
    assert ordered.stats.flops_per_candidate < full.stats.flops_per_candidate


def test_dead_band_skips_tail_conjuncts_and_emits_nothing():
    """Zero-popcount whole-band skip, per chunk: a band whose first
    conjunct rejects everything emits no candidates and is charged at
    exactly the 1-conjunct rate; the hot band pays full width."""
    feats, clauses, thetas, want = _skewed_fixture()
    oc, ot = apply_conjunct_order(clauses, np.asarray(thetas, float), [1, 0])
    eng = get_engine("sharded", tl=32, tr=32, r_chunk=32, capacity=2048,
                     device="cpu")
    chunks = list(eng.evaluate_stream(feats, oc, list(ot)))
    assert len(chunks) == 4                          # one per R band
    assert [bool(ch.candidates) for ch in chunks] == [False, False, True,
                                                      False]
    assert sorted(chunks[2].candidates) == want
    # 33 L rows pad to 64 (tl=32); each band covers 64 x 32 padded pairs
    band_pairs = 64 * 32
    for ch in (chunks[0], chunks[1], chunks[3]):     # dead bands: 1 conjunct
        assert ch.stats.conjunct_evals == band_pairs
    assert chunks[2].stats.conjunct_evals == 2 * band_pairs


def test_numpy_engine_block_skip_charges_first_clause_only():
    """The oracle backend's per-block accounting: an all-dead block stops
    after clause 1 when early_reject is on, and never when it is off."""
    feats, clauses, thetas, want = _skewed_fixture()
    oc, ot = apply_conjunct_order(clauses, np.asarray(thetas, float), [1, 0])
    on = get_engine("numpy", block=32).evaluate(feats, oc, list(ot))
    off = get_engine("numpy", block=32, early_reject=False).evaluate(
        feats, oc, list(ot))
    assert on.candidates == off.candidates == sorted(want)
    # 33x128 in 32-blocks: 2x4 (L, R) blocks; only R block [64, 96) is
    # hot.  off: every block pays both clauses; on: the 6 dead blocks
    # (R bands 0, 1, 3) stop after the banded clause.
    n_pairs = 33 * 128
    dead_pairs = 33 * 96
    assert off.stats.conjunct_evals == 2 * n_pairs
    assert on.stats.conjunct_evals == 2 * (n_pairs - dead_pairs) + dead_pairs


# --- plan/config plumbing ---------------------------------------------------

def _stack(seed=3):
    ds = synth.police_records(n_incidents=30, reports_per_incident=2,
                              seed=seed)
    return ds, ds.make_oracle(), SimulatedProposer(ds), \
        SimulatedExtractor(ds, seed=seed)


def _j_stack(seed=3):
    from repro.data import synth as j_synth
    from repro.data.simulated_llm import (SimulatedExtractor as JExtractor,
                                          SimulatedProposer as JProposer)
    ds = j_synth.police_records(n_incidents=30, reports_per_incident=2,
                                seed=seed)
    return ds, ds.make_oracle(), JProposer(ds), JExtractor(ds, seed=seed)


def test_plan_join_measures_conjunct_order():
    """The plan's conjunct order is a permutation of its clauses, and the
    same order the reference measures on the same fixture."""
    from repro.core.join import FDJConfig as JCfg, plan_join as j_plan_join
    ds, oracle, proposer, extractor = _stack()
    cfg = FDJConfig(engine="numpy", seed=3, block=32, device="cpu")
    plan = plan_join(ds, oracle, proposer, extractor, cfg)
    assert not plan.degenerate
    c = plan.sc_local.n_clauses
    assert sorted(plan.conjunct_order) == list(range(c))
    want = j_plan_join(*_j_stack(), JCfg(engine="numpy", seed=3, block=32))
    assert plan.conjunct_order == want.conjunct_order
    assert plan.sc_local.clauses == want.sc_local.clauses


@pytest.mark.parametrize("engine", ENGINES)
def test_join_order_toggle_is_output_invariant(engine):
    """order_conjuncts=False (debug escape hatch) changes nothing but the
    evaluation order: pairs, recall, candidate count all identical."""
    kw = dict(engine=engine, seed=3, block=32, device="cpu",
              engine_opts={k: v for k, v in _OPTS[engine].items()
                           if k != "device"})
    a = fdj_join(*_stack(), FDJConfig(**kw))
    b = fdj_join(*_stack(), FDJConfig(order_conjuncts=False, **kw))
    assert a.pairs == b.pairs
    assert a.recall == b.recall
    assert a.candidate_count == b.candidate_count


def test_fdjconfig_prefetch_depth_reaches_engine():
    eng = _get_engine(FDJConfig(engine="sharded", prefetch_depth=4,
                                device="cpu"))
    assert eng.effective_prefetch_depth == 4
    default = _get_engine(FDJConfig(engine="sharded", device="cpu"))
    assert default.effective_prefetch_depth == 2
