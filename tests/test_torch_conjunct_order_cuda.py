"""Conjunct-order invariance and the early-reject short circuit of the
``cuda`` and ``sharded`` engines on the card.

The card's half of tests/test_torch_conjunct_order.py: the candidate set
is bit-identical under every conjunct order, with early rejection on and
off, and across the two engines; on the skewed-selectivity fixture the
ordered short circuit charges strictly fewer conjunct evals at identical
candidates, and the ring charges a dead band exactly one conjunct.
These tests need a CUDA device (the engines launch the CUDA kernels) and
skip without one; the file imports neither jax nor the JAX package:

    python -m pytest -q tests/test_torch_conjunct_order_cuda.py
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.costs import CostLedger
from repro_torch.core.featurize import FeaturizationSpec, vectorize
from repro_torch.core.join import apply_conjunct_order
from repro_torch.data import synth
from repro_torch.data.cnf_fixtures import representative_cnf
from repro_torch.data.simulated_llm import SimulatedExtractor
from repro_torch.engine import get_engine

_CARD = ("cuda", "sharded")
_OPTS = {"cuda": dict(tl=32, tr=64, l_block=32),
         "sharded": dict(tl=32, tr=32, r_chunk=64)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engines launch CUDA kernels")
    return "cuda"


def _engine(name, device, **kw):
    return get_engine(name, device=device, **{**_OPTS[name], **kw})


@pytest.mark.parametrize("n_incidents", [37, 300])
def test_candidate_set_invariant_under_order_and_early_reject(cuda_device,
                                                              n_incidents):
    ds = synth.police_records(n_incidents=n_incidents,
                              reports_per_incident=2, seed=5)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    theta = np.asarray(thetas, float)
    base = _engine("cuda", cuda_device, early_reject=False).evaluate(
        feats, clauses, thetas)
    assert base.stats.n_candidates > 0
    for engine in _CARD:
        for order in itertools.permutations(range(len(clauses))):
            oc, ot = apply_conjunct_order(clauses, theta, list(order))
            for er in (True, False):
                got = _engine(engine, cuda_device, early_reject=er).evaluate(
                    feats, oc, list(ot))
                assert got.candidates == base.candidates, (engine, order, er)
        empty = _engine(engine, cuda_device).evaluate(feats, [], [])
        assert len(empty.candidates) == ds.n_l * ds.n_r


def _skewed_fixture():
    """tests/test_torch_conjunct_order.py's 33 x 128 fixture: the clause
    listed first passes every pair, the second matches R band [64, 96)."""
    n_l, n_r = 33, 128
    texts_r = ["zzz yyy"] * 64 + ["same text"] * 32 + ["zzz yyy"] * 32
    tag = FeaturizationSpec("tag", "", "word_overlap", "llm", "tag")
    name = FeaturizationSpec("name", "", "word_overlap", "llm", "name")
    feats = [vectorize(tag, ["x"] * n_l, ["x"] * n_r),
             vectorize(name, ["same text"] * n_l, texts_r)]
    want = [(i, j) for i in range(n_l) for j in range(64, 96)]
    return feats, [[0], [1]], [0.5, 0.25], want


@pytest.mark.parametrize("engine", _CARD)
def test_short_circuit_saves_evals_at_identical_candidates(cuda_device,
                                                           engine):
    feats, clauses, thetas, want = _skewed_fixture()
    kw = {"capacity": 2048} if engine == "sharded" else {}
    full = _engine(engine, cuda_device, early_reject=False, **kw).evaluate(
        feats, clauses, thetas)
    oc, ot = apply_conjunct_order(clauses, np.asarray(thetas, float), [1, 0])
    ordered = _engine(engine, cuda_device, **kw).evaluate(feats, oc, list(ot))
    assert full.candidates == ordered.candidates == sorted(want)
    assert 0 < ordered.stats.conjunct_evals < full.stats.conjunct_evals
    assert ordered.stats.flops_per_candidate < full.stats.flops_per_candidate


def test_dead_band_skips_tail_conjuncts_and_emits_nothing(cuda_device):
    feats, clauses, thetas, want = _skewed_fixture()
    oc, ot = apply_conjunct_order(clauses, np.asarray(thetas, float), [1, 0])
    eng = get_engine("sharded", tl=32, tr=32, r_chunk=32, capacity=2048,
                     device=cuda_device)
    chunks = list(eng.evaluate_stream(feats, oc, list(ot)))
    assert [bool(ch.candidates) for ch in chunks] == [False, False, True,
                                                      False]
    assert sorted(chunks[2].candidates) == want
    band_pairs = 64 * 32
    for ch in (chunks[0], chunks[1], chunks[3]):
        assert ch.stats.conjunct_evals == band_pairs
    assert chunks[2].stats.conjunct_evals == 2 * band_pairs
