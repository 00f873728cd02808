"""repro_torch's Appx-C precision path against the JAX reference.

``fdj_join`` at ``precision_target < 1`` (per-featurization precision
subsets accepted without refinement, the rest refined) must give the
reference's pairs, candidates and ledger dollars on the port's ``numpy``
and ``cuda`` engines (``device="cpu"``), barrier and stream: the subset
sampler draws from the same seeded stream, feature by feature, in the
same order.  Also ports of tests/test_refine_pump.py's
``test_join_stream_parity_precision_subset`` and tests/test_core.py's
``test_bargain_precision_subset_sound``, and ``core/bargain.py`` against
its reference on seeded inputs.
"""

import numpy as np
import pytest

from repro.core import bargain as j_bargain
from repro.core import scaffold as j_scaffold_lib
from repro.core.join import FDJConfig as JCfg, fdj_join as j_fdj_join
from repro.data import synth as j_synth
from repro.data.simulated_llm import (SimulatedExtractor as JExtractor,
                                      SimulatedProposer as JProposer)
from repro.launch._args import make_dataset as j_dataset
from repro_torch.core import bargain
from repro_torch.core import scaffold as scaffold_lib
from repro_torch.core.join import FDJConfig, fdj_join
from repro_torch.core.scaffold import Scaffold
from repro_torch.data import synth
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.launch._args import make_dataset

VARIANTS = [("numpy", False), ("numpy", True), ("cuda", False),
            ("cuda", True)]
_IDS = ["numpy", "numpy-stream", "cuda", "cuda-stream"]
_OPTS = {"numpy": dict(block=32), "cuda": dict(tl=32, tr=64)}


def _police(mod):
    return mod.police_records(n_incidents=30, reports_per_incident=2, seed=3)


def _products(which):
    return (make_dataset if which == "port" else j_dataset)("products",
                                                           size=0.3)


_DATASETS = {"police": lambda which: _police(synth if which == "port"
                                             else j_synth),
             "products": _products}


def _port_join(ds, engine, stream, precision_target, seed=3):
    cfg = FDJConfig(engine=engine, device="cpu", stream_refinement=stream,
                    seed=seed, precision_target=precision_target,
                    refine_batch_pairs=32, pump_queue_chunks=2,
                    engine_opts=_OPTS[engine])
    return fdj_join(ds, ds.make_oracle(), SimulatedProposer(ds),
                    SimulatedExtractor(ds, seed=seed), cfg)


def _ref_join(ds, precision_target, seed=3):
    cfg = JCfg(engine="numpy", seed=seed, precision_target=precision_target,
               block=32)
    return j_fdj_join(ds, ds.make_oracle(), JProposer(ds),
                      JExtractor(ds, seed=seed), cfg)


def _assert_same(got, want):
    assert got.pairs == want.pairs
    assert got.candidate_count == want.candidate_count
    np.testing.assert_array_equal(got.theta, want.theta)
    assert got.t_prime == want.t_prime
    assert (got.recall, got.precision, got.met_target) == \
        (want.recall, want.precision, want.met_target)
    assert got.cost.breakdown() == want.cost.breakdown()


_REF: dict = {}


@pytest.mark.parametrize("engine,stream", VARIANTS, ids=_IDS)
@pytest.mark.parametrize("name,t_p", [("police", 0.8), ("police", 0.5),
                                      ("products", 0.9)])
def test_fdj_join_precision_matches_reference(name, t_p, engine, stream):
    key = (name, t_p)
    if key not in _REF:
        _REF[key] = _ref_join(_DATASETS[name]("ref"), t_p)
    want = _REF[key]
    got = _port_join(_DATASETS[name]("port"), engine, stream, t_p)
    _assert_same(got, want)
    assert got.pairs and got.candidate_count > 0


def test_join_stream_parity_precision_subset():
    """The pump defers to the ladder on the sorted union, so the accepted
    set and oracle spend match barrier mode exactly."""
    a = _port_join(_police(synth), "numpy", False, 0.8)
    b = _port_join(_police(synth), "numpy", True, 0.8)
    assert a.pairs == b.pairs
    assert a.recall == b.recall and a.precision == b.precision
    assert a.candidate_count == b.candidate_count
    assert a.met_target == b.met_target
    for k, v in a.cost.breakdown().items():
        assert b.cost.breakdown()[k] == pytest.approx(v, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("stream", [False, True], ids=["barrier", "stream"])
def test_precision_on_degenerate_plan_matches_reference(monkeypatch, stream):
    """No usable scaffold: every pair is a candidate and the ladder runs
    over the planes of the used specs (none here), then refines all."""
    monkeypatch.setattr(j_scaffold_lib, "get_logical_scaffold",
                        lambda *a, **k: j_scaffold_lib.Scaffold(clauses=[]))
    monkeypatch.setattr(scaffold_lib, "get_logical_scaffold",
                        lambda *a, **k: Scaffold(clauses=[]))
    want = _ref_join(_police(j_synth), 0.8)
    got = _port_join(_police(synth), "cuda", stream, 0.8)
    _assert_same(got, want)
    assert got.candidate_count == 60 * 60


# --- core/bargain.py ----------------------------------------------------------

def _ladder_inputs(seed, n=2000):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1, n)
    truth = d + rng.normal(0, 0.1, n) < 0.4
    return d, truth


@pytest.mark.parametrize("t_p", [0.5, 0.6, 0.9])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_bargain_precision_subset_matches_reference(seed, t_p):
    d, truth = _ladder_inputs(seed)
    calls = {"port": [], "ref": []}

    def labeler(who):
        def label_fn(idx):
            calls[who].append(np.asarray(idx).tolist())
            return truth[idx]
        return label_fn

    got = bargain.bargain_precision_subset(
        d, labeler("port"), t_p, 0.05, rng=np.random.default_rng(seed + 1))
    want = j_bargain.bargain_precision_subset(
        d, labeler("ref"), t_p, 0.05, rng=np.random.default_rng(seed + 1))
    np.testing.assert_array_equal(got, want)
    assert calls["port"] == calls["ref"]          # the same draws, in order
    if t_p == 0.5:
        assert got.any()                          # the ladder accepted some


def test_bargain_precision_subset_sound():
    rng = np.random.default_rng(5)
    d, truth = _ladder_inputs(5)
    calls = {"n": 0}

    def label_fn(idx):
        calls["n"] += len(idx)
        return truth[idx]

    mask = bargain.bargain_precision_subset(d, label_fn, 0.9, 0.1, rng=rng)
    if mask.any():
        assert truth[mask].mean() >= 0.75
        assert calls["n"] < len(d)


@pytest.mark.parametrize("seed", [1, 2])
def test_cascade_thresholds_match_reference(seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1, 500)
    labels = d + rng.normal(0, 0.15, 500) < 0.3
    for t in (0.8, 0.9):
        assert bargain.supg_threshold(d, labels, t) == \
            j_bargain.supg_threshold(d, labels, t)
        assert bargain.optimal_cascade_threshold(d, labels, t) == \
            j_bargain.optimal_cascade_threshold(d, labels, t)
        got = bargain.recall_guarded_threshold(d, labels, t, 0.1,
                                               n_pairs=10_000, n_trials=2000)
        want = j_bargain.recall_guarded_threshold(d, labels, t, 0.1,
                                                  n_pairs=10_000,
                                                  n_trials=2000)
        assert (got.tau, got.t_prime, got.observed_recall) == \
            (want.tau, want.t_prime, want.observed_recall)
